"""BigVGAN-v2's generator, inference form (Lee et al., "BigVGAN: A Universal
Neural Vocoder with Large-Scale Training", arXiv:2206.04658; code
github.com/NVIDIA/BigVGAN ``bigvgan.py`` and ``alias_free_activation/torch/``).

conv_pre -> per stage [transposed-conv upsample (no activation before it,
unlike HiFi-GAN) -> the mean of the stage's AMP blocks] ->
``activation_post`` -> conv_post (no bias) -> a clamp to [-1, 1]: the
published v2 form (``SUPPORTED``; other values raise). AMP block
1 of kernel k: per dilation d, x = x + c2(A(c1_d(A(x)))), each A its own
anti-aliased SnakeBeta (``Activation1d``: 2x upsample by a 12-tap
Kaiser-windowed sinc, SnakeBeta, low-pass and 2x downsample), 6 a block.
Every activation runs as one call of ``ops/aa_snake.py::aa_snake``: K4 on a
CUDA tensor, the plain sequence on the CPU or with ``fused=False``.

Parameter and buffer names are the published ones with weight norm folded
(``conv_pre.weight``, ``ups.{i}.0.weight``, ``resblocks.{n}.convs1.{j}``,
``resblocks.{n}.activations.{m}.act.alpha`` / ``.beta``,
``....upsample.filter``, ``....downsample.lowpass.filter``,
``activation_post.act.alpha``, ``conv_post.weight``);
``cli.load_vocoder`` folds a published file. The filters are computed on
the CPU in f32 and copied to the module's device, so the module can be
built on ``meta``. ``prepare()`` computes every activation's e^alpha and
1 / (e^beta + 1e-9) once and lays every conv weight out channels-last
(the pipeline calls it when it takes the generator); moving the module or
loading a state dict drops the terms, and an unprepared activation
computes them per call.

Every activation between ``conv_pre`` and ``conv_post`` is channels-last:
a (B, C, L) view of (B, L, C) storage, strides (L C, 1, C). The convs run
as 2-d convs over (B, C, 1, L) views (``Conv1d``, ``ConvTranspose1d``), so
cuDNN computes in NHWC on the tensors as they lie and transposes nothing;
K4 (``aa_snake``) reads and writes the same layout, and the residual adds
and the stage means see operands of one layout.
``Generator.forward`` maps a mel (B, T, num_mels) to a waveform (B, T *
hop, 1), ``generate`` (B, num_mels, T) to (B, 1, T * hop), as HiFi-GAN's;
(B, T, num_mels) contiguous is already channels-last for ``conv_pre``.
"""

from dataclasses import dataclass
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from matcha_tpu_torch.ops.aa_snake import (aa_snake, channels_last, is_channels_last,
                                           kaiser_sinc_filter, snake_terms)


#: the config values the port runs: BigVGAN-v2's published form
SUPPORTED = {"resblock": "1", "activation": "snakebeta", "snake_logscale": True,
             "use_tanh_at_final": False, "use_bias_at_final": False}


@dataclass
class BigVGANConfig:
    """The generator's keys of a published BigVGAN config, and its mel's
    (defaults: ``bigvgan_v2_22khz_80band_fmax8k_256x``)."""

    resblock: str = "1"
    upsample_rates: Tuple[int, ...] = (4, 4, 2, 2, 2, 2)
    upsample_kernel_sizes: Tuple[int, ...] = (8, 8, 4, 4, 4, 4)
    upsample_initial_channel: int = 1536
    resblock_kernel_sizes: Tuple[int, ...] = (3, 7, 11)
    resblock_dilation_sizes: Tuple[Tuple[int, ...], ...] = ((1, 3, 5), (1, 3, 5), (1, 3, 5))
    activation: str = "snakebeta"
    snake_logscale: bool = True
    use_tanh_at_final: bool = False
    use_bias_at_final: bool = False
    num_mels: int = 80
    sampling_rate: int = 22050
    hop_size: int = 256
    n_fft: int = 1024
    win_size: int = 1024
    fmin: float = 0.0
    fmax: float = 8000.0


def get_padding(kernel_size: int, dilation: int = 1) -> int:
    return (kernel_size * dilation - dilation) // 2


def _filter() -> torch.Tensor:
    """The Kaiser-sinc filter on the default device."""
    h = kaiser_sinc_filter()
    return torch.empty(h.shape).copy_(h)


class Conv1d(nn.Conv1d):
    """``nn.Conv1d`` computed as a 2-d conv over (B, C, 1, L) views.
    PyTorch's conv1d copies its input to channels-first before the library
    sees it; the 2-d views hand a channels-last input and weight over as
    they lie, and cuDNN writes a channels-last output."""

    def _conv_forward(self, x, weight, bias):
        return F.conv2d(x.unsqueeze(2), weight.unsqueeze(2), bias, (1, self.stride[0]),
                        (0, self.padding[0]), (1, self.dilation[0]), self.groups).squeeze(2)


class ConvTranspose1d(nn.ConvTranspose1d):
    """``nn.ConvTranspose1d`` computed as a 2-d transposed conv, as
    ``Conv1d``."""

    def forward(self, x):
        return F.conv_transpose2d(x.unsqueeze(2), self.weight.unsqueeze(2), self.bias,
                                  (1, self.stride[0]), (0, self.padding[0]),
                                  (0, self.output_padding[0]), self.groups,
                                  (1, self.dilation[0])).squeeze(2)


class SnakeBeta(nn.Module):
    """The log-scale parameters only: ``Activation1d`` computes the
    activation."""

    def __init__(self, channels: int):
        super().__init__()
        self.alpha = nn.Parameter(torch.zeros(channels))
        self.beta = nn.Parameter(torch.zeros(channels))


class UpSample1d(nn.Module):
    def __init__(self):
        super().__init__()
        self.register_buffer("filter", _filter())


class LowPassFilter1d(nn.Module):
    def __init__(self):
        super().__init__()
        self.register_buffer("filter", _filter())


class DownSample1d(nn.Module):
    def __init__(self):
        super().__init__()
        self.lowpass = LowPassFilter1d()


class Activation1d(nn.Module):
    """Down(SnakeBeta(Up(x))) on (B, C, L), through ``aa_snake``."""

    def __init__(self, channels: int):
        super().__init__()
        self.act = SnakeBeta(channels)
        self.upsample = UpSample1d()
        self.downsample = DownSample1d()
        self.terms = None

    def prepare(self) -> None:
        self.terms = snake_terms(self.act.alpha, self.act.beta)

    def forward(self, x: torch.Tensor, fused: bool = True) -> torch.Tensor:
        freq, inv_mag = self.terms or snake_terms(self.act.alpha, self.act.beta)
        return aa_snake(x, freq, inv_mag, self.upsample.filter, self.downsample.lowpass.filter,
                        fused=fused)


class AMPBlock1(nn.Module):
    """(B, C, L): per dilation d, x + c2(A(c1_d(A(x)))); activations 2j and
    2j + 1 serve dilation j, as the published ``activations[::2]`` and
    ``[1::2]``."""

    def __init__(self, channels: int, kernel_size: int, dilation):
        super().__init__()
        self.convs1 = nn.ModuleList(
            Conv1d(channels, channels, kernel_size, dilation=d,
                   padding=get_padding(kernel_size, d)) for d in dilation)
        self.convs2 = nn.ModuleList(
            Conv1d(channels, channels, kernel_size, padding=get_padding(kernel_size, 1))
            for _ in dilation)
        self.activations = nn.ModuleList(
            Activation1d(channels) for _ in range(2 * len(dilation)))

    def forward(self, x: torch.Tensor, fused: bool = True) -> torch.Tensor:
        acts = self.activations
        for c1, c2, a1, a2 in zip(self.convs1, self.convs2, acts[::2], acts[1::2]):
            x = c2(a2(c1(a1(x, fused)), fused)) + x
        return x


class Generator(nn.Module):
    """Mel (B, T, num_mels) -> waveform (B, T * prod(upsample_rates), 1)."""

    def __init__(self, h: Optional[BigVGANConfig] = None):
        super().__init__()
        h = h or BigVGANConfig()
        other = {k: getattr(h, k) for k, v in SUPPORTED.items() if getattr(h, k) != v}
        if other:
            raise ValueError(f"{other}: the port runs BigVGAN-v2's published form {SUPPORTED}")
        self.h = h
        self.num_kernels = len(h.resblock_kernel_sizes)
        self.conv_pre = Conv1d(h.num_mels, h.upsample_initial_channel, 7, padding=3)
        self.ups = nn.ModuleList()
        for i, (u, k) in enumerate(zip(h.upsample_rates, h.upsample_kernel_sizes)):
            ch = h.upsample_initial_channel // 2 ** (i + 1)
            self.ups.append(nn.ModuleList([ConvTranspose1d(2 * ch, ch, k, u,
                                                           padding=(k - u) // 2)]))
        self.resblocks = nn.ModuleList(
            AMPBlock1(h.upsample_initial_channel // 2 ** (i + 1), k, tuple(d))
            for i in range(len(self.ups))
            for k, d in zip(h.resblock_kernel_sizes, h.resblock_dilation_sizes))
        self.activation_post = Activation1d(ch)
        self.conv_post = Conv1d(ch, 1, 7, padding=3, bias=False)

    def activations(self) -> list:
        return [m for m in self.modules() if isinstance(m, Activation1d)]

    def prepare(self) -> "Generator":
        """Lay every conv weight out channels-last in place (a conv weight
        (O, I, K) as strides (K I, 1, I), a transposed conv's (I, O, K) as
        (K O, 1, O)) and compute every activation's snake terms once, on
        the module's device; returns the module."""
        with torch.no_grad():
            for m in self.modules():
                if isinstance(m, (Conv1d, ConvTranspose1d)) and not is_channels_last(m.weight):
                    m.weight.data = channels_last(m.weight)
            for a in self.activations():
                a.prepare()
        return self

    def _drop_terms(self) -> None:
        for a in self.activations():
            a.terms = None

    def _apply(self, fn, *args, **kwargs):
        self._drop_terms()
        return super()._apply(fn, *args, **kwargs)

    def load_state_dict(self, *args, **kwargs):
        self._drop_terms()
        return super().load_state_dict(*args, **kwargs)

    def stage_blocks(self, i: int):
        """The AMP blocks of stage ``i``."""
        return self.resblocks[i * self.num_kernels:(i + 1) * self.num_kernels]

    def generate(self, mel: torch.Tensor, fused: bool = True) -> torch.Tensor:
        """Mel (B, num_mels, T), any strides -> waveform (B, 1, T * hop)."""
        x = self.conv_pre(channels_last(mel))
        for i, up in enumerate(self.ups):
            x = up[0](x)
            xs = None
            for block in self.stage_blocks(i):
                xs = block(x, fused) if xs is None else xs + block(x, fused)
            x = xs / self.num_kernels
        return torch.clamp(self.conv_post(self.activation_post(x, fused)), -1.0, 1.0)

    def forward(self, mel: torch.Tensor, fused: bool = True) -> torch.Tensor:
        """(B, T, num_mels) -> (B, T * hop, 1), under inference mode."""
        with torch.inference_mode():
            return self.generate(mel.transpose(1, 2), fused).transpose(1, 2)
