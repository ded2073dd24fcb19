"""HiFi-GAN in plain torch: the generator, the discriminators, the GAN losses.

Port of ``matcha_tpu/models/hifigan.py``. The generator: conv_pre -> per stage
[leaky_relu(0.1) -> transposed-conv upsample -> multi-receptive-field
fusion (mean of ResBlocks)] -> leaky_relu(0.01) -> conv_post -> tanh. The
reference's final activation uses torch's default slope 0.01, not 0.1;
kept. Parameter names are the reference's (``conv_pre``, ``ups.i``,
``resblocks.n.convs1.j``, ``conv_post``). ``Generator.forward`` maps a mel
(B, T, num_mels) to a waveform (B, T * hop, 1); inside, activations are
channels-first (B, C, T). ``upsample_impl="subpixel"`` computes the
upsamples as a dense conv plus a depth-to-space interleave
(``components/common.py``) from the same ``ups.i`` parameters.
``Generator(weight_norm=True)`` is the (g, v) training form
(``weight_g``/``weight_v`` per conv, the reference's names) whose
``forward`` keeps autograd; ``generate`` is the channels-first body the
GAN step differentiates. The folded form (the default) runs under
inference mode.

The discriminators and losses (``hifigan.py:154-446``) keep torch's
(B, C, T) and (B, C, H, W) layouts: ``MultiPeriodDiscriminator`` (periods
2, 3, 5, 7, 11; the time axis folded by the period after a reflect pad),
``MultiScaleDiscriminator`` (scale 0 spectrally normalised, scales 1 and 2
after ``avg_pool1d(4, 2, 2)`` counting the padding), ``feature_loss``,
``discriminator_loss`` and ``generator_loss`` (LSGAN). ``SNConv1d`` is the
port's own spectral norm, JAX's and not ``torch.nn.utils.spectral_norm``
(see its docstring).
"""

from dataclasses import dataclass
from typing import List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from benchmark.reference.models.components.common import (
    WeightNormConv,
    WNConv1d,
    WNConvTranspose1d,
    subpixel_conv_transpose1d,
)

LRELU_SLOPE = 0.1


@dataclass
class HiFiGANConfig:
    """v1 hyperparameters, and the vocoder-training protocol."""

    resblock: str = "1"
    upsample_rates: Tuple[int, ...] = (8, 8, 2, 2)
    upsample_kernel_sizes: Tuple[int, ...] = (16, 16, 4, 4)
    upsample_initial_channel: int = 512
    resblock_kernel_sizes: Tuple[int, ...] = (3, 7, 11)
    resblock_dilation_sizes: Tuple[Tuple[int, ...], ...] = ((1, 3, 5), (1, 3, 5), (1, 3, 5))
    num_mels: int = 80
    sampling_rate: int = 22050
    hop_size: int = 256
    segment_size: int = 8192
    n_fft: int = 1024
    win_size: int = 1024
    fmin: float = 0.0
    fmax: float = 8000.0
    batch_size: int = 16
    learning_rate: float = 0.0004
    adam_b1: float = 0.8
    adam_b2: float = 0.99
    lr_decay: float = 0.999
    seed: int = 1234


def get_padding(kernel_size: int, dilation: int = 1) -> int:
    return (kernel_size * dilation - dilation) // 2


class ResBlock1(nn.Module):
    """(B, C, T): per dilation, leaky -> dilated conv -> leaky -> conv,
    with a residual add."""

    def __init__(self, channels: int, kernel_size: int = 3, dilation=(1, 3, 5), conv=nn.Conv1d):
        super().__init__()
        self.convs1 = nn.ModuleList(
            conv(channels, channels, kernel_size, dilation=d,
                 padding=get_padding(kernel_size, d)) for d in dilation)
        self.convs2 = nn.ModuleList(
            conv(channels, channels, kernel_size, padding=get_padding(kernel_size, 1))
            for _ in dilation)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for c1, c2 in zip(self.convs1, self.convs2):
            xt = c1(F.leaky_relu(x, LRELU_SLOPE))
            xt = c2(F.leaky_relu(xt, LRELU_SLOPE))
            x = xt + x
        return x


class ResBlock2(nn.Module):
    """(B, C, T): per dilation, leaky -> dilated conv, with a residual."""

    def __init__(self, channels: int, kernel_size: int = 3, dilation=(1, 3), conv=nn.Conv1d):
        super().__init__()
        self.convs = nn.ModuleList(
            conv(channels, channels, kernel_size, dilation=d,
                 padding=get_padding(kernel_size, d)) for d in dilation)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for c in self.convs:
            x = c(F.leaky_relu(x, LRELU_SLOPE)) + x
        return x


class Generator(nn.Module):
    """Mel (B, T, num_mels) -> waveform (B, T * prod(upsample_rates), 1).

    ``weight_norm=True``: every conv in the (g, v) form (JAX's
    ``Generator(weight_norm=True)``: ``WNConv1d``, and ``WNConvTranspose1d``
    for the upsamples, so only ``upsample_impl="dilated"``)."""

    UPSAMPLE_IMPLS = ("dilated", "subpixel")

    def __init__(self, h: HiFiGANConfig = None, upsample_impl: str = "dilated",
                 weight_norm: bool = False):
        super().__init__()
        h = h or HiFiGANConfig()
        if upsample_impl not in self.UPSAMPLE_IMPLS:
            raise ValueError(f"upsample_impl={upsample_impl!r}: one of {self.UPSAMPLE_IMPLS}")
        if weight_norm and upsample_impl != "dilated":
            raise ValueError(f"upsample_impl={upsample_impl!r}: the weight-norm form upsamples "
                             "by its transposed convs ('dilated') only")
        self.h = h
        self.weight_norm = weight_norm
        self.upsample_impl = upsample_impl
        self.num_kernels = len(h.resblock_kernel_sizes)
        resblock = ResBlock1 if h.resblock == "1" else ResBlock2
        conv, conv_t = (WNConv1d, WNConvTranspose1d) if weight_norm else (nn.Conv1d,
                                                                          nn.ConvTranspose1d)
        self.conv_pre = conv(h.num_mels, h.upsample_initial_channel, 7, padding=3)
        self.ups = nn.ModuleList()
        self.resblocks = nn.ModuleList()
        for i, (u, k) in enumerate(zip(h.upsample_rates, h.upsample_kernel_sizes)):
            ch = h.upsample_initial_channel // (2 ** (i + 1))
            self.ups.append(conv_t(2 * ch, ch, k, u, padding=(k - u) // 2))
            for rk, rd in zip(h.resblock_kernel_sizes, h.resblock_dilation_sizes):
                self.resblocks.append(resblock(ch, rk, tuple(rd), conv))
        self.conv_post = conv(ch, 1, 7, padding=3)

    def stage_blocks(self, i: int):
        """The ResBlocks of MRF stage ``i``."""
        return self.resblocks[i * self.num_kernels:(i + 1) * self.num_kernels]

    def mrf_stage(self, i: int, x: torch.Tensor) -> torch.Tensor:
        """Plain MRF stage ``i`` on (B, C, T): the mean of its ResBlocks."""
        xs = None
        for block in self.stage_blocks(i):
            xs = block(x) if xs is None else xs + block(x)
        return xs / self.num_kernels

    def upsample(self, i: int, x: torch.Tensor, impl: Optional[str] = None) -> torch.Tensor:
        """leaky(0.1) -> upsample ``i`` on (B, C, T), by ``impl`` (default:
        the generator's ``upsample_impl``)."""
        x, up = F.leaky_relu(x, LRELU_SLOPE), self.ups[i]
        impl = impl or self.upsample_impl
        if impl == "dilated":
            return up(x)
        if impl != "subpixel":
            raise ValueError(f"upsample impl {impl!r}: one of {self.UPSAMPLE_IMPLS}")
        return subpixel_conv_transpose1d(x, up.weight, up.bias, up.stride[0], up.padding[0],
                                         channels_first=True)

    def tail(self, x: torch.Tensor) -> torch.Tensor:
        """leaky(0.01) -> conv_post -> tanh, (B, C, T) -> (B, 1, T)."""
        return torch.tanh(self.conv_post(F.leaky_relu(x, 0.01)))

    def post(self, x: torch.Tensor) -> torch.Tensor:
        """:meth:`tail`, transposed to (B, T, 1)."""
        return self.tail(x).transpose(1, 2)

    def generate(self, mel: torch.Tensor) -> torch.Tensor:
        """Mel (B, num_mels, T) -> waveform (B, 1, T * hop), channels first,
        under the caller's autograd mode (the GAN step's form)."""
        x = self.conv_pre(mel)
        for i in range(len(self.ups)):
            x = self.mrf_stage(i, self.upsample(i, x))
        return self.tail(x)

    def forward(self, mel: torch.Tensor) -> torch.Tensor:
        """(B, T, num_mels) -> (B, T * hop, 1): under inference mode in the
        folded form, with autograd in the weight-norm (training) form."""
        if self.weight_norm:
            return self.generate(mel.transpose(1, 2)).transpose(1, 2)
        with torch.inference_mode():
            return self.generate(mel.transpose(1, 2)).transpose(1, 2)
