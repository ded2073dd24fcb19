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

from matcha_tpu_torch.models.components.common import (
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


# --------------------------------------------------------------------------
# discriminators


class WNConv2d(WeightNormConv):
    """Weight-normalised ``Conv2d`` on (B, C, H, W), no epsilon (JAX's
    ``Conv2dNCHW(weight_norm=True)``); weight_v (out, in, kh, kw),
    weight_g (out, 1, 1, 1)."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size, stride=1, padding=0):
        super().__init__()
        self._init_from(nn.Conv2d(in_channels, out_channels, kernel_size, stride, padding), None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.conv2d(x, self.weight, self.bias, self.stride, self.padding)


class DiscriminatorP(nn.Module):
    """Period discriminator on (B, 1, T): reflect-pad T to a multiple of
    the period, fold it into (B, 1, T / p, p), run 2-D convs over the
    first axis, every conv weight-normed. Returns (logits (B, n), feature
    maps)."""

    def __init__(self, period: int, kernel_size: int = 5, stride: int = 3):
        super().__init__()
        self.period = period
        pad = (get_padding(5, 1), 0)
        self.convs = nn.ModuleList([
            WNConv2d(1, 32, (kernel_size, 1), (stride, 1), pad),
            WNConv2d(32, 128, (kernel_size, 1), (stride, 1), pad),
            WNConv2d(128, 512, (kernel_size, 1), (stride, 1), pad),
            WNConv2d(512, 1024, (kernel_size, 1), (stride, 1), pad),
            WNConv2d(1024, 1024, (kernel_size, 1), 1, (2, 0)),
        ])
        self.conv_post = WNConv2d(1024, 1, (3, 1), 1, (1, 0))

    def forward(self, x: torch.Tensor):
        fmap = []
        B, C, T = x.shape
        if T % self.period:
            n_pad = self.period - T % self.period
            x = F.pad(x, (0, n_pad), mode="reflect")
            T += n_pad
        x = x.view(B, C, T // self.period, self.period)
        for conv in self.convs:
            x = F.leaky_relu(conv(x), LRELU_SLOPE)
            fmap.append(x)
        x = self.conv_post(x)
        fmap.append(x)
        return torch.flatten(x, 1, -1), fmap


def _unit_start(n: int, like: torch.Tensor) -> torch.Tensor:
    """The power iteration's first u: 1 / sqrt(n) in every element,
    computed in ``like``'s type as JAX computes it."""
    return torch.ones(n, dtype=like.dtype, device=like.device) / torch.sqrt(
        torch.tensor(float(n), dtype=like.dtype, device=like.device))


def spectral_normalize(weight: torch.Tensor, n_iters: int = 7) -> torch.Tensor:
    """``weight`` divided by its spectral norm (largest singular value of
    the (out, rest) matrix), estimated by ``n_iters`` power iterations
    from a fixed start, differentiable throughout: JAX's stateless
    ``_spectral_normalize``."""
    out = weight.shape[0]
    w = weight.reshape(out, -1)
    u = _unit_start(out, weight)
    for _ in range(n_iters):
        v = w.t() @ u
        v = v / (torch.linalg.vector_norm(v) + 1e-12)
        u = w @ v
        u = u / (torch.linalg.vector_norm(u) + 1e-12)
    sigma = v @ (w.t() @ u)
    return weight / (sigma + 1e-12)


class SNConv1d(nn.Module):
    """Spectrally normalised (grouped) ``Conv1d`` on (B, C, T).

    Parameters ``weight_orig`` and ``bias`` and buffers ``weight_u`` (out,)
    and ``weight_v`` (rest,), as ``torch.nn.utils.spectral_norm`` names
    them, so a reference state dict loads as is. The estimate is JAX's
    ``SNConv1d``, not torch's:

    * ``running_u=True``: u starts at 1 / sqrt(out) in every element (torch
      starts at random); each call runs ONE power iteration from the
      stored u, and stores the new u (and v) only when called with
      ``update_u=True`` (torch updates on every training-mode call). So
      within one discriminator pass the second call starts from the u the
      first stored, and the generator pass recomputes u from the stored
      one and keeps it. Sigma keeps the gradient through the weight, u
      and v detached.
    * ``running_u=False``: the stateless 7-iteration
      :func:`spectral_normalize`; the buffers are not read.
    """

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int, stride: int = 1,
                 padding: int = 0, groups: int = 1, running_u: bool = False):
        super().__init__()
        conv = nn.Conv1d(in_channels, out_channels, kernel_size, stride, padding, groups=groups)
        self.weight_orig = nn.Parameter(conv.weight.detach().clone())
        self.bias = nn.Parameter(conv.bias.detach().clone())
        self.stride, self.padding, self.groups = stride, padding, groups
        self.running_u = running_u
        self.register_buffer("weight_u", _unit_start(out_channels, conv.weight))
        self.register_buffer("weight_v", torch.zeros(conv.weight[0].numel()))

    def normalized_weight(self, update_u: bool = False) -> torch.Tensor:
        if not self.running_u:
            return spectral_normalize(self.weight_orig)
        w = self.weight_orig.reshape(self.weight_orig.shape[0], -1)
        with torch.no_grad():
            wd = w.detach()
            v = wd.t() @ self.weight_u
            v = v / (torch.linalg.vector_norm(v) + 1e-12)
            u = wd @ v
            u = u / (torch.linalg.vector_norm(u) + 1e-12)
            if update_u:
                self.weight_u.copy_(u)
                self.weight_v.copy_(v)
        sigma = v @ (w.t() @ u)
        return self.weight_orig / (sigma + 1e-12)

    def forward(self, x: torch.Tensor, update_u: bool = False) -> torch.Tensor:
        return F.conv1d(x, self.normalized_weight(update_u), self.bias, self.stride,
                        self.padding, groups=self.groups)


#: (out channels, kernel, stride, padding, groups) of the scale
#: discriminator's convs
MSD_SPECS = ((128, 15, 1, 7, 1), (128, 41, 2, 20, 4), (256, 41, 2, 20, 16),
             (512, 41, 4, 20, 16), (1024, 41, 4, 20, 16), (1024, 41, 1, 20, 16),
             (1024, 5, 1, 2, 1))


class DiscriminatorS(nn.Module):
    """Scale discriminator: grouped 1-D convs on the waveform (B, 1, T).
    Spectrally normalised (``use_spectral_norm``) or weight-normed.
    Returns (logits (B, n), feature maps)."""

    def __init__(self, use_spectral_norm: bool = False, running_u: bool = False):
        super().__init__()
        self.spectral = use_spectral_norm
        if use_spectral_norm:
            def conv(i, o, k, s=1, p=0, g=1):
                return SNConv1d(i, o, k, s, p, g, running_u=running_u)
        else:  # no epsilon here (JAX's WNGroupedConv1d)
            def conv(i, o, k, s=1, p=0, g=1):
                return WNConv1d(i, o, k, s, p, groups=g, eps=None)
        chans = [1] + [spec[0] for spec in MSD_SPECS]
        self.convs = nn.ModuleList(conv(c_in, *spec)
                                   for c_in, spec in zip(chans, MSD_SPECS))
        self.conv_post = conv(1024, 1, 3, 1, 1)

    def forward(self, x: torch.Tensor, update_u: bool = False):
        fmap = []
        for conv in self.convs:
            x = F.leaky_relu(conv(x, update_u) if self.spectral else conv(x), LRELU_SLOPE)
            fmap.append(x)
        x = self.conv_post(x, update_u) if self.spectral else self.conv_post(x)
        fmap.append(x)
        return torch.flatten(x, 1, -1), fmap


class MultiPeriodDiscriminator(nn.Module):
    def __init__(self, periods: Tuple[int, ...] = (2, 3, 5, 7, 11)):
        super().__init__()
        self.discriminators = nn.ModuleList(DiscriminatorP(p) for p in periods)

    def forward(self, y: torch.Tensor, y_hat: torch.Tensor):
        """Waveforms (B, 1, T) -> (real logits, generated logits, real
        feature maps, generated feature maps), one entry per period."""
        y_d_rs, y_d_gs, fmap_rs, fmap_gs = [], [], [], []
        for d in self.discriminators:
            y_d_r, fmap_r = d(y)
            y_d_g, fmap_g = d(y_hat)
            y_d_rs.append(y_d_r)
            fmap_rs.append(fmap_r)
            y_d_gs.append(y_d_g)
            fmap_gs.append(fmap_g)
        return y_d_rs, y_d_gs, fmap_rs, fmap_gs


class MultiScaleDiscriminator(nn.Module):
    def __init__(self, running_u: bool = False):
        super().__init__()
        self.discriminators = nn.ModuleList(
            DiscriminatorS(use_spectral_norm=(i == 0), running_u=running_u) for i in range(3))

    def forward(self, y: torch.Tensor, y_hat: torch.Tensor, update_u: bool = False):
        """As ``MultiPeriodDiscriminator.forward``, one entry per scale;
        ``update_u`` stores scale 0's running u (the discriminator pass)."""
        y_d_rs, y_d_gs, fmap_rs, fmap_gs = [], [], [], []
        for i, d in enumerate(self.discriminators):
            if i:
                y = F.avg_pool1d(y, 4, 2, padding=2)
                y_hat = F.avg_pool1d(y_hat, 4, 2, padding=2)
            y_d_r, fmap_r = d(y, update_u)
            y_d_g, fmap_g = d(y_hat, update_u)
            y_d_rs.append(y_d_r)
            fmap_rs.append(fmap_r)
            y_d_gs.append(y_d_g)
            fmap_gs.append(fmap_g)
        return y_d_rs, y_d_gs, fmap_rs, fmap_gs


def feature_loss(fmap_r: List, fmap_g: List) -> torch.Tensor:
    loss = 0.0
    for dr, dg in zip(fmap_r, fmap_g):
        for rl, gl in zip(dr, dg):
            loss = loss + torch.mean(torch.abs(rl - gl))
    return loss * 2


def discriminator_loss(disc_real_outputs: List, disc_generated_outputs: List):
    loss = 0.0
    r_losses, g_losses = [], []
    for dr, dg in zip(disc_real_outputs, disc_generated_outputs):
        r_loss = torch.mean((1 - dr) ** 2)
        g_loss = torch.mean(dg ** 2)
        loss = loss + r_loss + g_loss
        r_losses.append(r_loss)
        g_losses.append(g_loss)
    return loss, r_losses, g_losses


def generator_loss(disc_outputs: List):
    loss = 0.0
    gen_losses = []
    for dg in disc_outputs:
        l_g = torch.mean((1 - dg) ** 2)
        gen_losses.append(l_g)
        loss = loss + l_g
    return loss, gen_losses
