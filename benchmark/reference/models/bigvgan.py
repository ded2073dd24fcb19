"""BigVGAN-v2's generator in plain torch, f32: the reference the benchmark
holds the system's BigVGAN to.

Written from the published code (github.com/NVIDIA/BigVGAN ``bigvgan.py``,
``activations.py``, ``alias_free_activation/torch/{act,filter,resample}.py``;
Lee et al., arXiv:2206.04658), with its module and parameter names. It
imports nothing from the system under test.

Departures from the published code:
- no weight norm: every conv holds its folded ``weight``;
- no training code (no ``remove_weight_norm``, no hub mixin, no fused CUDA
  activation);
- ``forward`` takes a mel (B, T, num_mels) and returns (B, T * hop, 1),
  the harness's vocoder contract; ``generate`` is the published forward,
  (B, num_mels, T) -> (B, 1, T * hop);
- the Kaiser-sinc filters are computed on the CPU in f32 and copied to
  the default device, so that the module can be built on ``meta``.
Run on a card it is held in full f32 by the judge's context (TF32 off).
"""

import math
from dataclasses import dataclass
from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn


@dataclass
class BigVGANConfig:
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


def get_padding(kernel_size, dilation=1):
    return int((kernel_size * dilation - dilation) / 2)


def kaiser_sinc_filter1d(cutoff, half_width, kernel_size):
    even = kernel_size % 2 == 0
    half_size = kernel_size // 2
    delta_f = 4 * half_width
    A = 2.285 * (half_size - 1) * math.pi * delta_f + 7.95
    if A > 50.0:
        beta = 0.1102 * (A - 8.7)
    elif A >= 21.0:
        beta = 0.5842 * (A - 21) ** 0.4 + 0.07886 * (A - 21.0)
    else:
        beta = 0.0
    window = torch.kaiser_window(kernel_size, beta=beta, periodic=False, device="cpu")
    if even:
        time = torch.arange(-half_size, half_size, device="cpu") + 0.5
    else:
        time = torch.arange(kernel_size, device="cpu") - half_size
    if cutoff == 0:
        filter_ = torch.zeros_like(time)
    else:
        filter_ = 2 * cutoff * window * torch.sinc(2 * cutoff * time)
        filter_ /= filter_.sum()
    filter = filter_.view(1, 1, kernel_size)
    return torch.empty(filter.shape).copy_(filter)


class LowPassFilter1d(nn.Module):
    def __init__(self, cutoff=0.5, half_width=0.6, stride=1, padding=True,
                 padding_mode="replicate", kernel_size=12):
        super().__init__()
        self.kernel_size = kernel_size
        self.even = kernel_size % 2 == 0
        self.pad_left = kernel_size // 2 - int(self.even)
        self.pad_right = kernel_size // 2
        self.stride = stride
        self.padding = padding
        self.padding_mode = padding_mode
        self.register_buffer("filter", kaiser_sinc_filter1d(cutoff, half_width, kernel_size))

    def forward(self, x):
        _, C, _ = x.shape
        if self.padding:
            x = F.pad(x, (self.pad_left, self.pad_right), mode=self.padding_mode)
        return F.conv1d(x, self.filter.expand(C, -1, -1), stride=self.stride, groups=C)


class UpSample1d(nn.Module):
    def __init__(self, ratio=2, kernel_size=None):
        super().__init__()
        self.ratio = ratio
        self.kernel_size = int(6 * ratio // 2) * 2 if kernel_size is None else kernel_size
        self.stride = ratio
        self.pad = self.kernel_size // ratio - 1
        self.pad_left = self.pad * self.stride + (self.kernel_size - self.stride) // 2
        self.pad_right = self.pad * self.stride + (self.kernel_size - self.stride + 1) // 2
        self.register_buffer("filter", kaiser_sinc_filter1d(
            cutoff=0.5 / ratio, half_width=0.6 / ratio, kernel_size=self.kernel_size))

    def forward(self, x):
        _, C, _ = x.shape
        x = F.pad(x, (self.pad, self.pad), mode="replicate")
        x = self.ratio * F.conv_transpose1d(x, self.filter.expand(C, -1, -1),
                                            stride=self.stride, groups=C)
        return x[..., self.pad_left:-self.pad_right]


class DownSample1d(nn.Module):
    def __init__(self, ratio=2, kernel_size=None):
        super().__init__()
        self.ratio = ratio
        self.kernel_size = int(6 * ratio // 2) * 2 if kernel_size is None else kernel_size
        self.lowpass = LowPassFilter1d(cutoff=0.5 / ratio, half_width=0.6 / ratio, stride=ratio,
                                       kernel_size=self.kernel_size)

    def forward(self, x):
        return self.lowpass(x)


class SnakeBeta(nn.Module):
    def __init__(self, in_features, alpha=1.0, alpha_trainable=True, alpha_logscale=False):
        super().__init__()
        self.in_features = in_features
        self.alpha_logscale = alpha_logscale
        if self.alpha_logscale:
            self.alpha = nn.Parameter(torch.zeros(in_features) * alpha)
            self.beta = nn.Parameter(torch.zeros(in_features) * alpha)
        else:
            self.alpha = nn.Parameter(torch.ones(in_features) * alpha)
            self.beta = nn.Parameter(torch.ones(in_features) * alpha)
        self.alpha.requires_grad = alpha_trainable
        self.beta.requires_grad = alpha_trainable
        self.no_div_by_zero = 0.000000001

    def forward(self, x):
        alpha = self.alpha.unsqueeze(0).unsqueeze(-1)
        beta = self.beta.unsqueeze(0).unsqueeze(-1)
        if self.alpha_logscale:
            alpha = torch.exp(alpha)
            beta = torch.exp(beta)
        return x + (1.0 / (beta + self.no_div_by_zero)) * torch.pow(torch.sin(x * alpha), 2)


class Activation1d(nn.Module):
    def __init__(self, activation, up_ratio=2, down_ratio=2, up_kernel_size=12,
                 down_kernel_size=12):
        super().__init__()
        self.up_ratio = up_ratio
        self.down_ratio = down_ratio
        self.act = activation
        self.upsample = UpSample1d(up_ratio, up_kernel_size)
        self.downsample = DownSample1d(down_ratio, down_kernel_size)

    def forward(self, x):
        x = self.upsample(x)
        x = self.act(x)
        return self.downsample(x)


class AMPBlock1(nn.Module):
    def __init__(self, h, channels, kernel_size=3, dilation=(1, 3, 5)):
        super().__init__()
        self.h = h
        self.convs1 = nn.ModuleList([
            nn.Conv1d(channels, channels, kernel_size, stride=1, dilation=d,
                      padding=get_padding(kernel_size, d)) for d in dilation])
        self.convs2 = nn.ModuleList([
            nn.Conv1d(channels, channels, kernel_size, stride=1, dilation=1,
                      padding=get_padding(kernel_size, 1)) for _ in range(len(dilation))])
        self.num_layers = len(self.convs1) + len(self.convs2)
        self.activations = nn.ModuleList([
            Activation1d(activation=SnakeBeta(channels, alpha_logscale=h.snake_logscale))
            for _ in range(self.num_layers)])

    def forward(self, x):
        acts1, acts2 = self.activations[::2], self.activations[1::2]
        for c1, c2, a1, a2 in zip(self.convs1, self.convs2, acts1, acts2):
            xt = a1(x)
            xt = c1(xt)
            xt = a2(xt)
            xt = c2(xt)
            x = xt + x
        return x


class Generator(nn.Module):
    """The published ``BigVGAN`` module, inference form."""

    def __init__(self, h: BigVGANConfig = None):
        super().__init__()
        h = h or BigVGANConfig()
        if h.resblock != "1" or h.activation != "snakebeta":
            raise ValueError("the reference holds AMP block 1 with snakebeta only")
        self.h = h
        self.num_kernels = len(h.resblock_kernel_sizes)
        self.num_upsamples = len(h.upsample_rates)
        self.conv_pre = nn.Conv1d(h.num_mels, h.upsample_initial_channel, 7, 1, padding=3)
        self.ups = nn.ModuleList()
        for i, (u, k) in enumerate(zip(h.upsample_rates, h.upsample_kernel_sizes)):
            self.ups.append(nn.ModuleList([
                nn.ConvTranspose1d(h.upsample_initial_channel // (2 ** i),
                                   h.upsample_initial_channel // (2 ** (i + 1)),
                                   k, u, padding=(k - u) // 2)]))
        self.resblocks = nn.ModuleList()
        for i in range(len(self.ups)):
            ch = h.upsample_initial_channel // (2 ** (i + 1))
            for k, d in zip(h.resblock_kernel_sizes, h.resblock_dilation_sizes):
                self.resblocks.append(AMPBlock1(h, ch, k, d))
        self.activation_post = Activation1d(
            activation=SnakeBeta(ch, alpha_logscale=h.snake_logscale))
        self.conv_post = nn.Conv1d(ch, 1, 7, 1, padding=3, bias=h.use_bias_at_final)

    def generate(self, x):
        x = self.conv_pre(x)
        for i in range(self.num_upsamples):
            for i_up in range(len(self.ups[i])):
                x = self.ups[i][i_up](x)
            xs = None
            for j in range(self.num_kernels):
                if xs is None:
                    xs = self.resblocks[i * self.num_kernels + j](x)
                else:
                    xs += self.resblocks[i * self.num_kernels + j](x)
            x = xs / self.num_kernels
        x = self.activation_post(x)
        x = self.conv_post(x)
        if self.h.use_tanh_at_final:
            return torch.tanh(x)
        return torch.clamp(x, min=-1.0, max=1.0)

    def forward(self, mel):
        """(B, T, num_mels) -> (B, T * hop, 1)."""
        return self.generate(mel.transpose(1, 2)).transpose(1, 2)
