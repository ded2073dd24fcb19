"""HiFi-GAN generator in plain torch (inference, weight norm folded).

Port of ``matcha_tpu/models/hifigan.py:35-151``: conv_pre -> per stage
[leaky_relu(0.1) -> transposed-conv upsample -> multi-receptive-field
fusion (mean of ResBlocks)] -> leaky_relu(0.01) -> conv_post -> tanh. The
reference's final activation uses torch's default slope 0.01, not 0.1;
kept. Parameter names are the reference's (``conv_pre``, ``ups.i``,
``resblocks.n.convs1.j``, ``conv_post``). ``Generator.forward`` maps a mel
(B, T, num_mels) to a waveform (B, T * hop, 1); inside, activations are
channels-first (B, C, T). ``upsample_impl="subpixel"`` computes the
upsamples as a dense conv plus a depth-to-space interleave
(``components/common.py``) from the same ``ups.i`` parameters.
"""

from dataclasses import dataclass
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from matcha_tpu_torch.models.components.common import subpixel_conv_transpose1d

LRELU_SLOPE = 0.1


@dataclass
class HiFiGANConfig:
    """v1 hyperparameters."""

    resblock: str = "1"
    upsample_rates: Tuple[int, ...] = (8, 8, 2, 2)
    upsample_kernel_sizes: Tuple[int, ...] = (16, 16, 4, 4)
    upsample_initial_channel: int = 512
    resblock_kernel_sizes: Tuple[int, ...] = (3, 7, 11)
    resblock_dilation_sizes: Tuple[Tuple[int, ...], ...] = ((1, 3, 5), (1, 3, 5), (1, 3, 5))
    num_mels: int = 80
    sampling_rate: int = 22050
    hop_size: int = 256


def get_padding(kernel_size: int, dilation: int = 1) -> int:
    return (kernel_size * dilation - dilation) // 2


class ResBlock1(nn.Module):
    """(B, C, T): per dilation, leaky -> dilated conv -> leaky -> conv,
    with a residual add."""

    def __init__(self, channels: int, kernel_size: int = 3, dilation=(1, 3, 5)):
        super().__init__()
        self.convs1 = nn.ModuleList(
            nn.Conv1d(channels, channels, kernel_size, dilation=d,
                      padding=get_padding(kernel_size, d)) for d in dilation)
        self.convs2 = nn.ModuleList(
            nn.Conv1d(channels, channels, kernel_size, padding=get_padding(kernel_size, 1))
            for _ in dilation)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for c1, c2 in zip(self.convs1, self.convs2):
            xt = c1(F.leaky_relu(x, LRELU_SLOPE))
            xt = c2(F.leaky_relu(xt, LRELU_SLOPE))
            x = xt + x
        return x


class ResBlock2(nn.Module):
    """(B, C, T): per dilation, leaky -> dilated conv, with a residual."""

    def __init__(self, channels: int, kernel_size: int = 3, dilation=(1, 3)):
        super().__init__()
        self.convs = nn.ModuleList(
            nn.Conv1d(channels, channels, kernel_size, dilation=d,
                      padding=get_padding(kernel_size, d)) for d in dilation)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for c in self.convs:
            x = c(F.leaky_relu(x, LRELU_SLOPE)) + x
        return x


class Generator(nn.Module):
    """Mel (B, T, num_mels) -> waveform (B, T * prod(upsample_rates), 1)."""

    UPSAMPLE_IMPLS = ("dilated", "subpixel")

    def __init__(self, h: HiFiGANConfig = None, upsample_impl: str = "dilated"):
        super().__init__()
        h = h or HiFiGANConfig()
        if upsample_impl not in self.UPSAMPLE_IMPLS:
            raise ValueError(f"upsample_impl={upsample_impl!r}: one of {self.UPSAMPLE_IMPLS}")
        self.h = h
        self.upsample_impl = upsample_impl
        self.num_kernels = len(h.resblock_kernel_sizes)
        resblock = ResBlock1 if h.resblock == "1" else ResBlock2
        self.conv_pre = nn.Conv1d(h.num_mels, h.upsample_initial_channel, 7, padding=3)
        self.ups = nn.ModuleList()
        self.resblocks = nn.ModuleList()
        for i, (u, k) in enumerate(zip(h.upsample_rates, h.upsample_kernel_sizes)):
            ch = h.upsample_initial_channel // (2 ** (i + 1))
            self.ups.append(nn.ConvTranspose1d(2 * ch, ch, k, u, padding=(k - u) // 2))
            for rk, rd in zip(h.resblock_kernel_sizes, h.resblock_dilation_sizes):
                self.resblocks.append(resblock(ch, rk, tuple(rd)))
        self.conv_post = nn.Conv1d(ch, 1, 7, padding=3)

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

    def post(self, x: torch.Tensor) -> torch.Tensor:
        """leaky(0.01) -> conv_post -> tanh, (B, C, T) -> (B, T, 1)."""
        return torch.tanh(self.conv_post(F.leaky_relu(x, 0.01))).transpose(1, 2)

    @torch.inference_mode()
    def forward(self, mel: torch.Tensor) -> torch.Tensor:
        x = self.conv_pre(mel.transpose(1, 2))
        for i in range(len(self.ups)):
            x = self.mrf_stage(i, self.upsample(i, x))
        return self.post(x)
