"""Shared layers.

Sequence tensors are (B, T, C) at module boundaries, as in the JAX
package. The conv layers subclass torch's own, so their parameters keep
the reference names and layouts (Conv1d weight (out, in, k),
ConvTranspose1d weight (in, out, k)); their ``forward`` takes and returns
(B, T, C) and transposes around the channels-first conv.
"""

import torch
import torch.nn.functional as F
from torch import nn


class Conv1d(nn.Conv1d):
    """torch Conv1d over (B, T, C)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return super().forward(x.transpose(1, 2)).transpose(1, 2)


class PointwiseConv1d(nn.Conv1d):
    """A kernel-size-1 Conv1d (reference weight (out, in, 1)) applied as a
    dense layer over the channels of a (B, T, C) tensor."""

    def __init__(self, in_channels: int, out_channels: int, bias: bool = True):
        super().__init__(in_channels, out_channels, 1, bias=bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x, self.weight[:, :, 0], self.bias)


class ConvTranspose1d(nn.ConvTranspose1d):
    """torch ConvTranspose1d over (B, T, C):
    out_len = (T - 1) * stride - 2 * padding + kernel_size."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return super().forward(x.transpose(1, 2)).transpose(1, 2)


class ChannelLayerNorm(nn.Module):
    """LayerNorm over the channel axis with eps=1e-4 (the reference text
    encoder's ``LayerNorm``, parameters ``gamma``/``beta``)."""

    def __init__(self, channels: int, eps: float = 1e-4):
        super().__init__()
        self.eps = eps
        self.gamma = nn.Parameter(torch.ones(channels))
        self.beta = nn.Parameter(torch.zeros(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        mean = x.mean(dim=-1, keepdim=True)
        var = ((x - mean) ** 2).mean(dim=-1, keepdim=True)
        x = (x - mean) * torch.rsqrt(var + self.eps)
        return x * self.gamma + self.beta


def mish(x: torch.Tensor) -> torch.Tensor:
    return x * torch.tanh(F.softplus(x))


def leaky_relu(x: torch.Tensor, negative_slope: float = 0.01) -> torch.Tensor:
    return torch.where(x >= 0, x, negative_slope * x)


class SinusoidalPosEmb(nn.Module):
    """Diffusion-style sinusoidal time embedding (scale 1000)."""

    def __init__(self, dim: int):
        super().__init__()
        self.dim = dim

    def forward(self, t: torch.Tensor, scale: float = 1000.0) -> torch.Tensor:
        if t.dim() < 1:
            t = t[None]
        half_dim = self.dim // 2
        # f32 throughout, in the JAX package's order of operations: the
        # arguments reach ~1000 rad, so one ulp here moves sin() by ~1e-4
        emb = torch.log(torch.tensor(10000.0, device=t.device)) / (half_dim - 1)
        emb = torch.exp(torch.arange(half_dim, dtype=torch.float32, device=t.device) * -emb)
        emb = scale * t[:, None] * emb[None, :]
        return torch.cat([torch.sin(emb), torch.cos(emb)], dim=-1)


class TimestepEmbedding(nn.Module):
    """Two-layer MLP over the sinusoidal embedding (silu in between)."""

    def __init__(self, in_channels: int, time_embed_dim: int):
        super().__init__()
        self.linear_1 = nn.Linear(in_channels, time_embed_dim)
        self.linear_2 = nn.Linear(time_embed_dim, time_embed_dim)

    def forward(self, sample: torch.Tensor) -> torch.Tensor:
        return self.linear_2(F.silu(self.linear_1(sample)))
