"""Shared layers.

Sequence tensors are (B, T, C) at module boundaries, as in the JAX
package. The conv layers subclass torch's own, so their parameters keep
the reference names and layouts (Conv1d weight (out, in, k),
ConvTranspose1d weight (in, out, k)); their ``forward`` takes and returns
(B, T, C) and transposes around the channels-first conv.
"""

import numpy as np
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


def _subpixel_plan(kernel_size: int, stride: int, padding: int):
    """Phase decomposition of a stride-u transposed conv.

    With K the flipped kernel (K[h] = weight[..., k-1-h]), the transposed
    conv is y[j] = sum_h K[h] * xd[j + h - A], A = k-1-p, xd the u-dilated
    input. For output phase r = j % u the valid taps are h with
    (r + h - A) % u == 0, reading input offset d = (r + h - A) / u. Returns
    (d_min, L, placements): placements[r] lists the (d, h) of phase r.
    """
    u, k, A = stride, kernel_size, kernel_size - 1 - padding
    placements = []
    d_all = []
    for r in range(u):
        taps = []
        for h in range(k):
            if (r + h - A) % u == 0:
                d = (r + h - A) // u
                taps.append((d, h))
                d_all.append(d)
        placements.append(taps)
    d_min, d_max = min(d_all), max(d_all)
    return d_min, d_max - d_min + 1, placements


def subpixel_conv_transpose1d(x: torch.Tensor, weight: torch.Tensor, bias, stride: int,
                              padding: int, channels_first: bool = False) -> torch.Tensor:
    """A transposed conv as one dense conv that produces all ``stride``
    output phases on the channel axis, then a depth-to-space interleave
    (no zero-stuffed input). ``weight`` is the torch ConvTranspose1d weight
    (in, out, k); x is (B, T, C) (or (B, C, T) with ``channels_first``),
    and so is the result. ``bias=None`` skips the bias add.

    The interleave emits exactly T*stride samples, which equals the
    transposed conv's (T-1)*stride - 2*padding + k only when 2*padding ==
    k - stride (every HiFi-GAN upsample); raises otherwise.
    """
    cin, cout, k = weight.shape
    u = stride
    if 2 * padding != k - u:
        raise ValueError(
            f"subpixel transposed conv requires 2*padding == k - stride "
            f"(got k={k}, stride={u}, padding={padding})")
    d_min, L, placements = _subpixel_plan(k, u, padding)
    M = np.zeros((k, L, u), np.float32)
    for r, taps in enumerate(placements):
        for d, h in taps:
            M[h, d - d_min, r] = 1.0
    # conv weight w_all[(r, o), i, l] = sum_h M[h, l, r] * K[h, i, o], with
    # the flipped kernel K[h, i, o] = weight[i, o, k-1-h]; one 0/1 einsum
    w_all = torch.einsum("hlr,ioh->roil", torch.from_numpy(M).to(weight), weight.flip(-1))
    w_all = w_all.reshape(u * cout, cin, L)
    if not channels_first:
        x = x.transpose(1, 2)
    y = F.conv1d(F.pad(x, (-d_min, L - 1 + d_min)), w_all)  # (B, u*cout, T)
    B, _, T = y.shape
    y = y.view(B, u, cout, T).permute(0, 2, 3, 1).reshape(B, cout, T * u)
    if bias is not None:
        y = y + bias[:, None]
    return y if channels_first else y.transpose(1, 2)


class SubPixelConvTranspose1d(nn.ConvTranspose1d):
    """torch ConvTranspose1d over (B, T, C), computed as a dense conv plus
    a depth-to-space interleave (``subpixel_conv_transpose1d``): the same
    parameters as ``ConvTranspose1d``, so a state dict loads into either."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return subpixel_conv_transpose1d(x, self.weight, self.bias, self.stride[0],
                                         self.padding[0])


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
        # arguments reach ~1000 rad, so one ulp here moves sin() by ~1e-4;
        # the constant is filled on the device (no host copy: capturable)
        emb = torch.log(torch.full((), 10000.0, device=t.device)) / (half_dim - 1)
        emb = torch.exp(torch.arange(half_dim, dtype=torch.float32, device=t.device) * -emb)
        emb = scale * t[:, None] * emb[None, :]
        return torch.cat([torch.sin(emb), torch.cos(emb)], dim=-1)


class TimestepEmbedding(nn.Module):
    """Two-layer MLP over the sinusoidal embedding (silu in between), in
    the embedding's type: f32 parameters as they are, bf16 ones upcast (a
    bf16 decoder's MLP computes in f32, as JAX promotes it)."""

    def __init__(self, in_channels: int, time_embed_dim: int):
        super().__init__()
        self.linear_1 = nn.Linear(in_channels, time_embed_dim)
        self.linear_2 = nn.Linear(time_embed_dim, time_embed_dim)

    def forward(self, sample: torch.Tensor) -> torch.Tensor:
        def linear(layer, v):
            return F.linear(v, layer.weight.to(v.dtype), layer.bias.to(v.dtype))

        return linear(self.linear_2, F.silu(linear(self.linear_1, sample)))
