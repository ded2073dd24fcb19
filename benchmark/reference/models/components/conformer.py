"""Conformer block: the decoder U-Net's optional block type.

The port of ``matcha_tpu/models/components/conformer.py``:

    x = x + 0.5 * FF(x)          # half-step feed-forward
    x = x + MHSA(x)              # with Shaw relative-position bias
    x = x + ConvModule(x)        # pointwise GLU -> depthwise k=31 -> norm -> swish
    x = x + 0.5 * FF(x)
    x = LayerNorm(x)

The parameter names are the lucidrains ``conformer`` package's (the
layout the reference ``ConformerWrapper`` saves and
``matcha_tpu/utils/checkpoints.py::_convert_conformer_block`` reads):
``ff1.fn.norm``, ``ff1.fn.fn.net.{0,3}``, ``attn.norm``,
``attn.fn.{to_q,to_kv,to_out,rel_pos_emb}``, ``conv.net.{0,2,4.conv,5,7}``,
``ff2.*``, ``post_norm``; so a reference conformer checkpoint loads as it is.

As in the JAX package: every LayerNorm and the GroupNorm take flax's eps
of 1e-6 (torch's default is 1e-5); the conv module's norm is a GroupNorm
over all channels by default, or with ``use_batch_norm`` a BatchNorm1d in
its running-statistics form in ``train()`` mode too (eps 1e-5). In that
mode the attention masks query and key rows and the block's output is
left unmasked; otherwise only keys are masked and the output is.

The relative-position term q_i . E[clip(i - j) + 512] is taken as
``q @ E^T``, (B, h, T, 1025), gathered at (i, j): the (T, T, dim_head)
tensor that the JAX einsum writes out is never built.
"""

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

#: flax's LayerNorm and GroupNorm epsilon
FLAX_EPS = 1e-6


class Swish(nn.Module):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x * torch.sigmoid(x)


class Scale(nn.Module):
    def __init__(self, scale: float, fn: nn.Module):
        super().__init__()
        self.scale, self.fn = scale, fn

    def forward(self, x: torch.Tensor, **kwargs) -> torch.Tensor:
        return self.scale * self.fn(x, **kwargs)


class PreNorm(nn.Module):
    def __init__(self, dim: int, fn: nn.Module):
        super().__init__()
        self.norm = nn.LayerNorm(dim, eps=FLAX_EPS)
        self.fn = fn

    def forward(self, x: torch.Tensor, **kwargs) -> torch.Tensor:
        return self.fn(self.norm(x), **kwargs)


class FeedForward(nn.Module):
    """``net`` = [Linear, Swish, Dropout, Linear, Dropout]."""

    def __init__(self, dim: int, mult: int = 1, dropout: float = 0.0):
        super().__init__()
        self.net = nn.Sequential(nn.Linear(dim, dim * mult), Swish(), nn.Dropout(dropout),
                                 nn.Linear(dim * mult, dim), nn.Dropout(dropout))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.net(x)


class Attention(nn.Module):
    """Self-attention with the Shaw relative-position bias on the scores.
    ``mask`` (B, T) 0/1; ``combined_mask`` masks query and key rows (a
    fully masked query row attends uniformly to every position), else
    keys only."""

    def __init__(self, dim: int, heads: int = 8, dim_head: int = 64, dropout: float = 0.0,
                 max_pos_emb: int = 512, combined_mask: bool = False):
        super().__init__()
        inner = heads * dim_head
        self.heads, self.dim_head, self.max_pos_emb = heads, dim_head, max_pos_emb
        self.combined_mask = combined_mask
        self.to_q = nn.Linear(dim, inner, bias=False)
        self.to_kv = nn.Linear(dim, inner * 2, bias=False)
        self.to_out = nn.Linear(inner, dim)
        self.rel_pos_emb = nn.Embedding(2 * max_pos_emb + 1, dim_head)
        self.dropout = nn.Dropout(dropout)

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        B, T, _ = x.shape
        k, v = self.to_kv(x).chunk(2, dim=-1)

        def heads_split(t):
            return t.reshape(B, T, self.heads, self.dim_head).transpose(1, 2)

        q, k, v = heads_split(self.to_q(x)), heads_split(k), heads_split(v)
        scale = self.dim_head ** -0.5
        scores = torch.matmul(q, k.transpose(-1, -2)) * scale
        # q_i . E[clip(i - j) + M]: q against every row of the table, then
        # gathered at (i, j), built on the device (capturable)
        pos = torch.arange(T, device=x.device)
        rel = (pos[:, None] - pos[None, :]).clamp(-self.max_pos_emb, self.max_pos_emb)
        rel = rel + self.max_pos_emb
        q_rel = torch.matmul(q, self.rel_pos_emb.weight.transpose(0, 1))
        scores = scores + torch.gather(q_rel, -1, rel.expand(B, self.heads, T, T)) * scale
        if mask is not None:
            keep = (mask[:, None, :, None] * mask[:, None, None, :] if self.combined_mask
                    else mask[:, None, None, :])
            scores = scores.masked_fill(keep <= 0, torch.finfo(scores.dtype).min)
        attn = self.dropout(torch.softmax(scores, dim=-1))
        out = torch.matmul(attn, v).transpose(1, 2).reshape(B, T, self.heads * self.dim_head)
        return self.dropout(self.to_out(out))


class Transpose(nn.Module):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x.transpose(1, 2)


class DepthWiseConv1d(nn.Module):
    """A grouped k-tap conv with 'same' padding (``conv`` holds the
    weights, as lucidrains names them)."""

    def __init__(self, channels: int, kernel_size: int):
        super().__init__()
        pad = (kernel_size - 1) // 2
        self.padding = (pad, kernel_size - 1 - pad)
        self.conv = nn.Conv1d(channels, channels, kernel_size, groups=channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(F.pad(x, self.padding))


class FrozenBatchNorm1d(nn.BatchNorm1d):
    """BatchNorm1d that always normalises with its running statistics,
    also in ``train()`` mode, and never updates them (JAX's
    ``use_running_average=True``)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.batch_norm(x, self.running_mean, self.running_var, self.weight, self.bias,
                            False, 0.0, self.eps)


class ConformerConvModule(nn.Module):
    """``net`` = [LayerNorm, to channels-first, pointwise conv, GLU,
    depthwise conv, norm, Swish, pointwise conv, to channels-last,
    Dropout] on (B, T, C)."""

    def __init__(self, dim: int, expansion_factor: int = 2, kernel_size: int = 31,
                 dropout: float = 0.0, use_batch_norm: bool = False):
        super().__init__()
        inner = dim * expansion_factor
        norm = (FrozenBatchNorm1d(inner, eps=1e-5) if use_batch_norm
                else nn.GroupNorm(1, inner, eps=FLAX_EPS))
        self.net = nn.Sequential(
            nn.LayerNorm(dim, eps=FLAX_EPS), Transpose(), nn.Conv1d(dim, inner * 2, 1), nn.GLU(dim=1),
            DepthWiseConv1d(inner, kernel_size), norm, Swish(), nn.Conv1d(inner, dim, 1),
            Transpose(), nn.Dropout(dropout))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.net(x)


class ConformerBlock(nn.Module):
    """The decoder's alternative to ``BasicTransformerBlock``, with its
    contract: (B, T, dim) and a (B, T) 0/1 mask in, (B, T, dim) out."""

    def __init__(self, dim: int, heads: int = 8, dim_head: int = 64, ff_mult: int = 1,
                 conv_expansion_factor: int = 2, conv_kernel_size: int = 31,
                 attn_dropout: float = 0.0, ff_dropout: float = 0.0, conv_dropout: float = 0.0,
                 use_batch_norm: bool = False):
        super().__init__()
        self.use_batch_norm = use_batch_norm
        self.ff1 = Scale(0.5, PreNorm(dim, FeedForward(dim, ff_mult, ff_dropout)))
        self.attn = PreNorm(dim, Attention(dim, heads, dim_head, attn_dropout,
                                           combined_mask=use_batch_norm))
        self.conv = ConformerConvModule(dim, conv_expansion_factor, conv_kernel_size,
                                        conv_dropout, use_batch_norm)
        self.ff2 = Scale(0.5, PreNorm(dim, FeedForward(dim, ff_mult, ff_dropout)))
        self.post_norm = nn.LayerNorm(dim, eps=FLAX_EPS)

    def forward(self, hidden_states: torch.Tensor,
                attention_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        x = hidden_states
        x = x + self.ff1(x)
        x = x + self.attn(x, mask=attention_mask)
        x = x + self.conv(x)
        x = x + self.ff2(x)
        x = self.post_norm(x)
        # the BatchNorm (checkpoint) mode leaves padded rows as they are,
        # as the reference block stack does; the U-Net masks at its stage
        # boundaries
        if attention_mask is not None and not self.use_batch_norm:
            x = x * attention_mask[..., None]
        return x
