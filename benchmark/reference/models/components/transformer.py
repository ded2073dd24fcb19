"""Decoder transformer block (diffusers layout) with a snake-beta FFN.

Port of ``matcha_tpu/models/components/transformer.py`` with the
reference parameter names (``norm1``, ``attn1.to_q/to_k/to_v/to_out.0``,
``norm3``, ``ff.net.0.proj``, ``ff.net.0.alpha/beta``, ``ff.net.2``).
Attention is a plain matmul + softmax, as the JAX package writes it.
Dropout sits at the JAX package's two sites (after the feed-forward's
activation, after the attention's output projection), in the reference's
parameter-free slots ``ff.net.1`` and ``attn1.to_out.1``, and is active
only in ``train()`` mode.

``mask_mode="additive_reference"`` (default) ADDS the 0/1 key mask to the
scores, the reference/diffusers behaviour converted checkpoints were
trained under; ``"proper"`` gives padded keys -1e9.
"""

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn


class SnakeBeta(nn.Module):
    """Projection + snake-beta activation with log-scale alpha/beta."""

    def __init__(self, in_features: int, out_features: int):
        super().__init__()
        self.proj = nn.Linear(in_features, out_features)
        self.alpha = nn.Parameter(torch.zeros(out_features))
        self.beta = nn.Parameter(torch.zeros(out_features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.proj(x)
        a = torch.exp(self.alpha)
        b = torch.exp(self.beta)
        return x + (1.0 / (b + 1e-9)) * torch.sin(x * a) ** 2


class GELU(nn.Module):
    def __init__(self, in_features: int, out_features: int, approximate: bool = False):
        super().__init__()
        self.proj = nn.Linear(in_features, out_features)
        self.approximate = "tanh" if approximate else "none"

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.gelu(self.proj(x), approximate=self.approximate)


class GEGLU(nn.Module):
    def __init__(self, in_features: int, out_features: int):
        super().__init__()
        self.proj = nn.Linear(in_features, out_features * 2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h, gate = self.proj(x).chunk(2, dim=-1)
        return h * F.gelu(gate)


class FeedForward(nn.Module):
    """``net`` = [activation with its projection, dropout, Linear]."""

    def __init__(self, dim: int, mult: int = 4, activation_fn: str = "snakebeta",
                 dropout: float = 0.0):
        super().__init__()
        inner = dim * mult
        if activation_fn == "snakebeta":
            act = SnakeBeta(dim, inner)
        elif activation_fn == "gelu":
            act = GELU(dim, inner)
        elif activation_fn == "gelu-approximate":
            act = GELU(dim, inner, approximate=True)
        elif activation_fn == "geglu":
            act = GEGLU(dim, inner)
        else:
            raise ValueError(f"Unknown activation_fn {activation_fn!r}")
        self.net = nn.ModuleList([act, nn.Dropout(dropout), nn.Linear(inner, dim)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for layer in self.net:
            x = layer(x)
        return x


class Attention(nn.Module):
    """q/k/v without bias, output projection with bias, scale
    1/sqrt(head_dim), mask per ``mask_mode`` (see module doc)."""

    def __init__(self, query_dim: int, heads: int, dim_head: int,
                 mask_mode: str = "additive_reference", dropout: float = 0.0):
        super().__init__()
        if mask_mode not in ("additive_reference", "proper"):
            raise ValueError(f"Unknown mask_mode {mask_mode!r}")
        inner = heads * dim_head
        self.heads, self.dim_head, self.mask_mode = heads, dim_head, mask_mode
        self.to_q = nn.Linear(query_dim, inner, bias=False)
        self.to_k = nn.Linear(query_dim, inner, bias=False)
        self.to_v = nn.Linear(query_dim, inner, bias=False)
        self.to_out = nn.ModuleList([nn.Linear(inner, query_dim), nn.Dropout(dropout)])

    def forward(self, x: torch.Tensor,
                attention_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        B, T, _ = x.shape

        def split(t):  # the heads this rank holds (all without tensor parallelism)
            return t.reshape(B, T, -1, self.dim_head).transpose(1, 2)

        q, k, v = split(self.to_q(x)), split(self.to_k(x)), split(self.to_v(x))
        scores = torch.matmul(q, k.transpose(-1, -2)) / math.sqrt(self.dim_head)
        if attention_mask is not None:
            key_mask = attention_mask[:, None, None, :]
            if self.mask_mode == "proper":
                scores = scores.masked_fill(key_mask == 0, -1e9)
            else:
                scores = scores + key_mask
        probs = torch.softmax(scores, dim=-1)
        out = torch.matmul(probs, v).transpose(1, 2).reshape(B, T, -1)
        return self.to_out[1](self.to_out[0](out))


class BasicTransformerBlock(nn.Module):
    """Pre-norm self-attention + feed-forward, each with a residual."""

    def __init__(self, dim: int, num_attention_heads: int, attention_head_dim: int,
                 activation_fn: str = "snakebeta", mask_mode: str = "additive_reference",
                 dropout: float = 0.0):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=1e-5)
        self.attn1 = Attention(dim, num_attention_heads, attention_head_dim, mask_mode, dropout)
        self.norm3 = nn.LayerNorm(dim, eps=1e-5)
        self.ff = FeedForward(dim, activation_fn=activation_fn, dropout=dropout)

    def forward(self, hidden_states: torch.Tensor,
                attention_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        hidden_states = self.attn1(self.norm1(hidden_states), attention_mask) + hidden_states
        return self.ff(self.norm3(hidden_states)) + hidden_states
