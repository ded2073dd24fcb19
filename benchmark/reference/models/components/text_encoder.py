"""Text encoder: conv prenet + RoPE transformer + duration predictor.

The port of ``matcha_tpu/models/components/text_encoder.py`` with the
reference module names (``emb``, ``prenet``, ``encoder``, ``proj_m``,
``proj_w``). A multi-speaker encoder tiles the speaker embedding over
time and concatenates it after the prenet, so the transformer stack, the
duration predictor and ``proj_m`` run ``n_channels + spk_emb_dim`` wide.
Tensors are (B, T, C); masks are (B, T, 1) floats. Dropout
sits where the JAX package has it (attention probabilities, FFN hidden,
both residual branches, prenet, duration predictor) and is active only
in ``train()`` mode.
"""

import math
from typing import Optional

import torch
from torch import nn

from benchmark.reference.models.components.common import (
    ChannelLayerNorm,
    Conv1d,
    PointwiseConv1d,
)


def apply_rope(x: torch.Tensor, d_rope: int, base: float = 10_000.0) -> torch.Tensor:
    """Rotary position embedding on the first ``d_rope`` dims of a
    (B, H, T, D) tensor, "rotate-half" pairing: dims [0, d/2) pair with
    [d/2, d)."""
    T = x.shape[2]
    x_rope, x_pass = x[..., :d_rope], x[..., d_rope:]
    half = d_rope // 2
    theta = base ** (-torch.arange(0, half, dtype=torch.float32, device=x.device) / half)
    pos = torch.arange(T, dtype=torch.float32, device=x.device)
    angles = pos[:, None] * theta[None, :]
    cos = torch.cat([torch.cos(angles), torch.cos(angles)], dim=-1)
    sin = torch.cat([torch.sin(angles), torch.sin(angles)], dim=-1)
    neg_half = torch.cat([-x_rope[..., half:], x_rope[..., :half]], dim=-1)
    x_rope = x_rope * cos + neg_half * sin
    return torch.cat([x_rope, x_pass], dim=-1)


class MultiHeadAttention(nn.Module):
    """Self-attention with RoPE on half the head dims; padded keys get
    -1e4."""

    def __init__(self, channels: int, out_channels: int, n_heads: int,
                 p_dropout: float = 0.0):
        super().__init__()
        self.channels = channels
        self.n_heads = n_heads
        self.k_channels = channels // n_heads
        self.conv_q = PointwiseConv1d(channels, channels)
        self.conv_k = PointwiseConv1d(channels, channels)
        self.conv_v = PointwiseConv1d(channels, channels)
        self.conv_o = PointwiseConv1d(channels, out_channels)
        self.drop = nn.Dropout(p_dropout)

    def forward(self, x: torch.Tensor, attn_mask: torch.Tensor) -> torch.Tensor:
        B, T, _ = x.shape

        def split_heads(t):  # the heads this rank holds (all without tensor parallelism)
            return t.reshape(B, T, -1, self.k_channels).transpose(1, 2)

        q = split_heads(self.conv_q(x))
        k = split_heads(self.conv_k(x))
        v = split_heads(self.conv_v(x))
        d_rope = int(self.k_channels * 0.5)
        q = apply_rope(q, d_rope)
        k = apply_rope(k, d_rope)

        scores = torch.matmul(q, k.transpose(-1, -2)) / math.sqrt(self.k_channels)
        scores = scores.masked_fill(attn_mask == 0, -1e4)
        probs = self.drop(torch.softmax(scores, dim=-1))
        out = torch.matmul(probs, v).transpose(1, 2).reshape(B, T, -1)
        return self.conv_o(out)


class FFN(nn.Module):
    """Conv feed-forward with masking between the convs."""

    def __init__(self, in_channels: int, out_channels: int, filter_channels: int,
                 kernel_size: int, p_dropout: float = 0.0):
        super().__init__()
        self.conv_1 = Conv1d(in_channels, filter_channels, kernel_size,
                             padding=kernel_size // 2)
        self.conv_2 = Conv1d(filter_channels, out_channels, kernel_size,
                             padding=kernel_size // 2)
        self.drop = nn.Dropout(p_dropout)

    def forward(self, x: torch.Tensor, x_mask: torch.Tensor) -> torch.Tensor:
        x = self.drop(torch.relu(self.conv_1(x * x_mask)))
        x = self.conv_2(x * x_mask)
        return x * x_mask


class Encoder(nn.Module):
    """Stack of post-norm attention + conv-FFN layers."""

    def __init__(self, hidden_channels: int, filter_channels: int, n_heads: int,
                 n_layers: int, kernel_size: int = 1, p_dropout: float = 0.0):
        super().__init__()
        self.drop = nn.Dropout(p_dropout)
        self.attn_layers = nn.ModuleList(
            MultiHeadAttention(hidden_channels, hidden_channels, n_heads, p_dropout)
            for _ in range(n_layers))
        self.norm_layers_1 = nn.ModuleList(
            ChannelLayerNorm(hidden_channels) for _ in range(n_layers))
        self.ffn_layers = nn.ModuleList(
            FFN(hidden_channels, hidden_channels, filter_channels, kernel_size, p_dropout)
            for _ in range(n_layers))
        self.norm_layers_2 = nn.ModuleList(
            ChannelLayerNorm(hidden_channels) for _ in range(n_layers))

    def forward(self, x: torch.Tensor, x_mask: torch.Tensor) -> torch.Tensor:
        attn_mask = x_mask[:, None, None, :, 0]  # (B, 1, 1, T) key mask
        for attn, norm1, ffn, norm2 in zip(self.attn_layers, self.norm_layers_1,
                                           self.ffn_layers, self.norm_layers_2):
            x = x * x_mask
            x = norm1(x + self.drop(attn(x, attn_mask)))
            x = norm2(x + self.drop(ffn(x, x_mask)))
        return x * x_mask


class ConvReluNorm(nn.Module):
    """Residual conv prenet (n_layers x conv + channel LN + relu)."""

    def __init__(self, in_channels: int, hidden_channels: int, out_channels: int,
                 kernel_size: int, n_layers: int, p_dropout: float = 0.0):
        super().__init__()
        self.drop = nn.Dropout(p_dropout)
        self.conv_layers = nn.ModuleList(
            Conv1d(in_channels if i == 0 else hidden_channels, hidden_channels,
                   kernel_size, padding=kernel_size // 2)
            for i in range(n_layers))
        self.norm_layers = nn.ModuleList(
            ChannelLayerNorm(hidden_channels) for _ in range(n_layers))
        self.proj = PointwiseConv1d(hidden_channels, out_channels)

    def forward(self, x: torch.Tensor, x_mask: torch.Tensor) -> torch.Tensor:
        x_org = x
        for conv, norm in zip(self.conv_layers, self.norm_layers):
            x = self.drop(torch.relu(norm(conv(x * x_mask))))
        return (x_org + self.proj(x)) * x_mask


class DurationPredictor(nn.Module):
    """Two masked convs + channel LN -> one log-duration per token."""

    def __init__(self, in_channels: int, filter_channels: int, kernel_size: int,
                 p_dropout: float = 0.0):
        super().__init__()
        self.drop = nn.Dropout(p_dropout)
        self.conv_1 = Conv1d(in_channels, filter_channels, kernel_size,
                             padding=kernel_size // 2)
        self.norm_1 = ChannelLayerNorm(filter_channels)
        self.conv_2 = Conv1d(filter_channels, filter_channels, kernel_size,
                             padding=kernel_size // 2)
        self.norm_2 = ChannelLayerNorm(filter_channels)
        self.proj = PointwiseConv1d(filter_channels, 1)

    def forward(self, x: torch.Tensor, x_mask: torch.Tensor) -> torch.Tensor:
        x = self.drop(self.norm_1(torch.relu(self.conv_1(x * x_mask))))
        x = self.drop(self.norm_2(torch.relu(self.conv_2(x * x_mask))))
        return self.proj(x * x_mask) * x_mask


class TextEncoder(nn.Module):
    """Phoneme ids (B, T) -> mu (B, T, n_feats), logw (B, T, 1), masked."""

    def __init__(self, n_vocab: int, n_feats: int, n_channels: int = 192,
                 filter_channels: int = 768, filter_channels_dp: int = 256,
                 n_heads: int = 2, n_layers: int = 6, kernel_size: int = 3,
                 prenet: bool = True, dp_kernel_size: int = 3, p_dropout: float = 0.1,
                 n_spks: int = 1, spk_emb_dim: int = 64):
        super().__init__()
        self.n_channels = n_channels
        self.n_spks = n_spks
        width = n_channels + (spk_emb_dim if n_spks > 1 else 0)
        self.emb = nn.Embedding(n_vocab, n_channels)
        self.prenet = (ConvReluNorm(n_channels, n_channels, n_channels, kernel_size=5,
                                    n_layers=3, p_dropout=0.5) if prenet else None)
        self.encoder = Encoder(width, filter_channels, n_heads, n_layers, kernel_size, p_dropout)
        self.proj_m = PointwiseConv1d(width, n_feats)
        self.proj_w = DurationPredictor(width, filter_channels_dp, dp_kernel_size, p_dropout)

    def forward(self, x: torch.Tensor, x_mask: torch.Tensor,
                spks: Optional[torch.Tensor] = None):
        """``spks``: (B, spk_emb_dim) speaker embeddings, which a
        multi-speaker encoder needs and a single-speaker one ignores."""
        h = self.emb(x) * math.sqrt(self.n_channels)
        if self.prenet is not None:
            h = self.prenet(h, x_mask)
        if self.n_spks > 1:
            if spks is None:
                raise ValueError(f"a {self.n_spks}-speaker encoder needs speaker embeddings")
            h = torch.cat([h, spks[:, None, :].expand(-1, h.shape[1], -1)], dim=-1)
        h = self.encoder(h, x_mask)
        mu = self.proj_m(h) * x_mask
        # the duration predictor sees a detached copy: the duration loss
        # trains only the predictor, never the encoder
        logw = self.proj_w(h.detach(), x_mask)
        return mu, logw
