"""CFM estimator: 1-D U-Net over mel frames with transformer or conformer
blocks.

Port of ``matcha_tpu/models/components/decoder.py`` with the reference
module tree: ``down_blocks.i`` = [ResnetBlock1D, [blocks...],
downsample], ``mid_blocks.i`` = [ResnetBlock1D, [blocks]],
``up_blocks.i`` = [ResnetBlock1D, [blocks], upsample], ``final_block``,
``final_proj``; the blocks of each stage (down, mid, up) are
``BasicTransformerBlock``s or ``ConformerBlock``s. The input is
concat(x, mu[, the speaker embedding tiled over time]) along channels.
The public ``forward`` takes and returns (B, T, C); the convolutional
parts run channels-first internally. GroupNorm statistics run over the
full padded length, as in the reference.
"""

from typing import Optional, Tuple

import torch
from torch import nn

from matcha_tpu_torch.models.components.common import (
    SinusoidalPosEmb,
    TimestepEmbedding,
    mish,
)
from matcha_tpu_torch.models.components.conformer import ConformerBlock
from matcha_tpu_torch.models.components.transformer import BasicTransformerBlock


class Block1D(nn.Module):
    """(B, C, T): conv k3 -> GroupNorm -> mish, masked."""

    def __init__(self, dim: int, dim_out: int, groups: int = 8):
        super().__init__()
        self.block = nn.Sequential(
            nn.Conv1d(dim, dim_out, 3, padding=1),
            nn.GroupNorm(groups, dim_out, eps=1e-5),
        )

    def forward(self, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        return mish(self.block(x * mask)) * mask


class ResnetBlock1D(nn.Module):
    """(B, C, T) two Block1Ds conditioned on the time embedding, plus a
    1x1 residual projection."""

    def __init__(self, dim: int, dim_out: int, time_emb_dim: int, groups: int = 8):
        super().__init__()
        self.mlp = nn.Sequential(nn.Mish(), nn.Linear(time_emb_dim, dim_out))
        self.block1 = Block1D(dim, dim_out, groups)
        self.block2 = Block1D(dim_out, dim_out, groups)
        self.res_conv = nn.Conv1d(dim, dim_out, 1)

    def forward(self, x: torch.Tensor, mask: torch.Tensor, time_emb: torch.Tensor) -> torch.Tensor:
        h = self.block1(x, mask)
        h = h + self.mlp(time_emb)[:, :, None]
        h = self.block2(h, mask)
        return h + self.res_conv(x * mask)


class Downsample1D(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.conv = nn.Conv1d(dim, dim, 3, stride=2, padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(x)


class Upsample1D(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.conv = nn.ConvTranspose1d(dim, dim, 4, stride=2, padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(x)


class Decoder(nn.Module):
    """U-Net vector-field estimator for conditional flow matching."""

    def __init__(self, in_channels: int, out_channels: int,
                 channels: Tuple[int, ...] = (256, 256), attention_head_dim: int = 64,
                 n_blocks: int = 1, num_mid_blocks: int = 2, num_heads: int = 4,
                 act_fn: str = "snakebeta", mask_mode: str = "additive_reference",
                 dropout: float = 0.05, down_block_type: str = "transformer",
                 mid_block_type: str = "transformer", up_block_type: str = "transformer",
                 conformer_batch_norm: bool = False):
        super().__init__()
        channels = tuple(channels)
        time_embed_dim = channels[0] * 4
        self.time_embeddings = SinusoidalPosEmb(in_channels)
        self.time_mlp = TimestepEmbedding(in_channels, time_embed_dim)

        def block(dim, block_type):
            if block_type == "transformer":
                return BasicTransformerBlock(dim, num_heads, attention_head_dim, act_fn,
                                             mask_mode, dropout)
            if block_type == "conformer":
                return ConformerBlock(dim, heads=num_heads, dim_head=attention_head_dim,
                                      attn_dropout=dropout, ff_dropout=dropout,
                                      conv_dropout=dropout, use_batch_norm=conformer_batch_norm)
            raise ValueError(f"Unknown block type {block_type!r}")

        def tblocks(dim, block_type):
            return nn.ModuleList(block(dim, block_type) for _ in range(n_blocks))

        self.down_blocks = nn.ModuleList()
        dim_in = in_channels
        for i, ch in enumerate(channels):
            is_last = i == len(channels) - 1
            down = nn.Conv1d(ch, ch, 3, padding=1) if is_last else Downsample1D(ch)
            self.down_blocks.append(nn.ModuleList(
                [ResnetBlock1D(dim_in, ch, time_embed_dim), tblocks(ch, down_block_type), down]))
            dim_in = ch

        self.mid_blocks = nn.ModuleList(
            nn.ModuleList([ResnetBlock1D(channels[-1], channels[-1], time_embed_dim),
                           tblocks(channels[-1], mid_block_type)])
            for _ in range(num_mid_blocks))

        up_channels = channels[::-1] + (channels[0],)
        self.up_blocks = nn.ModuleList()
        for i in range(len(up_channels) - 1):
            ch = up_channels[i + 1]
            is_last = i == len(up_channels) - 2
            up = nn.Conv1d(ch, ch, 3, padding=1) if is_last else Upsample1D(ch)
            self.up_blocks.append(nn.ModuleList(
                [ResnetBlock1D(2 * up_channels[i], ch, time_embed_dim), tblocks(ch, up_block_type),
                 up]))

        self.final_block = Block1D(up_channels[-1], up_channels[-1])
        self.final_proj = nn.Conv1d(up_channels[-1], out_channels, 1)

    @staticmethod
    def _transformers(blocks, h, mask):
        """Run (B, T, C) transformer or conformer blocks on a (B, C, T)
        tensor."""
        h = h.transpose(1, 2)
        for block in blocks:
            h = block(h, mask[:, 0, :])
        return h.transpose(1, 2)

    def forward(self, x: torch.Tensor, mask: torch.Tensor, mu: torch.Tensor,
                t: torch.Tensor, spks: Optional[torch.Tensor] = None) -> torch.Tensor:
        """x, mu: (B, T, n_feats); mask: (B, T, 1); t: (B,) or scalar flow
        time; spks: (B, spk_emb_dim) speaker embeddings or None. Returns
        the (B, T, out_channels) vector field, masked."""
        if t.dim() == 0:
            t = t.expand(x.shape[0])
        # the sinusoidal embedding is f32; its MLP's output takes the
        # activations' type, so that a bf16 flow stays bf16
        temb = self.time_mlp(self.time_embeddings(t)).to(x.dtype)

        h = torch.cat([x, mu], dim=-1)
        if spks is not None:
            h = torch.cat([h, spks[:, None, :].expand(-1, h.shape[1], -1)], dim=-1)
        h = h.transpose(1, 2)
        mask_cf = mask.transpose(1, 2)  # (B, 1, T)

        hiddens = []
        masks = [mask_cf]
        for resnet, blocks, down in self.down_blocks:
            mask_down = masks[-1]
            h = resnet(h, mask_down, temb)
            h = self._transformers(blocks, h, mask_down)
            hiddens.append(h)
            h = down(h * mask_down)
            masks.append(mask_down[:, :, ::2])

        masks = masks[:-1]
        mask_mid = masks[-1]
        for resnet, blocks in self.mid_blocks:
            h = resnet(h, mask_mid, temb)
            h = self._transformers(blocks, h, mask_mid)

        for resnet, blocks, up in self.up_blocks:
            mask_up = masks.pop()
            h = resnet(torch.cat([h, hiddens.pop()], dim=1), mask_up, temb)
            h = self._transformers(blocks, h, mask_up)
            h = up(h * mask_up)

        h = self.final_block(h, mask_up)
        out = self.final_proj(h * mask_up)
        return (out * mask_cf).transpose(1, 2)
