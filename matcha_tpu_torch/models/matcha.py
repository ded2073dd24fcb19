"""MatchaTTS: encoder + duration expansion + OT-CFM decoding, and the
three training losses.

Port of ``matcha_tpu/models/matcha.py`` (``encode``, ``decode``,
``synthesise`` and ``losses``; single speaker). Inference runs under
``torch.inference_mode``; ``losses`` builds the autograd graph and runs
MAS through ``ops/mas.py`` (the CUDA kernel on a card). Module names follow the reference, so a
reference ``state_dict`` (``encoder.*``, ``decoder.estimator.*``,
``mel_mean``, ``mel_std``) loads with ``load_state_dict``. Inputs and the
returned dict keep the JAX package's layouts: ids (B, T_x), mels
(B, n_feats, T) at the boundary.
"""

import math
from typing import Dict, Optional

import torch
from torch import nn

from matcha_tpu_torch.models.components.decoder import Decoder
from matcha_tpu_torch.models.components.flow_matching import CFM
from matcha_tpu_torch.models.components.text_encoder import TextEncoder
from matcha_tpu_torch.ops.mas import maximum_path
from matcha_tpu_torch.ops.seq import denormalize, duration_loss, generate_path, sequence_mask

LOG_2PI = math.log(2 * math.pi)


class MatchaTTS(nn.Module):
    """Defaults are the LJSpeech Matcha configuration."""

    def __init__(self, n_vocab: int = 178, n_spks: int = 1, spk_emb_dim: int = 64,
                 n_feats: int = 80, enc_n_channels: int = 192,
                 enc_filter_channels: int = 768, enc_filter_channels_dp: int = 256,
                 enc_n_heads: int = 2, enc_n_layers: int = 6, enc_kernel_size: int = 3,
                 enc_p_dropout: float = 0.1, enc_prenet: bool = True, dp_kernel_size: int = 3,
                 dec_channels: tuple = (256, 256), dec_dropout: float = 0.05,
                 dec_attention_head_dim: int = 64,
                 dec_n_blocks: int = 1, dec_num_mid_blocks: int = 2, dec_num_heads: int = 2,
                 dec_act_fn: str = "snakebeta", dec_mask_mode: str = "additive_reference",
                 sigma_min: float = 1e-4, prior_loss: bool = True,
                 mel_mean: float = 0.0, mel_std: float = 1.0):
        super().__init__()
        if n_spks > 1:
            raise NotImplementedError("the port runs single-speaker models only")
        self.n_feats = n_feats
        self.prior_loss = prior_loss
        self.encoder = TextEncoder(
            n_vocab, n_feats, enc_n_channels, enc_filter_channels, enc_filter_channels_dp,
            enc_n_heads, enc_n_layers, enc_kernel_size, enc_prenet, dp_kernel_size,
            enc_p_dropout)
        self.decoder = CFM(Decoder(
            2 * n_feats, n_feats, tuple(dec_channels), dec_attention_head_dim,
            dec_n_blocks, dec_num_mid_blocks, dec_num_heads, dec_act_fn, dec_mask_mode,
            dec_dropout), sigma_min)
        self.register_buffer("mel_mean", torch.tensor(float(mel_mean)))
        self.register_buffer("mel_std", torch.tensor(float(mel_std)))

    @torch.inference_mode()
    def encode(self, x: torch.Tensor, x_lengths: torch.Tensor, length_scale: float = 1.0):
        """ids (B, T_x) -> (mu_x (B, T_x, n_feats), w_ceil (B, T_x, 1),
        y_lengths (B,) int32)."""
        x_mask = sequence_mask(x_lengths, x.shape[1]).float()[..., None]
        mu_x, logw = self.encoder(x, x_mask)
        # clamp so untrained weights cannot overflow the length math
        w = torch.exp(torch.clamp(logw, max=11.0)) * x_mask
        w_ceil = torch.ceil(w) * length_scale
        y_lengths = torch.clamp(w_ceil.sum(dim=(1, 2)), 1.0, 2.0**30).to(torch.int32)
        return mu_x, w_ceil, y_lengths

    @torch.inference_mode()
    def decode(self, mu_x: torch.Tensor, w_ceil: torch.Tensor, x_lengths: torch.Tensor,
               y_lengths: torch.Tensor, n_timesteps: int = 10, temperature: float = 1.0,
               y_max_length: int = 1024, z: Optional[torch.Tensor] = None,
               generator: Optional[torch.Generator] = None) -> Dict[str, torch.Tensor]:
        """Expand durations to ``y_max_length`` frames and sample the flow.
        ``z``: unit-normal noise (B, y_max_length, n_feats), else drawn
        from ``generator``."""
        x_mask = sequence_mask(x_lengths, mu_x.shape[1]).float()[..., None]
        y_lengths = torch.clamp(y_lengths, max=y_max_length).to(torch.int32)
        y_mask = sequence_mask(y_lengths, y_max_length).float()[..., None]
        attn_mask = x_mask[:, :, 0][:, :, None] * y_mask[:, :, 0][:, None, :]
        attn = generate_path(w_ceil[:, :, 0], attn_mask)
        mu_y = torch.einsum("bxy,bxf->byf", attn, mu_x)
        decoder_outputs = self.decoder(mu_y, y_mask, n_timesteps, temperature, z, generator)
        mel = denormalize(decoder_outputs.transpose(1, 2), self.mel_mean, self.mel_std)
        return {
            "encoder_outputs": mu_y.transpose(1, 2),
            "decoder_outputs": decoder_outputs.transpose(1, 2),
            "attn": attn,
            "mel": mel,
            "mel_lengths": y_lengths,
        }

    @torch.inference_mode()
    def synthesise(self, x: torch.Tensor, x_lengths: torch.Tensor, n_timesteps: int = 10,
                   temperature: float = 1.0, length_scale: float = 1.0,
                   y_max_length: int = 1024, z: Optional[torch.Tensor] = None,
                   generator: Optional[torch.Generator] = None) -> Dict[str, torch.Tensor]:
        """ids -> mel in one call at a fixed mel bucket ``y_max_length``
        (multiple of 4); lengths beyond it are clipped."""
        mu_x, w_ceil, y_lengths = self.encode(x, x_lengths, length_scale)
        return self.decode(mu_x, w_ceil, x_lengths, y_lengths, n_timesteps, temperature,
                           y_max_length, z, generator)

    def losses(self, x: torch.Tensor, x_lengths: torch.Tensor, y: torch.Tensor,
               y_lengths: torch.Tensor, out_size: Optional[int] = None,
               durations: Optional[torch.Tensor] = None, t: Optional[torch.Tensor] = None,
               z: Optional[torch.Tensor] = None, offsets: Optional[torch.Tensor] = None,
               generator: Optional[torch.Generator] = None):
        """(dur_loss, prior_loss, diff_loss, attn) of one batch.

        x (B, T_x) ids; y (B, T_y, n_feats) normalised mels; lengths (B,).
        ``out_size``: segment length (multiple of 4) cut at per-row
        ``offsets`` in [0, max(y_length - out_size, 1)), or None.
        ``durations`` (B, T_x): per-token frame counts that replace MAS.
        ``t`` (B,), ``z`` (like the cut y) and ``offsets`` (B,) are the
        noise, drawn from ``generator`` when not given. attn is (B, T_x,
        T_y), or (B, T_x, out_size) after the cut. Lengths stay on the
        device: nothing here waits for the card.
        """
        T_x, T_y = x.shape[1], y.shape[1]
        x_mask = sequence_mask(x_lengths, T_x).float()[..., None]
        y_mask = sequence_mask(y_lengths, T_y).float()[..., None]
        mu_x, logw = self.encoder(x, x_mask)

        attn_mask = x_mask[:, :, 0][:, :, None] * y_mask[:, :, 0][:, None, :]
        if durations is not None:
            attn = generate_path(durations.float() * x_mask[:, :, 0], attn_mask)
        else:
            # Gaussian log-prior of every (token, frame) pair; no gradient
            # flows through the search
            mu_sg = mu_x.detach()
            log_prior = (torch.einsum("bxf,byf->bxy", mu_sg, y)
                         - 0.5 * torch.sum(y ** 2, dim=-1)[:, None, :]
                         - 0.5 * torch.sum(mu_sg ** 2, dim=-1)[:, :, None]
                         + (-0.5 * LOG_2PI * self.n_feats))
            attn = maximum_path(log_prior, attn_mask)

        logw_ = torch.log(1e-8 + torch.sum(attn, dim=-1))[..., None] * x_mask
        dur_loss = duration_loss(logw, logw_, x_lengths)

        if out_size is not None and out_size < T_y:
            if offsets is None:
                high = torch.clamp(y_lengths - out_size, min=1).to(y.dtype)
                u = torch.rand(y.shape[0], generator=generator, device=y.device)
                offsets = torch.minimum(torch.floor(u * high), high - 1)
            offsets = torch.clamp(offsets.to(device=y.device, dtype=torch.long),
                                  0, T_y - out_size)
            frames = offsets[:, None] + torch.arange(out_size, device=y.device)[None, :]
            y = torch.gather(y, 1, frames[:, :, None].expand(-1, -1, y.shape[2]))
            attn = torch.gather(attn, 2, frames[:, None, :].expand(-1, T_x, -1))
            y_mask = sequence_mask(torch.clamp(y_lengths, max=out_size), out_size).float()[..., None]

        mu_y = torch.einsum("bxy,bxf->byf", attn, mu_x)
        diff_loss = self.decoder.compute_loss(y, y_mask, mu_y, t=t, z=z, generator=generator)

        if self.prior_loss:
            prior = torch.sum(0.5 * ((y - mu_y) ** 2 + LOG_2PI) * y_mask)
            prior = prior / (torch.sum(y_mask) * self.n_feats)
        else:
            prior = torch.zeros((), device=y.device)
        return dur_loss, prior, diff_loss, attn
