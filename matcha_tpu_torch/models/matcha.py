"""MatchaTTS: encoder + duration expansion + OT-CFM decoding, and the
three training losses.

Port of ``matcha_tpu/models/matcha.py`` (``encode``, ``decode``,
``synthesise`` and ``losses``), single- and multi-speaker, with
transformer or conformer decoder blocks. Inference runs under
``torch.inference_mode``; ``losses`` builds the autograd graph and runs
MAS through ``ops/mas.py`` (the CUDA kernel on a card). Module names
follow the reference, so a reference ``state_dict`` (``encoder.*``,
``decoder.estimator.*``, ``spk_emb.weight``, ``mel_mean``, ``mel_std``)
loads with ``load_state_dict``. Inputs and the returned dict keep the
JAX package's layouts: ids (B, T_x), speaker ids (B,), mels
(B, n_feats, T) at the boundary.

A speaker id outside [0, n_spks) would fire a device-side assert in the
embedding lookup on a card, which spoils the CUDA context for every later
call (JAX's gather returns garbage instead): the entry points check ids
on the host with ``check_speakers`` before any reaches the card.
"""

import copy
import math
from typing import Dict, Optional

import numpy as np
import torch
from torch import nn

from matcha_tpu_torch.models.components.decoder import Decoder
from matcha_tpu_torch.models.components.flow_matching import CFM
from matcha_tpu_torch.models.components.text_encoder import TextEncoder
from matcha_tpu_torch.ops.mas import maximum_path
from matcha_tpu_torch.ops.seq import denormalize, duration_loss, generate_path, sequence_mask

LOG_2PI = math.log(2 * math.pi)


def segment_offsets(u: torch.Tensor, y_lengths: torch.Tensor, out_size: int,
                    dtype: torch.dtype) -> torch.Tensor:
    """Segment starts from uniform draws ``u`` (B,): floor(u * high), at
    most high - 1, with high = max(y_length - out_size, 1) in ``dtype``
    (the mel's type)."""
    high = torch.clamp(y_lengths - out_size, min=1).to(dtype)
    return torch.minimum(torch.floor(u * high), high - 1)


def check_speakers(n_spks: int, spks) -> Optional[np.ndarray]:
    """Host speaker ids (anything ``np.asarray`` takes, or None) checked
    for a model of ``n_spks`` speakers: int32 ids in [0, n_spks) for a
    multi-speaker model, which needs them; None for a single-speaker one,
    which ignores them. Raises ValueError otherwise."""
    if n_spks <= 1:
        return None
    if spks is None:
        raise ValueError(f"a {n_spks}-speaker model needs speaker ids")
    ids = np.asarray(spks)
    if ids.dtype.kind not in "iu" or ids.ndim != 1:
        raise ValueError(f"speaker ids must be a 1-D integer array, not {ids.dtype} of shape "
                         f"{ids.shape}")
    if ids.size and (ids.min() < 0 or ids.max() >= n_spks):
        raise ValueError(f"speaker id out of range: {ids.tolist()} (the model has speakers "
                         f"0..{n_spks - 1})")
    return ids.astype(np.int32)


class MatchaTTS(nn.Module):
    """Defaults are the LJSpeech Matcha configuration. ``remat``: the loss
    recomputes the CFM estimator's activations in the backward pass
    (``CFM.remat``) instead of keeping them."""

    def __init__(self, n_vocab: int = 178, n_spks: int = 1, spk_emb_dim: int = 64,
                 n_feats: int = 80, enc_n_channels: int = 192,
                 enc_filter_channels: int = 768, enc_filter_channels_dp: int = 256,
                 enc_n_heads: int = 2, enc_n_layers: int = 6, enc_kernel_size: int = 3,
                 enc_p_dropout: float = 0.1, enc_prenet: bool = True, dp_kernel_size: int = 3,
                 dec_channels: tuple = (256, 256), dec_dropout: float = 0.05,
                 dec_attention_head_dim: int = 64,
                 dec_n_blocks: int = 1, dec_num_mid_blocks: int = 2, dec_num_heads: int = 2,
                 dec_act_fn: str = "snakebeta", dec_mask_mode: str = "additive_reference",
                 dec_down_block_type: str = "transformer", dec_mid_block_type: str = "transformer",
                 dec_up_block_type: str = "transformer", dec_conformer_batch_norm: bool = False,
                 sigma_min: float = 1e-4, prior_loss: bool = True, remat: bool = False,
                 mel_mean: float = 0.0, mel_std: float = 1.0):
        super().__init__()
        self.n_spks = n_spks
        self.n_feats = n_feats
        self.prior_loss = prior_loss
        self.encoder = TextEncoder(
            n_vocab, n_feats, enc_n_channels, enc_filter_channels, enc_filter_channels_dp,
            enc_n_heads, enc_n_layers, enc_kernel_size, enc_prenet, dp_kernel_size,
            enc_p_dropout, n_spks, spk_emb_dim)
        in_channels = 2 * n_feats + (spk_emb_dim if n_spks > 1 else 0)
        self.decoder = CFM(Decoder(
            in_channels, n_feats, tuple(dec_channels), dec_attention_head_dim,
            dec_n_blocks, dec_num_mid_blocks, dec_num_heads, dec_act_fn, dec_mask_mode,
            dec_dropout, dec_down_block_type, dec_mid_block_type, dec_up_block_type,
            dec_conformer_batch_norm), sigma_min, remat)
        if n_spks > 1:
            self.spk_emb = nn.Embedding(n_spks, spk_emb_dim)
        self.register_buffer("mel_mean", torch.tensor(float(mel_mean)))
        self.register_buffer("mel_std", torch.tensor(float(mel_std)))

    def _speaker(self, spks: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
        """Speaker ids (B,) on the model's device -> embeddings (B,
        spk_emb_dim) for a multi-speaker model, None for a single-speaker
        one. The ids are not checked here (that would wait for the card):
        callers check host ids with ``check_speakers``."""
        if self.n_spks <= 1:
            return None
        if spks is None:
            raise ValueError(f"a {self.n_spks}-speaker model needs speaker ids")
        return self.spk_emb(spks.long())

    def forward(self, *args, **kwargs):
        """``losses`` (the training entry, as JAX's ``__call__``)."""
        return self.losses(*args, **kwargs)

    @torch.inference_mode()
    def encode(self, x: torch.Tensor, x_lengths: torch.Tensor, length_scale: float = 1.0,
               spks: Optional[torch.Tensor] = None):
        """ids (B, T_x) [and speaker ids (B,)] -> (mu_x (B, T_x, n_feats),
        w_ceil (B, T_x, 1), y_lengths (B,) int32)."""
        x_mask = sequence_mask(x_lengths, x.shape[1]).float()[..., None]
        mu_x, logw = self.encoder(x, x_mask, self._speaker(spks))
        # clamp so untrained weights cannot overflow the length math
        w = torch.exp(torch.clamp(logw, max=11.0)) * x_mask
        w_ceil = torch.ceil(w) * length_scale
        y_lengths = torch.clamp(w_ceil.sum(dim=(1, 2)), 1.0, 2.0**30).to(torch.int32)
        return mu_x, w_ceil, y_lengths

    @torch.inference_mode()
    def decode(self, mu_x: torch.Tensor, w_ceil: torch.Tensor, x_lengths: torch.Tensor,
               y_lengths: torch.Tensor, n_timesteps: int = 10, temperature: float = 1.0,
               y_max_length: int = 1024, z: Optional[torch.Tensor] = None,
               generator: Optional[torch.Generator] = None,
               compute_dtype: Optional[torch.dtype] = None,
               spks: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
        """:meth:`decode_body` under ``torch.inference_mode``."""
        return self.decode_body(mu_x, w_ceil, x_lengths, y_lengths, n_timesteps, temperature,
                                y_max_length, z, generator, compute_dtype, spks)

    def decode_body(self, mu_x: torch.Tensor, w_ceil: torch.Tensor, x_lengths: torch.Tensor,
                    y_lengths: torch.Tensor, n_timesteps: int = 10, temperature=1.0,
                    y_max_length: int = 1024, z: Optional[torch.Tensor] = None,
                    generator: Optional[torch.Generator] = None,
                    compute_dtype: Optional[torch.dtype] = None,
                    spks: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
        """Expand durations to ``y_max_length`` frames and sample the flow,
        under the caller's autograd mode (``torch.export`` traces it so).
        ``temperature``: a float or a 0-d tensor.
        ``z``: unit-normal noise (B, y_max_length, n_feats), else drawn
        from ``generator``. ``spks``: speaker ids (B,) of a multi-speaker
        model.

        ``compute_dtype`` (e.g. ``torch.bfloat16``) runs the Euler loop in
        that type: ``mu_y``, the mask and the speaker embeddings are cast
        to it, and the decoder's parameters must be of it
        (``decoder_cast``). The durations and the alignment stay f32 (bf16
        cannot count frames above 256), and the mel comes back f32.

        It is :meth:`align` then :meth:`flow`."""
        attn, mu_y, y_mask, y_lengths = self.align(mu_x, w_ceil, x_lengths, y_lengths,
                                                   y_max_length)
        decoder_outputs, mel = self.flow(mu_y, y_mask, n_timesteps, temperature, z, generator,
                                         self._speaker(spks), compute_dtype)
        return {
            "encoder_outputs": mu_y.transpose(1, 2),
            "decoder_outputs": decoder_outputs,
            "attn": attn,
            "mel": mel,
            "mel_lengths": y_lengths,
        }

    def align(self, mu_x: torch.Tensor, w_ceil: torch.Tensor, x_lengths: torch.Tensor,
              y_lengths: torch.Tensor, y_max_length: int):
        """The duration expansion of :meth:`decode_body`: -> (attn (B, T_x,
        y_max_length), mu_y (B, y_max_length, n_feats), y_mask
        (B, y_max_length, 1), y_lengths clipped to ``y_max_length``, int32)."""
        x_mask = sequence_mask(x_lengths, mu_x.shape[1]).float()[..., None]
        y_lengths = torch.clamp(y_lengths, max=y_max_length).to(torch.int32)
        y_mask = sequence_mask(y_lengths, y_max_length).float()[..., None]
        attn_mask = x_mask[:, :, 0][:, :, None] * y_mask[:, :, 0][:, None, :]
        attn = generate_path(w_ceil[:, :, 0], attn_mask)
        mu_y = torch.einsum("bxy,bxf->byf", attn, mu_x)
        return attn, mu_y, y_mask, y_lengths

    def flow(self, mu_y: torch.Tensor, y_mask: torch.Tensor, n_timesteps: int = 10,
             temperature=1.0, z: Optional[torch.Tensor] = None,
             generator: Optional[torch.Generator] = None,
             spk_emb: Optional[torch.Tensor] = None,
             compute_dtype: Optional[torch.dtype] = None):
        """The CFM sampling of :meth:`decode_body` from the expanded
        ``mu_y`` and its mask, and the denormalisation: -> (decoder_outputs,
        mel), both (B, n_feats, T_y) f32. ``spk_emb`` (B, spk_emb_dim) or
        None; the other arguments as for :meth:`decode_body`."""
        if compute_dtype is None:
            decoder_outputs = self.decoder(mu_y, y_mask, n_timesteps, temperature, z, generator,
                                           spk_emb)
        else:
            held = {p.dtype for p in self.decoder.parameters()}
            if held != {compute_dtype}:
                raise ValueError(f"compute_dtype={compute_dtype} needs a decoder of that type "
                                 f"(decoder_cast), not one of {held}")
            decoder_outputs = self.decoder(
                mu_y.to(compute_dtype), y_mask.to(compute_dtype), n_timesteps, temperature, z,
                generator, None if spk_emb is None else spk_emb.to(compute_dtype)).float()
        mel = denormalize(decoder_outputs.transpose(1, 2), self.mel_mean, self.mel_std)
        return decoder_outputs.transpose(1, 2), mel

    @torch.inference_mode()
    def synthesise(self, x: torch.Tensor, x_lengths: torch.Tensor, n_timesteps: int = 10,
                   temperature: float = 1.0, length_scale: float = 1.0,
                   y_max_length: int = 1024, z: Optional[torch.Tensor] = None,
                   generator: Optional[torch.Generator] = None,
                   compute_dtype: Optional[torch.dtype] = None,
                   spks: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
        """ids [and speaker ids] -> mel in one call at a fixed mel bucket
        ``y_max_length`` (multiple of 4); lengths beyond it are clipped.
        ``compute_dtype`` as for ``decode``: the encoder and the durations
        stay f32."""
        mu_x, w_ceil, y_lengths = self.encode(x, x_lengths, length_scale, spks)
        return self.decode(mu_x, w_ceil, x_lengths, y_lengths, n_timesteps, temperature,
                           y_max_length, z, generator, compute_dtype, spks)

    def losses(self, x: torch.Tensor, x_lengths: torch.Tensor, y: torch.Tensor,
               y_lengths: torch.Tensor, out_size: Optional[int] = None,
               durations: Optional[torch.Tensor] = None, t: Optional[torch.Tensor] = None,
               z: Optional[torch.Tensor] = None, offsets: Optional[torch.Tensor] = None,
               generator: Optional[torch.Generator] = None,
               spks: Optional[torch.Tensor] = None):
        """(dur_loss, prior_loss, diff_loss, attn) of one batch.

        x (B, T_x) ids; y (B, T_y, n_feats) normalised mels; lengths (B,).
        ``out_size``: segment length (multiple of 4) cut at per-row
        ``offsets`` in [0, max(y_length - out_size, 1)), or None.
        ``durations`` (B, T_x): per-token frame counts that replace MAS.
        ``t`` (B,), ``z`` (like the cut y) and ``offsets`` (B,) are the
        noise, drawn from ``generator`` when not given. ``spks``: speaker
        ids (B,) of a multi-speaker model. attn is (B, T_x, T_y), or (B,
        T_x, out_size) after the cut. Lengths stay on the device: nothing
        here waits for the card.
        """
        spk_emb = self._speaker(spks)
        T_x, T_y = x.shape[1], y.shape[1]
        x_mask = sequence_mask(x_lengths, T_x).float()[..., None]
        y_mask = sequence_mask(y_lengths, T_y).float()[..., None]
        mu_x, logw = self.encoder(x, x_mask, spk_emb)

        attn_mask = x_mask[:, :, 0][:, :, None] * y_mask[:, :, 0][:, None, :]
        if durations is not None:
            attn = generate_path(durations.float() * x_mask[:, :, 0], attn_mask)
        else:
            # Gaussian log-prior of every (token, frame) pair; no gradient
            # flows through the search
            mu_sg = mu_x.detach()
            # a bf16 y (bf16 training) meets mu in mu's type, as jnp.einsum
            # promotes; its sum of squares stays in y's type
            log_prior = (torch.einsum("bxf,byf->bxy", mu_sg, y.to(mu_sg.dtype))
                         - 0.5 * torch.sum(y ** 2, dim=-1)[:, None, :]
                         - 0.5 * torch.sum(mu_sg ** 2, dim=-1)[:, :, None]
                         + (-0.5 * LOG_2PI * self.n_feats))
            attn = maximum_path(log_prior, attn_mask)

        logw_ = torch.log(1e-8 + torch.sum(attn, dim=-1))[..., None] * x_mask
        dur_loss = duration_loss(logw, logw_, x_lengths)

        if out_size is not None and out_size < T_y:
            if offsets is None:
                u = torch.rand(y.shape[0], generator=generator, device=y.device)
                offsets = segment_offsets(u, y_lengths, out_size, y.dtype)
            offsets = torch.clamp(offsets.to(device=y.device, dtype=torch.long),
                                  0, T_y - out_size)
            frames = offsets[:, None] + torch.arange(out_size, device=y.device)[None, :]
            y = torch.gather(y, 1, frames[:, :, None].expand(-1, -1, y.shape[2]))
            attn = torch.gather(attn, 2, frames[:, None, :].expand(-1, T_x, -1))
            y_mask = sequence_mask(torch.clamp(y_lengths, max=out_size), out_size).float()[..., None]

        mu_y = torch.einsum("bxy,bxf->byf", attn, mu_x)
        diff_loss = self.decoder.compute_loss(y, y_mask, mu_y, t=t, z=z, generator=generator,
                                              spks=spk_emb)

        if self.prior_loss:
            prior = torch.sum(0.5 * ((y - mu_y) ** 2 + LOG_2PI) * y_mask)
            prior = prior / (torch.sum(y_mask) * self.n_feats)
        else:
            prior = torch.zeros((), device=y.device)
        return dur_loss, prior, diff_loss, attn


def decoder_cast(model: MatchaTTS, dtype: torch.dtype) -> MatchaTTS:
    """A copy of ``model`` whose decoder (the CFM U-Net) is cast to
    ``dtype``; it shares every other module and buffer with ``model``,
    which stays as it was. The counterpart of JAX's
    ``TTSPipeline._latency_params``: the encoder, the speaker embedding and
    the durations stay f32, bit-identical to the f32 path."""
    cast = copy.copy(model)
    cast._modules = dict(model._modules)  # copy.copy shares the dict itself
    cast.decoder = copy.deepcopy(model.decoder).to(dtype)
    return cast.eval()
