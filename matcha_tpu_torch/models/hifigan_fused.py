"""HiFi-GAN generator with the narrow MRF stages fused (serving path).

The counterpart of ``matcha_tpu/models/hifigan_pallas.py::
generator_apply_pallas``: the same math as ``Generator.forward``, but
each MRF stage with at most ``max_fused_channels`` channels (C = 64 and
C = 32 in HiFi-GAN v1 at the default cap) runs as one fused call: K1
(``ops/mrf.py``) on the channels-first activation, or with
``narrow_impl="phase"`` K3 (``ops/mrf_phase.py``) on its channels-last
transpose for C <= 64. On a GPU those are the CUDA kernels. Wider stages,
conv_pre, the upsamples and conv_post stay plain torch convs, as the JAX
package leaves them to XLA.
"""

from typing import Dict, Optional, Tuple

import torch

from matcha_tpu_torch.models.hifigan import Generator
from matcha_tpu_torch.ops.mrf import MAX_CHANNELS, fused_mrf_stage, mrf_weights_from_resblocks
from matcha_tpu_torch.ops.mrf_phase import fused_mrf_stage_phase

#: widest MRF stage that takes a fused kernel by default (the JAX package's
#: ``max_pallas_channels`` default); a caller may raise it to MAX_CHANNELS
MAX_FUSED_CHANNELS = 64
NARROW_IMPLS = ("plain", "phase")


@torch.inference_mode()
def fused_stage_weights(gen: Generator, max_fused_channels: int = MAX_FUSED_CHANNELS
                        ) -> Dict[int, Tuple[torch.Tensor, ...]]:
    """{stage index: packed kernel weights} for every stage of at most
    ``max_fused_channels`` channels, on the generator's device. Build it
    once per loaded generator and pass it to ``generator_apply_fused``
    with the same cap; K1 and K3 read the same packing."""
    return {i: mrf_weights_from_resblocks(gen.stage_blocks(i))
            for i, up in enumerate(gen.ups) if up.out_channels <= max_fused_channels}


@torch.inference_mode()
def generator_apply_fused(gen: Generator, mel: torch.Tensor,
                          stage_weights: Optional[Dict[int, Tuple[torch.Tensor, ...]]] = None,
                          *, max_fused_channels: int = MAX_FUSED_CHANNELS,
                          t_tile: Optional[int] = None, upsample_impl: Optional[str] = None,
                          narrow_impl: str = "plain", n_stages: Optional[int] = None,
                          skip_last_mrf: bool = False, with_post: bool = True,
                          compute_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Mel (B, T, num_mels) f32 -> waveform (B, T * hop, 1), tanh output.

    ``stage_weights``: ``fused_stage_weights(gen, max_fused_channels)``,
    packed here when not given. ``max_fused_channels`` (the JAX
    ``max_pallas_channels``, at most 128): stages up to this width are
    fused. ``t_tile``: the fused kernels' central tile in samples, a
    multiple of 16, clamped per stage to the largest that fits (None =
    ``ops/mrf.py::pick_t_tile``'s choice for the stage's width, length and
    batch; the output does not depend on it). ``upsample_impl``:
    "dilated" or "subpixel" (None = the generator's own).
    ``narrow_impl``: "plain" (K1) or "phase" (K3 for C <= 64, the JAX
    ``128 // C >= 2`` test).

    ``n_stages`` / ``skip_last_mrf`` / ``with_post`` stop the forward early
    for the stage profiler, as in the JAX function: after upsample + MRF
    stage ``n_stages`` - 1 (after just its upsample with
    ``skip_last_mrf``), and without leaky + conv_post + tanh when
    ``with_post`` is False, which returns the (B, T, C) activation.
    """
    if mel.dtype != torch.float32 or compute_dtype != torch.float32:
        raise NotImplementedError("the fused generator runs in float32 only (bf16 serving is "
                                  "not ported)")
    if not 0 <= max_fused_channels <= MAX_CHANNELS:
        raise ValueError(f"max_fused_channels={max_fused_channels}: the fused kernels take at "
                         f"most {MAX_CHANNELS} channels")
    if narrow_impl not in NARROW_IMPLS:
        raise ValueError(f"narrow_impl={narrow_impl!r}: one of {NARROW_IMPLS}")
    if stage_weights is None:
        stage_weights = fused_stage_weights(gen, max_fused_channels)
    h = gen.h
    ks, dils = h.resblock_kernel_sizes, h.resblock_dilation_sizes
    n_stages = len(gen.ups) if n_stages is None else n_stages
    x = gen.conv_pre(mel.transpose(1, 2))
    for i in range(min(n_stages, len(gen.ups))):
        x = gen.upsample(i, x, upsample_impl)
        if skip_last_mrf and i == n_stages - 1:
            break
        C = x.shape[1]
        if C > max_fused_channels:
            x = gen.mrf_stage(i, x)
        elif i not in stage_weights:
            raise ValueError(f"stage_weights has no stage {i} (C={C}): pack them with "
                             f"fused_stage_weights(gen, {max_fused_channels})")
        elif narrow_impl == "phase" and 128 // C >= 2:
            x = fused_mrf_stage_phase(x.transpose(1, 2).contiguous(), stage_weights[i], ks, dils,
                                      t_tile=t_tile).transpose(1, 2)
        else:
            x = fused_mrf_stage(x.contiguous(), stage_weights[i], ks, dils, t_tile=t_tile)
    if not with_post:
        return x.transpose(1, 2)
    return gen.post(x)
