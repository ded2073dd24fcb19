"""HiFi-GAN generator with the narrow MRF stages fused (serving path).

The counterpart of ``matcha_tpu/models/hifigan_pallas.py::
generator_apply_pallas``: the same math as ``Generator.forward``, but
each MRF stage with at most ``MAX_FUSED_CHANNELS`` channels (C = 64 and
C = 32 in HiFi-GAN v1) runs as one ``fused_mrf_stage`` call, the CUDA
kernel on a GPU. Wider stages, conv_pre, the upsamples and conv_post stay
plain torch convs, as the JAX package leaves them to XLA.
"""

from typing import Dict, Optional, Tuple

import torch

from matcha_tpu_torch.models.hifigan import Generator
from matcha_tpu_torch.ops.mrf import fused_mrf_stage, mrf_weights_from_resblocks

#: widest MRF stage that takes the fused kernel (the JAX package's
#: ``max_pallas_channels`` default)
MAX_FUSED_CHANNELS = 64


@torch.inference_mode()
def fused_stage_weights(gen: Generator) -> Dict[int, Tuple[torch.Tensor, ...]]:
    """{stage index: packed kernel weights} for every stage of at most
    ``MAX_FUSED_CHANNELS`` channels, on the generator's device. Build it
    once per loaded generator and pass it to ``generator_apply_fused``."""
    return {i: mrf_weights_from_resblocks(gen.stage_blocks(i))
            for i, up in enumerate(gen.ups) if up.out_channels <= MAX_FUSED_CHANNELS}


@torch.inference_mode()
def generator_apply_fused(gen: Generator, mel: torch.Tensor,
                          stage_weights: Optional[Dict[int, Tuple[torch.Tensor, ...]]] = None
                          ) -> torch.Tensor:
    """Mel (B, T, num_mels) -> waveform (B, T * hop, 1), tanh output.
    ``stage_weights``: ``fused_stage_weights(gen)``, packed here when not
    given."""
    if stage_weights is None:
        stage_weights = fused_stage_weights(gen)
    h = gen.h
    x = gen.conv_pre(mel.transpose(1, 2))
    for i in range(len(gen.ups)):
        x = gen.upsample(i, x)
        if i in stage_weights:
            x = fused_mrf_stage(x.contiguous(), stage_weights[i], h.resblock_kernel_sizes,
                                h.resblock_dilation_sizes)
        else:
            x = gen.mrf_stage(i, x)
    return gen.post(x)
