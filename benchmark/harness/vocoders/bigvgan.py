"""BigVGAN-v2 (github.com/NVIDIA/BigVGAN, arXiv:2206.04658): the system's
generator, whose anti-aliased SnakeBeta activations run K4
(``aa_snake_kernel``), and the plain reference's. Neither is denoised:
BigVGAN's own inference does not denoise. ``vocoder_cfg`` holds the
``BigVGANConfig`` arguments.

K4's work per vocoder call, for ``k4_roofline.corpus``: one launch per
activation, 2 x len(dilations) per AMP block and one after the last
stage; a launch over a (B, C, L) signal writes B * C * L output samples,
L being the mel frames times the stage's cumulative upsampling. Per
output sample it reads 4 bytes and writes 4, and does 58 FLOPs: two
samples of the 2x signal, each 6 FMAs of Up (12), the product with e^alpha,
the sine, its square and one FMA (5), then 12 FMAs of Down (24), a sine
counted as one operation.
"""

import torch

#: NVIDIA H100 SXM at its full 700 W: f32 on the CUDA cores (K4's
#: arithmetic is FMAs and sines, no tensor-core product) and HBM3
PEAK_F32_FLOPS = 67e12
PEAK_HBM_BYTES_PER_S = 3.35e12
K4_FLOPS_PER_SAMPLE = 58
K4_BYTES_PER_SAMPLE = 8


def _config(cfg_cls, vocoder_cfg: dict):
    return cfg_cls(**{k: tuple(tuple(x) if isinstance(x, list) else x for x in v)
                      if isinstance(v, list) else v for k, v in vocoder_cfg.items()})


def system(vocoder_cfg: dict, device):
    from matcha_tpu_torch.models.bigvgan import BigVGANConfig, Generator
    with torch.device(device):
        return Generator(_config(BigVGANConfig, vocoder_cfg))


def reference(vocoder_cfg: dict, device):
    from benchmark.reference.models.bigvgan import BigVGANConfig, Generator
    with torch.device(device):
        return Generator(_config(BigVGANConfig, vocoder_cfg))


def pipeline_kwargs(vocoder, device) -> dict:
    return {"vocoder": vocoder, "denoiser_bias": None}


def reference_bias(vocoder, device):
    return None


def _stages(vocoder_cfg: dict) -> list:
    """[(C, cumulative upsampling)] of the stages."""
    out, up = [], 1
    for i, u in enumerate(vocoder_cfg["upsample_rates"]):
        up *= u
        out.append((vocoder_cfg["upsample_initial_channel"] // 2 ** (i + 1), up))
    return out


def _acts_per_stage(vocoder_cfg: dict) -> int:
    return sum(2 * len(d) for d in vocoder_cfg["resblock_dilation_sizes"])


def k4_launches(vocoder_cfg: dict) -> int:
    """K4's launches in one vocoder call: 109 at the published widths."""
    return len(vocoder_cfg["upsample_rates"]) * _acts_per_stage(vocoder_cfg) + 1


def k4_samples(vocoder_cfg: dict, frames: int) -> int:
    """Output samples of a call's K4 launches over ``frames`` mel frames."""
    stages = _stages(vocoder_cfg)
    C_last, up_last = stages[-1]
    n = _acts_per_stage(vocoder_cfg)
    return (sum(n * C * up for C, up in stages) + C_last * up_last) * frames


def k4_bytes(vocoder_cfg: dict, frames: int) -> float:
    return float(K4_BYTES_PER_SAMPLE * k4_samples(vocoder_cfg, frames))


def k4_flops(vocoder_cfg: dict, frames: int) -> float:
    return float(K4_FLOPS_PER_SAMPLE * k4_samples(vocoder_cfg, frames))


def k4_least_s(vocoder_cfg: dict, frames: int) -> float:
    """The least time a call's K4 launches over ``frames`` mel frames can
    take on the card: compute- or bandwidth-bound, whichever is longer."""
    return max(k4_flops(vocoder_cfg, frames) / PEAK_F32_FLOPS,
               k4_bytes(vocoder_cfg, frames) / PEAK_HBM_BYTES_PER_S)
