"""HiFi-GAN (github.com/jik876/hifi-gan): the system's generator, whose
narrow MRF stages run the fused kernel, and the plain reference's; each
denoised by the bias of its own output on a zero mel, as
``cli.load_vocoder`` makes it. ``vocoder_cfg`` holds the
``HiFiGANConfig`` arguments."""

import torch


def _config(cfg_cls, vocoder_cfg: dict):
    return cfg_cls(**{k: tuple(v) if isinstance(v, list) else v for k, v in vocoder_cfg.items()})


def system(vocoder_cfg: dict, device):
    from matcha_tpu_torch.models.hifigan import Generator, HiFiGANConfig
    with torch.device(device):
        return Generator(_config(HiFiGANConfig, vocoder_cfg))


def reference(vocoder_cfg: dict, device):
    from benchmark.reference.models.hifigan import Generator, HiFiGANConfig
    with torch.device(device):
        return Generator(_config(HiFiGANConfig, vocoder_cfg))


def pipeline_kwargs(vocoder, device) -> dict:
    from matcha_tpu_torch.models.denoiser import compute_bias_spec
    from matcha_tpu_torch.models.hifigan_fused import generator_apply_fused
    bias = compute_bias_spec(lambda mel: generator_apply_fused(vocoder, mel), device=device)
    return {"vocoder": vocoder, "denoiser_bias": bias}


def reference_bias(vocoder, device):
    from benchmark.reference.models.denoiser import compute_bias_spec
    return compute_bias_spec(lambda mel: vocoder(mel), device=device)
