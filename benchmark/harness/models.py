"""The models of a configuration, for the system under test and for the
reference, with the same seeded weights.

A configuration file holds ``model`` (the ``MatchaTTS`` arguments),
``vocoder_arch`` and ``vocoder`` (the vocoder's architecture and its
arguments, built through ``vocoders.adapter``) and ``synthesis`` (steps,
temperature, the operator's speaking rate as ``length_scale``, the
denoiser's strength). Both sides take the same keyword arguments: the
reference is a frozen copy of the system's plain modules.
"""

import torch

from benchmark.harness.common import derive_seed
from benchmark.harness.vocoders import adapter
from benchmark.harness.weights import seeded_state_dict


def _build(matcha_cls, make_vocoder, cfg: dict, seed: int, device):
    with torch.device(device):
        model = matcha_cls(**cfg["model"])
    vocoder = make_vocoder(cfg["vocoder"], device)
    model.eval()
    vocoder.eval()
    seeded_state_dict(model, derive_seed(seed, "weights", "matcha"))
    seeded_state_dict(vocoder, derive_seed(seed, "weights", "vocoder"))
    return model, vocoder


def _model_kwargs(cfg: dict) -> dict:
    kw = dict(cfg["model"])
    kw["dec_channels"] = tuple(kw["dec_channels"])
    return kw


def system_pipeline(cfg: dict, seed: int, device, cleaner: str, cls=None):
    """The system's ``TTSPipeline`` (or the subclass ``cls``) over seeded
    models, with the vocoder and its denoiser bias that the architecture's
    ``pipeline_kwargs`` give (for HiFi-GAN: the fused-MRF vocoder, the
    bias from its output on a zero mel, as ``cli.load_vocoder`` makes
    it)."""
    from matcha_tpu_torch.cli import TTSPipeline
    from matcha_tpu_torch.models.matcha import MatchaTTS

    arch = adapter(cfg)
    c = dict(cfg, model=_model_kwargs(cfg))
    model, vocoder = _build(MatchaTTS, arch.system, c, seed, device)
    return (cls or TTSPipeline)(model, cleaner=cleaner, device=device,
                                denoiser_strength=cfg["synthesis"]["denoiser_strength"],
                                **arch.pipeline_kwargs(vocoder, device))


def reference_models(cfg: dict, seed: int, device):
    """(model, vocoder, denoiser bias or None) of the plain reference, on
    the same seeded weights."""
    from benchmark.reference.models.matcha import MatchaTTS

    arch = adapter(cfg)
    c = dict(cfg, model=_model_kwargs(cfg))
    model, vocoder = _build(MatchaTTS, arch.reference, c, seed, device)
    return model, vocoder, arch.reference_bias(vocoder, device)


def with_speaking_rate(cfg: dict, traffic: dict, seed: int, device) -> dict:
    """``cfg`` with ``synthesis.length_scale`` set as an operator sets the
    speaking rate: so that the mel frames per id over texts of the
    traffic's lengths match the corpus's (``synthesis.frames_per_id``).
    Random weights predict durations far from any corpus's, and by an
    amount that changes with the seed; the rate makes every seed do the
    same work. Measured on the reference's encoder in float32 (TF32 off)
    over 64 texts of the mix's lengths, rounded to 1e-3."""
    import numpy as np

    from benchmark.harness.common import derive_seed
    from benchmark.harness.judge import _NoTF32, reference_ids
    from benchmark.harness.textgen import fixed_lengths, texts_of_lengths
    from benchmark.reference.models.matcha import MatchaTTS
    from benchmark.reference.ops.seq import sequence_mask

    rng = np.random.default_rng(derive_seed(seed, "speaking_rate"))
    texts = texts_of_lengths(rng, fixed_lengths(traffic["name"], 64, traffic["chars"]))
    with torch.device(device):
        model = MatchaTTS(**_model_kwargs(cfg)).eval()
    seeded_state_dict(model, derive_seed(seed, "weights", "matcha"))
    frames = ids = 0.0
    n_spk = cfg["model"]["n_spks"]
    with _NoTF32(), torch.inference_mode():
        for t in texts:
            x = torch.as_tensor(reference_ids(t, cfg["cleaner"]), device=device)[None]
            xl = torch.tensor([x.shape[1]], device=device)
            spks = (torch.tensor([int(rng.integers(n_spk))], device=device) if n_spk > 1
                    else None)
            mask = sequence_mask(xl, x.shape[1]).float()[..., None]
            _, logw = model.encoder(x, mask, model._speaker(spks))
            frames += float(torch.ceil(torch.exp(torch.clamp(logw, max=11.0))).sum())
            ids += x.shape[1]
    syn = dict(cfg["synthesis"])
    syn["length_scale"] = round(syn["frames_per_id"] * ids / frames, 3)
    return dict(cfg, synthesis=syn)
