"""The vocoder of a configuration comes from the module its
``vocoder_arch`` names (``benchmark.harness.vocoders``): HiFi-GAN's gives
the same seeded weights and the same FLOP count as the harness built
before the adapter existed, an unknown architecture is refused, and a new
architecture goes through every harness entry point as a module alone."""

import json
import sys
import types

import pytest
import torch
from torch import nn

from benchmark.harness import common, flops, models, vocoders
from benchmark.harness.common import derive_seed
from benchmark.harness.weights import seeded_state_dict
from conftest import tiny_cell

CONFIGS = ["matcha-ljspeech", "matcha-vctk"]
SEED = 2**31 + 2024


def _config(name: str) -> dict:
    return common.load_json(common.BENCH / "configs" / f"{name}.json")


@pytest.mark.parametrize("name", CONFIGS)
def test_hifigan_weights_are_the_direct_construction(name):
    """At the published widths: the system's and the reference's seeded
    generators are bit-equal to each other and to ``Generator(HiFiGANConfig
    (...))`` seeded from the vocoder's seed directly."""
    from matcha_tpu_torch.models.hifigan import Generator, HiFiGANConfig

    cfg = _config(name)
    arch = vocoders.adapter(cfg)
    assert arch is vocoders.hifigan

    def stub_matcha(**kw):
        return nn.Linear(2, 2)

    _, sys_voc = models._build(stub_matcha, arch.system, cfg, SEED, "cpu")
    _, ref_voc = models._build(stub_matcha, arch.reference, cfg, SEED, "cpu")
    direct = Generator(HiFiGANConfig(**{k: tuple(v) if isinstance(v, list) else v
                                        for k, v in cfg["vocoder"].items()}))
    want = seeded_state_dict(direct, derive_seed(SEED, "weights", "vocoder"))
    for got in (sys_voc.state_dict(), ref_voc.state_dict()):
        assert got.keys() == want.keys()
        assert all(torch.equal(got[k], want[k]) for k in want)


#: ``ModelFlops(cfg).utterance(201, 566)`` and the vocoder's counts at 32,
#: 64 and 128 mel frames, as the harness counted them when it built every
#: vocoder as HiFi-GAN directly
PINNED = {"matcha-ljspeech": 417795140608.00256, "matcha-vctk": 419610147328.00256}
VOCODER_FLOPS = {32: 19651362816, 64: 39302725632, 128: 78605451264}


@pytest.mark.parametrize("name", CONFIGS)
def test_model_flops_are_the_pinned_counts(name):
    mf = flops.ModelFlops(_config(name))
    assert {T: mf.vocoder_at(T) for T in VOCODER_FLOPS} == VOCODER_FLOPS
    assert mf.utterance(201, 566) == pytest.approx(PINNED[name], rel=1e-12, abs=0)


@pytest.mark.parametrize("arch", [None, "no_such_vocoder", "hifigan.x", "../hifigan"])
def test_unknown_architecture_is_refused_naming_the_known(arch):
    cfg = {"name": "c", "vocoder": {}}
    if arch is not None:
        cfg["vocoder_arch"] = arch
    with pytest.raises(ValueError) as e:
        vocoders.adapter(cfg)
    assert "hifigan" in str(e.value)
    assert "hifigan" in vocoders.known()


HOP, N_MELS = 256, 80


class ToyGenerator(nn.Module):
    """One 1 x 1 conv to ``HOP`` channels, read as HOP samples a frame."""

    def __init__(self, n_mels: int, hop: int):
        super().__init__()
        self.conv = nn.Conv1d(n_mels, hop, 1)

    def generate(self, mel):  # (B, n_mels, T) -> (B, 1, T * hop)
        return self.conv(mel).transpose(1, 2).reshape(mel.shape[0], 1, -1)

    def forward(self, mel):  # (B, T, n_mels) -> (B, T * hop, 1)
        return self.generate(mel.transpose(1, 2)).transpose(1, 2)


@pytest.fixture
def toy(monkeypatch):
    """``benchmark.harness.vocoders.toy``, registered for this test only."""
    mod = types.ModuleType("benchmark.harness.vocoders.toy")

    def build(vocoder_cfg, device):
        with torch.device(device):
            return ToyGenerator(vocoder_cfg["num_mels"], vocoder_cfg["hop_size"])

    mod.system = mod.reference = build
    mod.pipeline_kwargs = lambda vocoder, device: {"vocoder": vocoder, "denoiser_bias": None}
    mod.reference_bias = lambda vocoder, device: None
    monkeypatch.setitem(sys.modules, mod.__name__, mod)
    cfg = json.loads(json.dumps(tiny_cell("ljspeech.corpus")["config"]))
    cfg["vocoder_arch"] = "toy"
    cfg["vocoder"] = {"num_mels": N_MELS, "hop_size": HOP}
    cfg["synthesis"]["length_scale"] = 1.0
    return cfg


def test_toy_architecture_through_the_reference_and_the_flops(toy):
    model, voc, bias = models.reference_models(toy, SEED, "cpu")
    assert isinstance(voc, ToyGenerator) and bias is None
    want = seeded_state_dict(ToyGenerator(N_MELS, HOP), derive_seed(SEED, "weights", "vocoder"))
    assert all(torch.equal(voc.state_dict()[k], want[k]) for k in want)
    mf = flops.ModelFlops(toy)
    assert mf.vocoder.conv.weight.device.type == "meta"
    assert mf.vocoder_at(50) == 2 * N_MELS * HOP * 50


def test_toy_architecture_is_not_denoised(toy, monkeypatch):
    from benchmark.harness.judge import Reference
    from benchmark.reference.models import denoiser

    def denoise(*a, **kw):
        raise AssertionError("an architecture with no bias is not denoised")

    monkeypatch.setattr(denoiser, "denoise", denoise)
    ref = Reference(toy, SEED, torch.device("cpu"))
    assert ref.bias is None
    mel = torch.randn((1, 12, N_MELS), generator=torch.Generator().manual_seed(3))
    wav = ref._finish(mel, ref.vocoder, 10, 9)
    with torch.inference_mode():
        direct = torch.clamp(ref.vocoder(mel[:, :10])[..., 0], -1.0, 1.0)[0, :9 * HOP]
    assert wav.shape == (9 * HOP,)
    assert torch.equal(torch.from_numpy(wav), direct)


def test_toy_architecture_through_the_system_pipeline(toy):
    from matcha_tpu_torch.models.matcha import MatchaTTS

    seen = {}

    def stub(model, **kw):
        seen.update(kw, model=model)
        return "pipeline"

    assert models.system_pipeline(toy, SEED, "cpu", toy["cleaner"], cls=stub) == "pipeline"
    assert isinstance(seen["model"], MatchaTTS)
    assert isinstance(seen["vocoder"], ToyGenerator) and seen["denoiser_bias"] is None
    assert seen["cleaner"] == toy["cleaner"] and seen["device"] == "cpu"
    assert seen["denoiser_strength"] == toy["synthesis"]["denoiser_strength"]
    want = seeded_state_dict(ToyGenerator(N_MELS, HOP), derive_seed(SEED, "weights", "vocoder"))
    assert all(torch.equal(seen["vocoder"].state_dict()[k], want[k]) for k in want)
