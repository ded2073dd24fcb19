"""The BigVGAN-v2 configuration and its cell (``ljspeech-bigvgan.corpus``):
the adapter's seeded generators, the model FLOPs of its vocoder, K4's
work by hand, the reading of ``k4_roofline.corpus``, and the cell on the
CPU, sound and with its answers altered."""

import numpy as np
import pytest
import torch
from torch import nn

from benchmark.harness import common, flops, models, vocoders
from conftest import tiny_cell

CELL = "ljspeech-bigvgan.corpus"
SEED = 2**31 + 2025


def _config() -> dict:
    return common.load_json(common.BENCH / "configs" / "matcha-ljspeech-bigvgan.json")


def test_adapter_generators_are_bit_equal():
    """One seed gives the system's and the reference's generator the same
    state dict, the Kaiser-sinc filters included."""
    cfg = tiny_cell(CELL)["config"]
    arch = vocoders.adapter(cfg)
    assert arch is vocoders.bigvgan

    def stub_matcha(**kw):
        return nn.Linear(2, 2)

    _, sys_voc = models._build(stub_matcha, arch.system, cfg, SEED, "cpu")
    _, ref_voc = models._build(stub_matcha, arch.reference, cfg, SEED, "cpu")
    a, b = sys_voc.state_dict(), ref_voc.state_dict()
    assert list(a) == list(b)
    assert any(k.endswith("downsample.lowpass.filter") for k in a)
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert arch.pipeline_kwargs(sys_voc, "cpu") == {"vocoder": sys_voc, "denoiser_bias": None}
    assert arch.reference_bias(ref_voc, "cpu") is None


@pytest.mark.parametrize("T", [32, 64, 128])
def test_vocoder_model_flops_at_published_widths(T):
    """On ``meta``: 252 x 6.93 M of AMP-block convs and about 0.09 G of
    conv_pre, the upsamples, the resampling filters and conv_post, per
    mel frame: within 3 % of 1.80 GFLOP x T."""
    mf = flops.ModelFlops(_config())
    assert mf.vocoder.conv_pre.weight.device.type == "meta"
    assert mf.vocoder_at(T) == pytest.approx(1.80e9 * T, rel=0.03)


def test_k4_work_by_hand():
    voc = _config()["vocoder"]
    arch = vocoders.bigvgan
    assert arch.k4_launches(voc) == 6 * 3 * 6 + 1 == 109
    # samples of the 2x-rate stages at their output rate, per mel frame:
    # 768 x 4, 384 x 16, 192 x 32, 96 x 64, 48 x 128, 24 x 256
    per_frame = 18 * (3072 + 6144 * 5) + 24 * 256
    assert per_frame == 614_400
    assert arch.k4_bytes(voc, 10) == 8 * per_frame * 10 == 49_152_000
    assert arch.k4_flops(voc, 10) == 58 * per_frame * 10
    assert arch.k4_least_s(voc, 10) == pytest.approx(49_152_000 / 3.35e12)


def _traced_run(cfg, n_events, batches=2):
    events = [("aa_snake_kernel(float const*, float*, ...)", 10.0 * i, 10.0 * i + 5.0)
              for i in range(n_events)]
    events.append(("mrf_stage_kernel", 0.0, 1.0))
    return {"kind": "corpus", "config": cfg,
            "batches": [{"mel_lengths": np.asarray([300, 200])} for _ in range(batches)],
            "trace": {"events": events, "busy_s": 1.0, "window_s": 2.0}}


def test_k4_roofline_reads_only_a_whole_count():
    read = common.metric_reader("k4_roofline.corpus")
    cfg = _config()
    least = 2 * vocoders.bigvgan.k4_least_s(cfg["vocoder"], 500)
    assert read(_traced_run(cfg, 218)) == pytest.approx(100.0 * least / (218 * 5e-6))
    assert read(_traced_run(cfg, 217)) is None
    assert read(_traced_run(cfg, 219)) is None
    assert read(_traced_run(cfg, 0)) is None
    hifigan = common.load_json(common.BENCH / "configs" / "matcha-ljspeech.json")
    assert read(_traced_run(hifigan, 218)) is None
    assert read(dict(_traced_run(cfg, 218), trace=None)) is None


def test_sound_run_is_correct(cpu_run):
    correct, checks, run = cpu_run(tiny_cell(CELL))
    assert correct, checks
    assert run["config"]["synthesis"]["denoiser_strength"] == 0.0


def test_altered_answer_is_not_correct(cpu_run, monkeypatch):
    from matcha_tpu_torch.cli import TTSPipeline
    orig = TTSPipeline.vocode
    monkeypatch.setattr(TTSPipeline, "vocode", lambda self, mel, bf16=None: orig(self, mel) * 1.1)
    correct, checks, _ = cpu_run(tiny_cell(CELL))
    assert not correct
    assert {c["name"] for c in checks if c["rule"] == "at most" and c["value"] > c["limit"]} \
        == {"wav_err"}


def test_control_is_not_correct():
    """The reference in bfloat16 in the system's place fails the cell's
    limits on the same answers, while the system passes them."""
    import time

    from benchmark.harness.execute import execute
    from benchmark.harness.judge import summarise

    cell = tiny_cell(CELL)
    torch.set_num_threads(2)
    rc, _, run = execute(cell, 2**31 + 91, 3.0, False, torch.device("cpu"), time.perf_counter(),
                         control=True)
    assert rc == 0
    res = run["results"]
    assert summarise(res, cell["limits"], run["answered"], run["due"])[0]
    as_control = [dict(r, dur_gap=r["dur_gap_control"], wav_err=r["wav_err_control"],
                       mel_err=r["mel_err_control"]) for r in res]
    control_ok, checks = summarise(as_control, cell["limits"], run["answered"], run["due"])
    assert not control_ok, checks
    by = {c["name"]: c for c in checks}
    assert by["wav_err"]["value"] > cell["limits"]["wav_err"]
