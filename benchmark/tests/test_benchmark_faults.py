"""A run with the timed path broken underneath comes out not correct:
for each fault these cells can have, an answer altered where it is made
and half of a batch left out. Tiny cells on the CPU; everything but the
look for a card runs as on the chip."""

import pytest

from conftest import tiny_cell


def _scaled_vocode(monkeypatch):
    from matcha_tpu_torch.cli import TTSPipeline
    orig = TTSPipeline.vocode

    def vocode(self, mel_btc, bf16=None):
        return orig(self, mel_btc, bf16) * 1.1

    monkeypatch.setattr(TTSPipeline, "vocode", vocode)


@pytest.mark.parametrize("name", ["vctk.serve-speakers", "ljspeech.corpus"])
def test_sound_run_is_correct(name, cpu_run):
    correct, checks, _ = cpu_run(tiny_cell(name))
    assert correct, checks


@pytest.mark.parametrize("name", ["vctk.serve-speakers", "ljspeech.corpus"])
def test_altered_answer_is_not_correct(name, cpu_run, monkeypatch):
    _scaled_vocode(monkeypatch)
    correct, checks, _ = cpu_run(tiny_cell(name))
    assert not correct
    assert {c["name"]: c for c in checks}["wav_err"]["value"] > 0.05


def test_serve_half_batch_left_out_is_not_correct(cpu_run, monkeypatch):
    from matcha_tpu_torch.serve import BatchingServer
    orig = BatchingServer._complete

    def complete(self, reqs, out):
        keep = len(reqs) // 2
        orig(self, reqs, out)
        for r in reqs[keep:]:
            r.error = "left out"

    monkeypatch.setattr(BatchingServer, "_complete", complete)
    correct, checks, run = cpu_run(tiny_cell("vctk.serve-speakers"))
    assert not correct
    assert run["answered"] < run["due"]


def test_corpus_half_batch_left_out_is_not_correct(cpu_run, monkeypatch):
    from matcha_tpu_torch.cli import TTSPipeline
    orig = TTSPipeline.synthesise_corpus

    def corpus(self, *a, **kw):
        for chunk, out in orig(self, *a, **kw):
            half = len(chunk) // 2
            for key in ("waveform", "mel"):
                out[key] = out[key].clone()
                out[key][half:] = 0.0
            yield chunk, out

    monkeypatch.setattr(TTSPipeline, "synthesise_corpus", corpus)
    correct, checks, run = cpu_run(tiny_cell("ljspeech.corpus"))
    assert not correct
    assert {c["name"]: c for c in checks}["wav_err"]["value"] > 0.5


def test_forbidden_module_loaded_by_the_check_leaves_no_result(monkeypatch):
    """A module that pulls JAX in after the window (here, during the
    check) still stops the run before its result is printed."""
    import sys
    import time
    import types

    import torch

    from benchmark.harness import judge
    from benchmark.harness.execute import execute
    orig = judge.summarise

    def summarise(*a, **kw):
        monkeypatch.setitem(sys.modules, "jax", types.ModuleType("jax"))
        return orig(*a, **kw)

    monkeypatch.setattr(judge, "summarise", summarise)
    torch.set_num_threads(2)
    rc, line, _ = execute(tiny_cell("ljspeech.corpus"), 2**31 + 78, 2.0, False,
                          torch.device("cpu"), time.perf_counter())
    assert rc != 0 and line is None
