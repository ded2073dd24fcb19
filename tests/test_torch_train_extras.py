"""The Matcha trainer's remaining options in the port, against the JAX package.

* the native C++ mel frontend: the port's own binding builds
  ``native/audio/frontend.cpp`` under ``build/matcha_tpu_torch/`` (never
  ``native/audio/libaudio.so``) and matches the numpy mel within JAX's
  5e-4 (``tests/test_native_audio.py``); ``"native"`` raises when the
  build fails, ``"auto"`` warns and takes numpy;
* ``generate_data_statistics``: the same JSON as JAX's on one corpus;
* image logging: after a validation the trainer writes JAX's tags
  (``original/i`` in epoch 0, ``generated_enc/i``, ``generated_dec/i``,
  ``alignment/i`` for 2 samples) to tensorboard, and ``plot_tensor``
  draws JAX's pixels;
* ``trainer.profiler=jax``: the entry point traces steps 1-3 of epoch 0
  into ``<output_dir>/profile``;
* ``remat``: the gradients with the estimator rematerialised equal those
  without (bit for bit: ``torch.utils.checkpoint`` replays the dropout
  generator's state);
* the logger backends: each warns as JAX's does when its client library
  is missing.
"""

import hashlib
import json
import logging
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from matcha_tpu.audio import mel as jax_mel
from matcha_tpu.training import generate_data_statistics as jax_stats
from matcha_tpu.training import trainer as jax_trainer
from matcha_tpu.utils import utils as jax_utils
from matcha_tpu_torch import train as port_train
from matcha_tpu_torch.audio import mel as port_mel
from matcha_tpu_torch.audio import native as port_native
from matcha_tpu_torch.models.matcha import MatchaTTS
from matcha_tpu_torch.training import generate_data_statistics as port_stats
from matcha_tpu_torch.training import trainer as port_trainer
from matcha_tpu_torch.utils import utils as port_utils
from tests.test_torch_train import CLEANER, TINY_TRAIN, corpus, dm_args  # noqa: F401

REPO = Path(__file__).resolve().parents[1]
JAX_LIB = REPO / "native" / "audio" / "libaudio.so"
# tiny-model overrides of the repo's configs (the corpus's 16-bin mels)
TINY_OVERRIDES = [
    "trainer.accelerator=cpu", f"data.cleaners=[{CLEANER}]", "data.n_feats=16",
    "data.f_max=4000", "data.num_workers=0", "model.n_feats=16",
    "model.encoder.encoder_params.n_channels=16", "model.encoder.encoder_params.filter_channels=32",
    "model.encoder.encoder_params.filter_channels_dp=16", "model.encoder.encoder_params.n_layers=1",
    "model.decoder.channels=[16,16]", "model.decoder.num_mid_blocks=1",
    "model.decoder.num_heads=1", "model.decoder.attention_head_dim=16",
]


@pytest.fixture(scope="module", autouse=True)
def two_threads():
    """Two torch threads, so that the suite's parallel workers do not
    oversubscribe the CPU."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def _digest(path: Path):
    return hashlib.sha256(path.read_bytes()).hexdigest() if path.exists() else None


# ---------------------------------------------------------------------------
# the native mel frontend
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n_samples", [2560, 22050])
def test_native_mel_matches_numpy(n_samples):
    y = np.random.default_rng(n_samples).uniform(-0.9, 0.9, n_samples).astype(np.float32)
    got = port_native.mel_spectrogram_native(y)
    want = port_mel.mel_spectrogram_np(y)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=5e-4)
    np.testing.assert_array_equal(want, jax_mel.mel_spectrogram_np(y))
    lib = port_native.library_path()
    assert lib.parent == REPO / "build" / "matcha_tpu_torch" and lib.exists()


def test_native_build_goes_under_build_and_not_into_native(tmp_path, monkeypatch):
    before = _digest(JAX_LIB)
    monkeypatch.setattr(port_native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(port_native, "_lib", None)
    mel = port_native.mel_spectrogram_native(np.zeros(4096, np.float32))
    assert mel.shape == (80, 16)
    assert [p.name for p in (tmp_path / "build").iterdir()] == [port_native.library_path().name]
    assert port_native.library_path().name.startswith("libaudio-")
    assert _digest(JAX_LIB) == before


def test_frontend_when_the_build_fails(tmp_path, monkeypatch, caplog):
    (tmp_path / "broken.cpp").write_text("this is not C++\n")
    monkeypatch.setattr(port_native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(port_native, "SOURCE", tmp_path / "broken.cpp")
    monkeypatch.setattr(port_native, "_lib", None)
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        port_mel.resolve_mel_frontend("native")
    with caplog.at_level(logging.WARNING):
        assert port_mel.resolve_mel_frontend("auto") is port_mel.mel_spectrogram_np
    assert "native mel frontend unavailable" in caplog.text


# ---------------------------------------------------------------------------
# data statistics
# ---------------------------------------------------------------------------


def test_generate_data_statistics_equals_jax(corpus, tmp_path):  # noqa: F811
    args = ["-i", "ljspeech", "-b", "2", f"data.train_filelist_path={corpus['train']}",
            f"data.valid_filelist_path={corpus['val']}", f"data.cleaners=[{CLEANER}]",
            "data.n_feats=16", "data.f_max=4000"]
    jax_stats.main(args + ["-o", str(tmp_path / "jax.json")])
    port_stats.main(args + ["-o", str(tmp_path / "port.json")])
    want = json.loads((tmp_path / "jax.json").read_text())
    got = json.loads((tmp_path / "port.json").read_text())
    assert set(got) == {"mel_mean", "mel_std"}
    assert got == pytest.approx(want, rel=1e-6)
    with pytest.raises(SystemExit):  # an existing file needs --force
        port_stats.main(args + ["-o", str(tmp_path / "port.json")])


# ---------------------------------------------------------------------------
# image logging and the profiler
# ---------------------------------------------------------------------------


def test_plot_tensor_draws_jax_pixels():
    data = np.random.default_rng(2).normal(size=(16, 40)).astype(np.float32)
    got = port_utils.plot_tensor(data)
    assert got.dtype == np.uint8 and got.shape == (300, 1200, 3)
    np.testing.assert_array_equal(got, jax_utils.plot_tensor(data))


def test_validation_writes_image_tags(corpus, tmp_path):  # noqa: F811
    from tensorboard.backend.event_processing.event_accumulator import EventAccumulator

    from matcha_tpu_torch.training import data as port_data

    trainer = port_trainer.Trainer(
        MatchaTTS(**TINY_TRAIN), port_data.TextMelDataModule(**dm_args(corpus)), "cpu",
        lr=1e-3, max_epochs=1, output_dir=str(tmp_path), enable_checkpointing=False,
        loggers={"tensorboard": {}})
    trainer.fit()
    events = EventAccumulator(str(tmp_path / "tensorboard"), size_guidance={"images": 0})
    events.Reload()
    tags = set(events.Tags()["images"])
    assert tags == {f"{kind}/{i}" for i in (0, 1)
                    for kind in ("original", "generated_enc", "generated_dec", "alignment")}
    assert all(e.step == 0 and e.width == 1200 and e.height == 300
               for tag in tags for e in events.Images(tag))


def test_profiler_jax_traces_steps_1_to_3(corpus, tmp_path):  # noqa: F811
    out = tmp_path / "run"
    port_train.main([*TINY_OVERRIDES, "trainer.max_steps=4", "trainer.profiler=jax",
                     "data.batch_size=1", "logger=csv", f"paths.output_dir={out}",
                     f"data.train_filelist_path={corpus['train']}",
                     f"data.valid_filelist_path={corpus['val']}"])
    traces = list((out / "profile").iterdir())
    assert [p.name for p in traces] == ["trace_to_step_4.json"]
    trace = json.loads(traces[0].read_text())
    assert any(e.get("name", "").startswith("aten::") for e in trace["traceEvents"])


def test_unknown_profiler_is_not_dropped_silently(corpus, tmp_path, caplog):  # noqa: F811
    from matcha_tpu_torch.training import data as port_data

    with caplog.at_level(logging.WARNING):
        port_trainer.Trainer(MatchaTTS(**TINY_TRAIN), port_data.TextMelDataModule(
            **dm_args(corpus)), "cpu", output_dir=str(tmp_path), loggers={}, profiler="simple")
    assert "trainer.profiler='simple'" in caplog.text


# ---------------------------------------------------------------------------
# rematerialisation
# ---------------------------------------------------------------------------


def test_remat_gradients_equal_those_without(corpus):  # noqa: F811
    from matcha_tpu_torch.training import data as port_data

    batch = next(port_data.TextMelDataModule(**dm_args(corpus)).train_batches(0))
    batch = port_trainer.to_device(batch, "cpu")
    torch.manual_seed(3)
    plain = MatchaTTS(**TINY_TRAIN, dec_dropout=0.3)
    remat = MatchaTTS(**TINY_TRAIN, dec_dropout=0.3, remat=True)
    remat.load_state_dict(plain.state_dict())
    grads = []
    for model in (plain, remat):
        model.train()
        torch.manual_seed(11)  # dropout
        gen = torch.Generator().manual_seed(5)
        loss = sum(port_trainer.batch_losses(model, batch, None, gen))
        model.zero_grad()
        loss.backward()
        grads.append({n: p.grad.clone() for n, p in model.named_parameters()
                      if p.grad is not None})
    assert grads[0].keys() == grads[1].keys()
    assert any(n.startswith("decoder.estimator") for n in grads[0])
    for n in grads[0]:
        assert torch.equal(grads[0][n], grads[1][n]), n


# ---------------------------------------------------------------------------
# logger backends
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name,module", [("wandb", "wandb"), ("mlflow", "mlflow"),
                                         ("neptune", "neptune"), ("comet", "comet_ml"),
                                         ("aim", "aim")])
def test_logger_backend_warns_without_its_client(name, module, monkeypatch, caplog):
    monkeypatch.setitem(sys.modules, module, None)  # the import raises ImportError
    with caplog.at_level(logging.WARNING):
        jax_trainer.MetricLogger(None, None, backends={name: {}}).close()
        port = port_trainer.MetricLogger(None, None, backends={name: {}})
    port.scalars({"loss/train": 1.0}, 1)
    port.close()
    want = (f"logger backend {name!r} requested but its client library is not installed; "
            "skipping")
    assert [r.getMessage() for r in caplog.records] == [want, want]
