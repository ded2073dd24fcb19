"""The port's framework-free tools against the JAX package's: metrics,
the CLI's argument checks, the mel plot, the denoiser's bias modes, the
TPE sweep, the phonemiser, and the training entry's ``extras``.

Each module is the port's own copy (it imports nothing of
``matcha_tpu``); here both run on the same inputs and must give the same
answer: exactly for the pure-Python and text tools, to 1e-12 for the
float64 metrics.
"""

import math
import struct
import sys
import warnings
import zlib

import numpy as np
import pytest
import torch

from matcha_tpu import cli as jax_cli
from matcha_tpu.text import phonemize as jax_phonemize
from matcha_tpu.training import sweep as jax_sweep
from matcha_tpu.utils import config as jax_config
from matcha_tpu.utils import metrics as jax_metrics
from matcha_tpu.utils import utils as jax_utils
from matcha_tpu_torch import cli as port_cli
from matcha_tpu_torch import train as port_train
from matcha_tpu_torch.models.denoiser import compute_bias_spec
from matcha_tpu_torch.text import phonemize as port_phonemize
from matcha_tpu_torch.training import sweep as port_sweep
from matcha_tpu_torch.utils import config as port_config
from matcha_tpu_torch.utils import metrics as port_metrics
from matcha_tpu_torch.utils import utils as port_utils
from tests.test_torch_train import CLEANER, TEXTS, corpus  # noqa: F401 (fixture)

METRIC_TOL = 1e-12


@pytest.fixture(scope="module", autouse=True)
def two_threads():
    """torch on 2 threads: the suite runs 6 workers on the host's cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


# ---------------------------------------------------------------------------
# (a) metrics
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n_out,n_in", [(13, 80), (20, 80), (13, 16)])
def test_dct_matrix_matches_jax(n_out, n_in):
    """The orthonormal DCT-II basis, equal to JAX's within 1e-12."""
    np.testing.assert_allclose(port_metrics.dct_matrix(n_out, n_in),
                               jax_metrics.dct_matrix(n_out, n_in), rtol=0, atol=METRIC_TOL)


@pytest.mark.parametrize("exclude_c0,lengths", [(True, None), (False, None), (True, 37)])
def test_mcd_and_mfcc_match_jax(exclude_c0, lengths):
    """mel_to_mfcc, mcd (with and without c0, truncated or not) and
    log_mel_l1 on seeded log-mels of unequal lengths, within 1e-12 of
    JAX's."""
    rng = np.random.default_rng(3)
    a = rng.normal(-5.0, 2.0, size=(80, 61)).astype(np.float32)
    b = a[:, :55] + rng.normal(0, 0.3, size=(80, 55)).astype(np.float32)
    np.testing.assert_allclose(port_metrics.mel_to_mfcc(a), jax_metrics.mel_to_mfcc(a),
                               rtol=0, atol=METRIC_TOL)
    got = port_metrics.mcd(a, b, exclude_c0=exclude_c0, lengths=lengths)
    want = jax_metrics.mcd(a, b, exclude_c0=exclude_c0, lengths=lengths)
    assert got > 0 and abs(got - want) <= METRIC_TOL
    assert abs(port_metrics.log_mel_l1(a, b) - jax_metrics.log_mel_l1(a, b)) <= METRIC_TOL
    assert port_metrics.mcd(a, a) == 0.0


# ---------------------------------------------------------------------------
# (e) the CLI's argument checks
# ---------------------------------------------------------------------------

VALIDATE_CASES = {
    "ljspeech": ["--text", "hi"],
    "ljspeech_spk_ignored": ["--text", "hi", "--spk", "3"],
    "ljspeech_other_vocoder": ["--text", "hi", "--vocoder", "hifigan_univ_v1"],
    "vctk_no_spk": ["--text", "hi", "--model", "matcha_vctk"],
    "vctk_mismatched_vocoder": ["--text", "hi", "--model", "matcha_vctk", "--vocoder",
                                "hifigan_T2_v1", "--spk", "5"],
    "vctk_spk_out_of_range": ["--text", "hi", "--model", "matcha_vctk", "--spk", "108"],
    "custom_no_vocoder": ["--text", "hi", "--checkpoint_path", "model.ckpt"],
    "custom_univ_rate": ["--text", "hi", "--checkpoint_path", "model.ckpt", "--vocoder",
                         "hifigan_univ_v1", "--speaking_rate", "1.2"],
    "negative_temperature": ["--text", "hi", "--temperature", "-1"],
    "no_text": ["--steps", "3"],
}


def _validated(pkg, argv):
    """((model, vocoder, speaking_rate, spk) or the error's text, the
    warnings' texts)."""
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        try:
            a = pkg.validate_args(pkg.build_parser().parse_args(argv))
            result = (a.model, a.vocoder, a.speaking_rate, a.spk)
        except (AssertionError, SystemExit) as e:
            result = ("error", str(e))
    return result, [str(w.message) for w in caught if w.category is UserWarning]


@pytest.mark.parametrize("case", list(VALIDATE_CASES))
def test_validate_args_matches_jax(case):
    """Each model's default vocoder, speaking rate and speaker, the
    warnings, and the refusals (JAX asserts; the port exits with the same
    message) are JAX's, exactly."""
    got = _validated(port_cli, VALIDATE_CASES[case])
    want = _validated(jax_cli, VALIDATE_CASES[case])
    assert got == want
    if case.endswith("out_of_range"):
        assert got[0][0] == "error" and "between (0, 107)" in got[0][1]


def test_missing_model_names_its_url(tmp_path, monkeypatch):
    """A named model that is not on disk: FileNotFoundError naming the
    path and the published URL; nothing is downloaded."""
    monkeypatch.setenv("MATCHA_HOME", str(tmp_path))
    args = port_cli.validate_args(port_cli.build_parser().parse_args(
        ["--text", "hi", "--model", "matcha_vctk"]))
    with pytest.raises(FileNotFoundError, match="matcha_vctk.ckpt") as e:
        port_cli.assert_required_models_available(args)
    assert port_cli.MATCHA_URLS["matcha_vctk"] in str(e.value)
    assert not list(tmp_path.rglob("*.ckpt"))
    with pytest.raises(NotImplementedError, match="not implemented"):
        port_cli.load_vocoder(tmp_path / "x", "cpu", name="waveglow")


# ---------------------------------------------------------------------------
# (g) the mel plot
# ---------------------------------------------------------------------------


def read_png(path) -> np.ndarray:
    """An 8-bit RGB PNG with filter byte 0 rows -> (H, W, 3) uint8,
    checking the signature and every chunk's CRC."""
    data = open(path, "rb").read()
    assert data[:8] == b"\x89PNG\r\n\x1a\n"
    pos, chunks = 8, []
    while pos < len(data):
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        kind, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + n]
        (crc,) = struct.unpack(">I", data[pos + 8 + n:pos + 12 + n])
        assert crc == zlib.crc32(kind + body) & 0xFFFFFFFF
        chunks.append((kind, body))
        pos += 12 + n
    assert [k for k, _ in chunks] == [b"IHDR", b"IDAT", b"IEND"]
    w, h, depth, color, comp, filt, interlace = struct.unpack(">IIBBBBB", chunks[0][1])
    assert (depth, color, comp, filt, interlace) == (8, 2, 0, 0, 0)
    rows = np.frombuffer(zlib.decompress(chunks[1][1]), np.uint8).reshape(h, 1 + 3 * w)
    assert not rows[:, 0].any()
    return rows[:, 1:].reshape(h, w, 3)


def test_save_plot_matches_jax_with_matplotlib(tmp_path):
    """With matplotlib: the pixels of JAX's 12 x 3 inch figure, exactly."""
    from matplotlib.image import imread

    mel = np.random.default_rng(0).normal(size=(80, 120)).astype(np.float32)
    port_utils.save_plot(mel, tmp_path / "port.png")
    jax_utils.save_plot(mel, str(tmp_path / "jax.png"))
    got, want = imread(tmp_path / "port.png"), imread(tmp_path / "jax.png")
    assert got.shape == want.shape == (300, 1200, 4)
    np.testing.assert_array_equal(got, want)


def test_save_plot_without_matplotlib_writes_the_numpy_rendering(tmp_path, monkeypatch):
    """With the matplotlib import made to fail: a valid 8-bit RGB PNG
    (signature, IHDR, one zlib IDAT, IEND, CRCs, filter byte 0) whose
    pixels equal ``plot_tensor``'s numpy rendering exactly; matplotlib's
    own reader agrees once it is back."""
    mel = np.random.default_rng(1).normal(size=(80, 37)).astype(np.float32)
    with monkeypatch.context() as m:
        m.setitem(sys.modules, "matplotlib", None)
        port_utils.save_plot(mel, tmp_path / "mel.png")
        want = port_utils.plot_tensor(mel)
    assert want.shape == (80, 37, 3) and want.dtype == np.uint8
    np.testing.assert_array_equal(read_png(tmp_path / "mel.png"), want)
    from matplotlib.image import imread

    np.testing.assert_array_equal(np.round(imread(tmp_path / "mel.png") * 255), want)


# ---------------------------------------------------------------------------
# (h) the denoiser's bias modes
# ---------------------------------------------------------------------------


def _toy_vocoder(mel: torch.Tensor) -> torch.Tensor:
    """(1, T, 80) -> (1, T * 256): a deterministic stand-in generator."""
    return torch.tanh(mel.mean(-1)).repeat_interleave(256, dim=1)


def test_bias_spec_normal_mode_is_reproducible_and_unknown_modes_raise():
    """``mode="normal"`` draws its mel from the generator: the same seed
    gives the same spectrum, another seed another one, and both differ
    from ``"zeros"``; an unknown mode raises ValueError with JAX's
    message. Exact comparisons (one process, one CPU)."""
    a = compute_bias_spec(_toy_vocoder, mode="normal", generator=torch.Generator().manual_seed(3))
    b = compute_bias_spec(_toy_vocoder, mode="normal", generator=torch.Generator().manual_seed(3))
    c = compute_bias_spec(_toy_vocoder, mode="normal", generator=torch.Generator().manual_seed(4))
    zeros = compute_bias_spec(_toy_vocoder)
    assert a.shape == zeros.shape == (513, 1)
    assert torch.equal(a, b) and not torch.equal(a, c) and not torch.equal(a, zeros)
    with pytest.raises(ValueError, match="Mode uniform is not supported"):
        compute_bias_spec(_toy_vocoder, mode="uniform")


# ---------------------------------------------------------------------------
# (j) the sweep
# ---------------------------------------------------------------------------


def _objective(cfg):
    """A deterministic metric of the three swept parameters."""
    lr = float(cfg["model"]["optimizer"]["lr"])
    bs = int(cfg["data"]["batch_size"])
    p = float(cfg["model"]["encoder"]["encoder_params"]["p_dropout"])
    return {"loss/val": (math.log10(lr) + 4.0) ** 2 + abs(bs - 32) / 32 + (p - 0.1) ** 2}


@pytest.mark.parametrize("kind", ["tpe", "random"])
def test_run_sweep_matches_jax(kind):
    """The same sweep config and objective: identical trial histories
    (every proposed parameter and metric), best value, params and
    overrides in both packages."""
    overrides = ["hparams_search=matcha_optuna", f"hparams_search.sweeper.kind={kind}",
                 "hparams_search.sweeper.n_trials=12",
                 "hparams_search.sweeper.n_startup_trials=4", "run_name=sweeptest"]
    got = port_sweep.run_sweep(overrides, objective=_objective)
    want = jax_sweep.run_sweep(overrides, objective=_objective)
    assert len(got["history"]) == 12
    assert got["history"] == want["history"]
    assert (got["metric"], got["params"], got["overrides"]) == (
        want["metric"], want["params"], want["overrides"])


def test_sweep_trial_configs_share_no_state():
    """Each trial's config is composed anew: editing one leaves the next
    composition as it was."""
    overrides = ["hparams_search=matcha_optuna", "model.optimizer.lr=0.001"]
    first = port_config.compose("train", overrides)
    first["model"]["optimizer"]["lr"] = 7.0
    first["data"]["cleaners"].append("x")
    second = port_config.compose("train", overrides)
    assert second["model"]["optimizer"]["lr"] == 0.001
    assert "x" not in second["data"]["cleaners"]


# ---------------------------------------------------------------------------
# (k) the phonemiser
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n_spks", [1, 3])
def test_phonemize_filelist_matches_jax(tmp_path, n_spks):
    """One speaker and several: the same bytes as JAX's, with a text that
    holds a '|' of its own, numbers and abbreviations."""
    texts = TEXTS[:3] + ["Dr. Smith paid $5 | then left at 10:30."]
    lines = [f"wavs/u{i}.wav|{i % n_spks}|{t}" if n_spks > 1 else f"wavs/u{i}.wav|{t}"
             for i, t in enumerate(texts)]
    src = tmp_path / "in.txt"
    src.write_text("\n".join(lines) + "\n", encoding="utf-8")
    n = port_phonemize.main([str(src), str(tmp_path / "port.txt"), "--cleaner", CLEANER,
                             "--n-spks", str(n_spks)])
    jax_phonemize.phonemize_filelist(str(src), str(tmp_path / "jax.txt"), CLEANER, n_spks)
    assert n == len(texts)
    assert (tmp_path / "port.txt").read_bytes() == (tmp_path / "jax.txt").read_bytes()


# ---------------------------------------------------------------------------
# (l) the training entry's extras
# ---------------------------------------------------------------------------


def tiny_train_overrides(corpus, out_dir) -> list:
    return [
        "trainer.accelerator=cpu", "trainer.max_steps=1", "logger=csv",
        f"paths.output_dir={out_dir}", f"data.train_filelist_path={corpus['train']}",
        f"data.valid_filelist_path={corpus['val']}", "data.batch_size=2",
        f"data.cleaners=[{CLEANER}]", "data.n_feats=16", "data.f_max=4000", "data.num_workers=0",
        "model.n_feats=16", "model.encoder.encoder_params.n_channels=16",
        "model.encoder.encoder_params.filter_channels=32",
        "model.encoder.encoder_params.filter_channels_dp=16",
        "model.encoder.encoder_params.n_layers=1", "model.decoder.channels=[16,16]",
        "model.decoder.num_mid_blocks=1", "model.decoder.num_heads=1",
        "model.decoder.attention_head_dim=16", "callbacks.model_checkpoint.every_n_epochs=1000",
    ]


def test_format_config_tree_matches_jax(corpus, tmp_path):  # noqa: F811
    """The config tree's text, for the same overrides, is JAX's."""
    overrides = tiny_train_overrides(corpus, tmp_path) + ["experiment=ljspeech"]
    assert (port_config.format_config_tree(port_config.compose("train", overrides))
            == jax_config.format_config_tree(jax_config.compose("train", overrides)))


@pytest.mark.parametrize("tags", ["config", "none"])
def test_train_main_writes_jax_extras_logs(corpus, tmp_path, tags):  # noqa: F811
    """``train.main`` applies the config's ``extras`` before training:
    the files it writes into the output directory besides the run's are
    JAX's ``extras``' for the same composed config, with the same text
    (``config_tree.log`` always; ``tags.log`` when the config has no tags,
    as JAX's ``enforce_tags`` writes it only then)."""
    out = tmp_path / "run"
    overrides = tiny_train_overrides(corpus, out) + ([] if tags == "config" else ["tags=[]"])
    jax_utils.extras(jax_config.compose("train", overrides))
    want = {p.name: p.read_text(encoding="utf-8") for p in out.iterdir()}
    for p in out.iterdir():
        p.unlink()
    port_train.main(overrides)
    got = {name: (out / name).read_text(encoding="utf-8") for name in want}
    assert sorted(want) == (["config_tree.log"] if tags == "config"
                            else ["config_tree.log", "tags.log"])
    assert got == want
    assert (out / "config.yaml").exists() and (out / "csv" / "metrics.csv").exists()
    if tags == "none":
        assert got["tags.log"] == "dev\n"


def test_sweep_main_trains_each_trial_on_the_cpu(corpus, tmp_path, monkeypatch):  # noqa: F811
    """``python -m matcha_tpu_torch.training.sweep`` (its ``main``) with
    the default objective, the port's ``train.train``: two trials of one
    step on the tiny config, each a finite ``loss/val`` from its own
    validation, and a finite best."""
    seen = []
    real = port_sweep.run_sweep
    monkeypatch.setattr(port_sweep, "run_sweep", lambda argv: seen.append(real(argv)))
    space = {"model.optimizer.lr": "loguniform(1e-5, 1e-3)",
             "model.encoder.encoder_params.p_dropout": "uniform(0.0, 0.3)"}
    port_sweep.main(tiny_train_overrides(corpus, tmp_path / "sweep") + [
        "hparams_search.sweeper.n_trials=2", f"hparams_search.sweeper.params={space!r}"])
    (best,) = seen
    assert len(best["history"]) == 2 and all(math.isfinite(v) for _, v in best["history"])
    assert best["metric"] == min(v for _, v in best["history"])
    assert (tmp_path / "sweep" / "checkpoints" / "last").exists()
