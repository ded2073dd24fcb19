"""The port's fixed-bucket serving path against the JAX package, on the CPU.

Both packages read the fabricated reference-format checkpoints of
tests/test_cli_e2e.py (a tiny Matcha with the full-width HiFi-GAN v1;
its durations come to about one mel frame per id). On the CPU the port
runs the fixed-bucket body eagerly, the plain version of its CUDA graph;
JAX runs ``_fused_fn`` with its plain vocoder. The port is handed the
noise JAX draws at each bucket: ``z = jax.random.normal(key, (B, T_y,
80))``, the same key at every bucket as JAX's fused path uses it.
``mel_lengths`` must be equal, the mel within atol 1e-5 and the waveform
within 5e-4, the tolerances (and reasons) of
``test_pipeline_matches_jax_dynamic_path``.
"""

import os
import subprocess
import sys
import warnings
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from matcha_tpu import cli as jax_cli
from matcha_tpu.text import segment as jax_segment
from matcha_tpu_torch import cli as port_cli
from matcha_tpu_torch import pipeline as port_pipeline
from matcha_tpu_torch.audio import stft
from matcha_tpu_torch.models.components import common, flow_matching
from matcha_tpu_torch.text import segment as port_segment
from matcha_tpu_torch.utils.utils import PCM24_SCALE
from tests.test_cli_e2e import fabricated_ckpts  # noqa: F401  (module fixture)

REPO = Path(__file__).resolve().parents[1]
CLEANER = "english_cleaners_no_espeak"
SHORT = "Hello world, the 2nd test."  # 59 ids
MEDIUM = "The birch canoe slid on the smooth planks."  # 85 ids
LONG = ("Printing, in the only sense with which we are at present concerned, differs from "
        "most if not from all the arts.")  # 223 ids
MEL_TOL, WAV_TOL = 1e-5, 5e-4


@pytest.fixture(scope="module")
def loaded(fabricated_ckpts):  # noqa: F811
    d = os.path.join(fabricated_ckpts, "matcha_tpu")
    matcha_path, voc_path = os.path.join(d, "matcha_ljspeech.ckpt"), os.path.join(d, "hifigan_T2_v1")
    return {"jax": (*jax_cli.load_matcha("matcha_ljspeech", matcha_path),
                    *jax_cli.load_vocoder("hifigan_T2_v1", voc_path)),
            "port": (port_cli.load_matcha(matcha_path, "cpu"),
                     *port_cli.load_vocoder(voc_path, "cpu"))}


def _pipes(loaded, vocoder=True, **kw):
    """A fresh (JAX, port) pipeline pair, with or without the vocoder."""
    model, params, voc, voc_params, bias = loaded["jax"]
    port_model, port_voc, port_bias = loaded["port"]
    if not vocoder:
        return (jax_cli.TTSPipeline(model, params, cleaner=CLEANER, **kw),
                port_pipeline.TTSPipeline(port_model, cleaner=CLEANER, device="cpu", **kw))
    return (jax_cli.TTSPipeline(model, params, voc, voc_params, bias, CLEANER, **kw),
            port_pipeline.TTSPipeline(port_model, port_voc, port_bias, CLEANER, device="cpu", **kw))


def _ids(text):
    tp = port_cli.process_text(0, text, CLEANER)
    return tp["x"], tp["x_lengths"]


def _noise(key, B=1):
    """The port's noise per bucket: JAX's draw at (B, T_y, 80)."""
    return lambda T_y: torch.from_numpy(
        np.array(jax.random.normal(key, (B, T_y, 80), dtype=jax.numpy.float32)))


def _spy_buckets(jax_pipe, port_pipe):
    """Record the mel bucket of every fixed-bucket body each side runs."""
    seen = {"jax": [], "port": []}
    jax_fn, port_fn = jax_pipe._fused_fn, port_pipe.fused_graph

    def jax_spy(T_x, T_y, *a, **k):
        seen["jax"].append(T_y)
        return jax_fn(T_x, T_y, *a, **k)

    def port_spy(B, T_x, T_y, *a, **k):
        seen["port"].append(T_y)
        return port_fn(B, T_x, T_y, *a, **k)

    jax_pipe._fused_fn, port_pipe.fused_graph = jax_spy, port_spy
    return seen


def test_fixed_bucket_matches_jax(loaded):
    """(a) An integer bucket (256) against JAX's fused graph."""
    jax_pipe, port_pipe = _pipes(loaded)
    x, xl = _ids(SHORT)
    key = jax.random.PRNGKey(4)
    want = jax_pipe.synthesise_batch(x, xl, key, n_timesteps=2, fixed_y_bucket=256)
    got = port_pipe.synthesise_batch(x, xl, n_timesteps=2, z=_noise(key), fixed_y_bucket=256)

    assert int(got["mel_lengths"][0]) == int(want["mel_lengths"][0]) < 256
    np.testing.assert_array_equal(got["mel_lengths"].numpy(), np.asarray(want["mel_lengths"]))
    assert got["mel"].shape == (1, 80, 256)
    np.testing.assert_allclose(got["mel"].numpy(), np.asarray(want["mel"]), atol=MEL_TOL)
    wav_t, wav_j = got["waveform"].numpy(), np.asarray(want["waveform"])
    assert wav_t.shape == wav_j.shape == (1, 256 * 256) and np.isfinite(wav_t).all()
    np.testing.assert_allclose(wav_t, wav_j, atol=WAV_TOL)

    wavs_t, mls_t = port_pipeline.fetch_fused_host(got)
    wavs_j, mls_j = jax_cli.fetch_fused_host(want)
    np.testing.assert_array_equal(mls_t, mls_j)
    np.testing.assert_allclose(wavs_t, wavs_j, atol=WAV_TOL + 2.0 / PCM24_SCALE)
    # the PCM24 bytes unpack to the clipped wav (the denoiser may overshoot +-1)
    np.testing.assert_allclose(wavs_t, np.clip(wav_t, -1, 1), atol=2.0 / PCM24_SCALE)


def test_f32_wire_packs_the_same_result(loaded):
    """Without pcm24_transfer the body ships the f32 rows with the lengths
    as a last column (``wav_packed``): the waveform itself, unquantised."""
    _, port_pipe = _pipes(loaded)
    port_pipe.pcm24_transfer = False
    x, xl = _ids(SHORT)
    got = port_pipe.synthesise_batch(x, xl, n_timesteps=2, z=_noise(jax.random.PRNGKey(4)),
                                     fixed_y_bucket=128)
    assert "wav_pcm24" not in got
    wavs, mls = port_pipeline.fetch_fused_host(got)
    np.testing.assert_array_equal(wavs, got["waveform"].numpy())
    np.testing.assert_array_equal(mls, got["mel_lengths"].numpy())


def test_auto_bucket_sequence_matches_jax(loaded):
    """(b) ``"auto"``: the first call at the top bucket, then the
    calibrated bucket, then a sandbagged ratio that escalates through the
    same buckets; the ratio and every result's lengths equal JAX's. The
    vocoder is left out here: the buckets depend only on the mel lengths."""
    jax_pipe, port_pipe = _pipes(loaded, vocoder=False)
    seen = _spy_buckets(jax_pipe, port_pipe)
    key = jax.random.PRNGKey(11)

    def both(text, **kw):
        x, xl = _ids(text)
        want = jax_pipe.synthesise_batch(x, xl, key, n_timesteps=2, fixed_y_bucket="auto", **kw)
        got = port_pipe.synthesise_batch(x, xl, n_timesteps=2, z=_noise(key),
                                         fixed_y_bucket="auto", **kw)
        np.testing.assert_array_equal(got["mel_lengths_host"], want["mel_lengths_host"])
        np.testing.assert_allclose(got["mel"].numpy(), np.asarray(want["mel"]), atol=MEL_TOL)
        assert port_pipe._dur_ratio == jax_pipe._dur_ratio
        return got

    both(SHORT)
    assert seen["port"] == seen["jax"] == [2048]
    both(MEDIUM)
    assert seen["port"] == seen["jax"] and len(seen["port"]) == 2 and seen["port"][1] < 2048
    jax_pipe._dur_ratio = port_pipe._dur_ratio = 1e-6
    n = len(seen["port"])
    both(LONG)
    assert seen["port"] == seen["jax"] and seen["port"][n:] == [64, 128, 256]


def test_auto_top_bucket_falls_back_like_jax(loaded):
    """(b) A result that reaches the largest bucket warns as JAX warns and
    comes from the dynamic path at full length."""
    jax_pipe, port_pipe = _pipes(loaded, vocoder=False)
    x, xl = _ids(LONG)
    key = jax.random.PRNGKey(12)
    with pytest.warns(UserWarning, match="saturated the largest fused mel bucket") as w_j:
        want = jax_pipe.synthesise_batch(x, xl, key, n_timesteps=2, length_scale=10.0,
                                         fixed_y_bucket="auto")
    with pytest.warns(UserWarning, match="saturated the largest fused mel bucket") as w_t:
        got = port_pipe.synthesise_batch(x, xl, n_timesteps=2, length_scale=10.0, z=_noise(key),
                                         fixed_y_bucket="auto")
    assert [str(w.message) for w in w_t] == [str(w.message) for w in w_j]
    assert int(got["mel_lengths_host"][0]) == int(want["mel_lengths_host"][0]) > 2048
    assert got["mel"].shape == tuple(np.asarray(want["mel"]).shape)
    np.testing.assert_allclose(got["mel"].numpy(), np.asarray(want["mel"]), atol=MEL_TOL)
    assert port_pipe._dur_ratio is None and jax_pipe._dur_ratio is None


def test_auto_fallback_keeps_raw_pcm24_delivery(loaded):
    """(b) ``raw_pcm24`` through the top-bucket fallback: the packed rows
    arrive as ``pcm24_bytes_host`` from the dynamic path, as in JAX. The
    bucket table is cut to (64,) on both sides, so that the vocoder runs
    at 64 and 128 frames rather than 2048."""
    jax_pipe, port_pipe = _pipes(loaded)
    jax_pipe.FUSED_Y_BUCKETS = port_pipe.FUSED_Y_BUCKETS = (64,)
    x, xl = _ids(MEDIUM)
    key = jax.random.PRNGKey(13)
    with pytest.warns(UserWarning, match="(64 frames)") as w_j:
        want = jax_pipe.synthesise_batch(x, xl, key, n_timesteps=2, fixed_y_bucket="auto",
                                         raw_pcm24=True)
    with pytest.warns(UserWarning, match="(64 frames)") as w_t:
        got = port_pipe.synthesise_batch(x, xl, n_timesteps=2, z=_noise(key),
                                         fixed_y_bucket="auto", raw_pcm24=True)
    assert [str(w.message) for w in w_t] == [str(w.message) for w in w_j]
    raw_t, raw_j = got["pcm24_bytes_host"], want["pcm24_bytes_host"]
    assert raw_t.dtype == np.uint8 and raw_t.shape == raw_j.shape
    np.testing.assert_array_equal(got["mel_lengths_host"], want["mel_lengths_host"])
    assert int(got["mel_lengths_host"][0]) == 85
    wav_t, ml_t = port_pipeline.fetch_fused_host(got)
    wav_j, ml_j = jax_cli.fetch_fused_host(want)
    np.testing.assert_array_equal(ml_t, ml_j)
    np.testing.assert_allclose(wav_t, wav_j, atol=WAV_TOL + 2.0 / PCM24_SCALE)


def test_calibration_matches_jax():
    """(c) ``observe_dur_ratio`` and the fit of ``"auto"`` (``fit_y_bucket``
    over ``FUSED_Y_BUCKETS``) against JAX's ``_auto_y_bucket`` over a
    seeded sequence of ratios (with outliers that leave the 64-long
    window), token counts and length scales."""
    jax_pipe = jax_cli.TTSPipeline(None, None)  # the calibration needs no model
    port_pipe = port_pipeline.TTSPipeline(torch.nn.Module(), device="cpu")
    assert port_pipeline.TTSPipeline.FUSED_Y_BUCKETS == jax_cli.TTSPipeline.FUSED_Y_BUCKETS
    assert port_pipeline.TTSPipeline.FUSED_MARGIN == jax_cli.TTSPipeline.FUSED_MARGIN
    rng = np.random.default_rng(21)
    cases = [(int(n), float(s)) for n, s in zip(rng.integers(1, 700, 12),
                                                rng.choice([0.5, 0.85, 0.95, 1.0, 1.3, 2.0], 12))]
    buckets = port_pipeline.TTSPipeline.FUSED_Y_BUCKETS
    for n, s in cases:
        assert port_pipe.fit_y_bucket(buckets, n, s) == jax_pipe._auto_y_bucket(n, s) == 2048
    for obs in np.concatenate([rng.uniform(0.5, 4.0, 100), [40.0], rng.uniform(0.5, 2.0, 80)]):
        jax_pipe.observe_dur_ratio(obs)
        port_pipe.observe_dur_ratio(obs)
        assert port_pipe._dur_ratio == jax_pipe._dur_ratio
        for n, s in cases:
            assert port_pipe.fit_y_bucket(buckets, n, s) == jax_pipe._auto_y_bucket(n, s)


def test_guarded_fetch_reruns_a_saturated_bucket_like_jax(loaded):
    """(d) An integer bucket the utterance overflows (64 for 85 frames):
    the same warning as JAX, and the full-length result of the dynamic
    path; JAX's result beside it."""
    jax_pipe, port_pipe = _pipes(loaded)
    x, xl = _ids(MEDIUM)
    key = jax.random.PRNGKey(14)
    with pytest.warns(UserWarning, match="fixed-y-bucket 64 saturated") as w_j:
        out_j, wav_j, ml_j = jax_cli.synth_fetch_guarded(jax_pipe, x, xl, key, fixed_y_bucket=64,
                                                         n_timesteps=2)
    with pytest.warns(UserWarning, match="fixed-y-bucket 64 saturated") as w_t:
        out_t, wav_t, ml_t = port_cli.synth_fetch_guarded(port_pipe, x, xl, fixed_y_bucket=64,
                                                          n_timesteps=2, z=_noise(key))
    assert [str(w.message) for w in w_t] == [str(w.message) for w in w_j]
    assert int(ml_t[0]) == int(ml_j[0]) == 85
    assert out_t["mel"].shape == (1, 80, 128) and wav_t.shape == wav_j.shape == (1, 128 * 256)
    np.testing.assert_allclose(out_t["mel"].numpy(), np.asarray(out_j["mel"]), atol=MEL_TOL)
    np.testing.assert_allclose(wav_t, wav_j, atol=WAV_TOL)


def test_guarded_fetch_keeps_a_bucket_that_fits(loaded):
    """(d) A bucket that fits (128 for 59 frames): no warning, no second
    call, the fixed-bucket result itself."""
    _, port_pipe = _pipes(loaded)
    calls = []
    synth = port_pipe.synthesise_batch
    port_pipe.synthesise_batch = lambda *a, **k: calls.append(k) or synth(*a, **k)
    x, xl = _ids(SHORT)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        out, wavs, mls = port_cli.synth_fetch_guarded(
            port_pipe, x, xl, fixed_y_bucket=128, n_timesteps=2, z=_noise(jax.random.PRNGKey(15)))
    assert len(calls) == 1 and calls[0]["fixed_y_bucket"] == 128
    assert int(mls[0]) == 59 and wavs.shape == (1, 128 * 256) and out["mel"].shape == (1, 80, 128)


SEGMENT_CASES = [
    ("Hello world. How are you? I am fine!", 20),
    ("Dr. Smith met Mr. Jones. They talked.", 30),
    ("One. Two. Three. Four.", 12),
    (("word " * 50).strip(), 26),
    ("", 500),
    ("   ", 500),
    ('He said "stop." Then he left… And returned.', 25),
    ("e.g. this one. Col. Mustard, etc. Ltd. vs. St. Paul! Is it?! Yes... no.", 40),
    ("A" * 1200 + " short. Tail", 500),
]


@pytest.mark.parametrize("text,max_chars", SEGMENT_CASES)
def test_split_sentences_matches_jax(text, max_chars):
    """(e) The port's copy of ``text/segment.py`` splits as JAX's does."""
    assert (port_segment.split_sentences(text, max_chars=max_chars)
            == jax_segment.split_sentences(text, max_chars=max_chars))
    assert port_segment._ends_with_abbrev(text) == jax_segment._ends_with_abbrev(text)


@pytest.mark.parametrize("n", [1, 2, 10, 41, 47, 55, 61, 64])
def test_capture_safe_constants_are_bit_equal(n):
    """The forms that copy nothing from the host equal the ones they
    replaced bit for bit: the Euler schedule, the timestep embedding's
    log(10000) and the STFT windows."""
    old_step = torch.tensor(1.0) / n
    old = torch.arange(n + 1, dtype=torch.float32) * old_step
    assert torch.equal(flow_matching.euler_schedule(n, "cpu"), old)
    t = torch.linspace(0, 1, n + 1)
    half = 80 // 2
    old_emb = torch.exp(torch.arange(half, dtype=torch.float32)
                        * -(torch.log(torch.tensor(10000.0)) / (half - 1)))
    old_emb = 1000.0 * t[:, None] * old_emb[None, :]
    assert torch.equal(common.SinusoidalPosEmb(80)(t),
                       torch.cat([torch.sin(old_emb), torch.cos(old_emb)], dim=-1))
    assert torch.equal(stft._window(1024, torch.device("cpu")),
                       torch.from_numpy(stft.hann_window_periodic(1024)))
    wsq = np.zeros((1024 + 256 * (n - 1),), np.float64)
    for f in range(n):
        wsq[f * 256:f * 256 + 1024] += stft.hann_window_periodic(1024).astype(np.float64) ** 2
    assert torch.equal(stft._window_square_sum(1024, 256, 1024, n, torch.device("cpu")),
                       torch.from_numpy(wsq.astype(np.float32)))


def test_stft_constants_are_never_evicted():
    """A captured graph reads the window and the ISTFT normaliser by
    address: after ``istft`` has run at 100 other lengths (more than the
    32 buckets of the fixed-bucket path), the first length's tensors are
    still the ones cached at the start."""
    cpu = torch.device("cpu")
    first = stft._window_square_sum(1024, 256, 1024, 9, cpu), stft._window(1024, cpu)
    for n in range(10, 110):
        stft.istft(torch.ones(513, n), torch.zeros(513, n))
    assert stft._window_square_sum(1024, 256, 1024, 9, cpu) is first[0]
    assert stft._window(1024, cpu) is first[1]


def _wav_samples(path):
    import wave

    with wave.open(str(path)) as f:
        return f.getnframes()


def test_cli_modes_on_the_cpu_load_no_jax(fabricated_ckpts, tmp_path):  # noqa: F811
    """(f) The CLI in one subprocess: ``--fixed-y-bucket auto`` over a
    3-line ``--file``, ``--batched --batch_size 2`` over it, and
    ``--long-form``. Each wav holds mel frames x 256 samples, a .png of the
    mel is beside it, and no JAX module is loaded."""
    lines = tmp_path / "lines.txt"
    lines.write_text(f"{SHORT}\n{MEDIUM}\nhi there\n", encoding="utf-8")
    common_args = ["--cleaner", CLEANER, "--steps", "2", "--cpu"]
    runs = {
        "auto": ["--file", str(lines), "--fixed-y-bucket", "auto"],
        "batched": ["--file", str(lines), "--batched", "--batch_size", "2"],
        "long": ["--text", f"{SHORT} {MEDIUM} Dr. Smith is here.", "--long-form",
                 "--fixed-y-bucket", "128"],
    }
    # torch on 2 threads, as the suite's other CPU-heavy files: it runs
    # beside 5 other workers, where 8 threads each oversubscribe the cores
    code = ["import sys", "import torch", "torch.set_num_threads(2)",
            "from matcha_tpu_torch.cli import cli"]
    for name, argv in runs.items():
        code.append(f"cli({argv + common_args + ['--output_folder', str(tmp_path / name)]!r})")
    code += ["bad = [m for m in sys.modules if m.split('.')[0] in "
             "('jax', 'jaxlib', 'flax', 'matcha_tpu')]",
             "assert not bad, bad", "print('NO_JAX_OK')"]
    env = dict(os.environ, MATCHA_HOME=fabricated_ckpts)
    res = subprocess.run([sys.executable, "-c", "\n".join(code)], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=280)
    assert res.returncode == 0, res.stderr[-3000:]
    assert "NO_JAX_OK" in res.stdout
    expected = {"auto": ["utterance_001", "utterance_002", "utterance_003"],
                "batched": ["utterance_000", "utterance_001", "utterance_002"],
                "long": ["utterance_long_form"]}
    for name, bases in expected.items():
        for base in bases:
            mel = np.load(tmp_path / name / f"{base}.npy")
            assert mel.shape[0] == 80 and np.isfinite(mel).all()
            assert _wav_samples(tmp_path / name / f"{base}.wav") == mel.shape[1] * 256
            assert (tmp_path / name / f"{base}.png").stat().st_size > 0
    long_mel = np.load(tmp_path / "long" / "utterance_long_form.npy")
    assert long_mel.shape[1] > 85 + 59  # three sentences, concatenated
