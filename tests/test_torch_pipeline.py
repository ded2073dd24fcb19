"""The port's synthesis pipeline and CLI against the JAX package.

Both packages read the same fabricated reference-format checkpoints (the
tiny Matcha of tests/test_cli_e2e.py with the full-width HiFi-GAN v1) and
run the dynamic path: encode -> mel bucket -> decode -> vocoder bucket ->
vocode -> clip -> denoise. The port is handed the noise JAX draws.
``mel_lengths`` must be equal. The mel (|mel| <= ~11) agrees to atol
1e-5 (measured ~1e-6); the waveform to 5e-4 (measured ~7e-5): the random
full-width vocoder amplifies the mel's last-digit differences through
four 512..32-channel stages (its output saturates at +-1), and the JAX
side takes its plain conv path while the port takes the fused-MRF path
(its plain version here).
"""

import ast
import os
import subprocess
import sys
import wave
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from matcha_tpu import cli as jax_cli
from matcha_tpu_torch import cli as port_cli
from matcha_tpu_torch import pipeline as port_pipeline
from matcha_tpu_torch.utils.utils import PCM24_SCALE, pack_pcm24, unpack_pcm24
from tests.test_cli_e2e import fabricated_ckpts  # noqa: F401  (module fixture)

REPO = Path(__file__).resolve().parents[1]
CLEANER = "english_cleaners_no_espeak"


def _paths(home):
    d = os.path.join(home, "matcha_tpu")
    return os.path.join(d, "matcha_ljspeech.ckpt"), os.path.join(d, "hifigan_T2_v1")


def test_pipeline_matches_jax_dynamic_path(fabricated_ckpts):  # noqa: F811
    matcha_path, voc_path = _paths(fabricated_ckpts)
    model, params = jax_cli.load_matcha("matcha_ljspeech", matcha_path)
    vocoder, voc_params, bias = jax_cli.load_vocoder("hifigan_T2_v1", voc_path)
    jax_pipe = jax_cli.TTSPipeline(model, params, vocoder, voc_params, bias, CLEANER)
    port_pipe = port_pipeline.TTSPipeline(port_cli.load_matcha(matcha_path, "cpu"),
                                          *port_cli.load_vocoder(voc_path, "cpu"),
                                          cleaner=CLEANER, device="cpu")

    tp = port_cli.process_text(0, "Hello world, the 2nd test.", CLEANER)
    assert tp["x"].tolist() == jax_cli.process_text(0, "Hello world, the 2nd test.",
                                                    CLEANER)["x"].tolist()
    key = jax.random.PRNGKey(4)
    want = jax_pipe.synthesise_batch(tp["x"], tp["x_lengths"], key, n_timesteps=2)
    T_y = want["mel"].shape[-1]
    z = np.array(jax.random.normal(key, (1, T_y, 80), dtype=jax.numpy.float32))
    got = port_pipe.synthesise_batch(tp["x"], tp["x_lengths"], n_timesteps=2,
                                     z=torch.from_numpy(z))

    np.testing.assert_array_equal(got["mel_lengths"].numpy(), np.asarray(want["mel_lengths"]))
    np.testing.assert_allclose(got["mel"].numpy(), np.asarray(want["mel"]), atol=1e-5)
    wav_j, wav_t = np.asarray(want["waveform"]), got["waveform"].numpy()
    assert wav_t.shape == wav_j.shape and np.isfinite(wav_t).all()
    np.testing.assert_allclose(wav_t, wav_j, atol=5e-4)

    packed = port_pipe.synthesise_batch(tp["x"], tp["x_lengths"], n_timesteps=2,
                                        z=torch.from_numpy(z), pack_wav=True)["wav_pcm24"]
    wav_u, ml = unpack_pcm24(packed.numpy())
    np.testing.assert_array_equal(ml, got["mel_lengths"].numpy())
    # the denoiser may overshoot +-1 slightly; packing clips
    np.testing.assert_allclose(wav_u, np.clip(wav_t, -1, 1), atol=2.0 / PCM24_SCALE)


def test_pack_pcm24_bytes_are_identical():
    rng = np.random.default_rng(9)
    wav = rng.uniform(-1.2, 1.2, size=(2, 300)).astype(np.float32)
    wav[0, :6] = [1.0, -1.0, 0.0, -1e-9, 3e-7, -3e-7]  # clip and truncation edges
    lengths = np.array([7, 1234567], np.int32)
    want = np.asarray(jax_cli._pack_pcm24(jax.numpy, jax.numpy.asarray(wav),
                                          jax.numpy.asarray(lengths)))
    got = pack_pcm24(torch.from_numpy(wav), torch.from_numpy(lengths)).numpy()
    assert got.dtype == np.uint8
    np.testing.assert_array_equal(got, want)
    w, ml = unpack_pcm24(got)
    np.testing.assert_array_equal(ml, lengths)
    np.testing.assert_array_equal(w, jax_cli._unpack_pcm24(want)[0])


def test_buckets_match():
    assert port_pipeline.X_BUCKETS == jax_cli.X_BUCKETS
    assert port_pipeline.Y_BUCKETS == jax_cli.Y_BUCKETS
    assert port_pipeline.VOC_BUCKETS == jax_cli.VOC_BUCKETS
    for n in (1, 32, 33, 2048, 2049, 5000):
        assert (port_pipeline.pick_bucket(n, port_pipeline.Y_BUCKETS)
                == jax_cli.pick_bucket(n, jax_cli.Y_BUCKETS))


def _read_wav(path):
    with wave.open(str(path)) as f:
        assert f.getframerate() == 22050 and f.getsampwidth() == 3
        raw = np.frombuffer(f.readframes(f.getnframes()), np.uint8).reshape(-1, 3)
    v = raw[:, 0].astype(np.int32) | (raw[:, 1].astype(np.int32) << 8) | (raw[:, 2].astype(np.int32) << 16)
    return ((v ^ 0x800000) - 0x800000) / float(2**23 - 1)


def test_cli_writes_a_wav(fabricated_ckpts, tmp_path, monkeypatch):  # noqa: F811
    monkeypatch.setenv("MATCHA_HOME", fabricated_ckpts)
    out = tmp_path / "out"
    port_cli.cli(["--text", "hello world", "--cleaner", CLEANER, "--steps", "2", "--cpu",
                  "--output_folder", str(out), "--seed", "3"])
    audio = _read_wav(out / "utterance_001.wav")
    mel = np.load(out / "utterance_001.npy")
    assert mel.shape[0] == 80 and audio.size == mel.shape[1] * 256
    assert np.isfinite(audio).all()


def test_cli_missing_checkpoint_names_the_path(tmp_path, monkeypatch):
    monkeypatch.setenv("MATCHA_HOME", str(tmp_path))
    with pytest.raises(FileNotFoundError, match="matcha_ljspeech.ckpt"):
        port_cli.cli(["--text", "hi", "--cpu", "--output_folder", str(tmp_path)])


def test_entry_points_refuse_to_fall_back_to_the_cpu(fabricated_ckpts, tmp_path,  # noqa: F811
                                                     monkeypatch):
    """Without a GPU and without device="cpu" / --cpu, every entry point
    raises instead of running on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setenv("MATCHA_HOME", fabricated_ckpts)
    matcha_path, voc_path = _paths(fabricated_ckpts)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_cli.load_matcha(matcha_path)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_cli.load_vocoder(voc_path)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_pipeline.TTSPipeline(port_cli.load_matcha(matcha_path, "cpu"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_cli.cli(["--text", "hi", "--cleaner", CLEANER, "--output_folder", str(tmp_path)])


def test_cli_subprocess_loads_no_jax(fabricated_ckpts, tmp_path):  # noqa: F811
    code = (
        "import sys\n"
        "from matcha_tpu_torch.cli import cli\n"
        f"cli(['--text', 'no jax here', '--cleaner', '{CLEANER}', '--steps', '1', '--cpu',"
        f" '--output_folder', {str(tmp_path)!r}])\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'flax', 'matcha_tpu')]\n"
        "assert not bad, bad\n"
        "print('NO_JAX_OK')\n"
    )
    env = dict(os.environ, MATCHA_HOME=fabricated_ckpts)
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=240)
    assert res.returncode == 0, res.stderr[-2000:]
    assert "NO_JAX_OK" in res.stdout
    assert (tmp_path / "utterance_001.wav").exists()


def _imported_modules(path: Path):
    for node in ast.walk(ast.parse(path.read_text(encoding="utf-8"))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            yield node.module


def test_port_sources_import_no_jax():
    files = sorted((REPO / "matcha_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(files) > 15
    for path in files:
        for mod in _imported_modules(path):
            assert mod.split(".")[0] not in ("jax", "jaxlib", "flax", "matcha_tpu"), (path, mod)
