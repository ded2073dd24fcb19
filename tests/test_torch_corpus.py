"""The port's staged corpus synthesis and chunked vocoder against the JAX
package, on the CPU.

Both packages read the fabricated reference-format checkpoints of
tests/test_cli_e2e.py (a tiny Matcha with the full-width HiFi-GAN v1).
JAX's ``synthesise_corpus`` draws each batch's noise from
``fold_in(key, batch index)``; the port is handed that draw through its
``z(batch_index, B, T_y)``. The batch lists and ``mel_lengths_host`` must
be equal, the mel within 1e-5 and the waveform within 5e-4, the
tolerances (and reasons) of ``tests/test_torch_fused.py``. On the CPU the
fused stage runs its body eagerly, the plain version of its CUDA graph.
"""

import copy
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
from matcha_tpu_torch import pipeline as port_pipeline
from tests.test_cli_e2e import fabricated_ckpts  # noqa: F401  (module fixture)
from tests.test_torch_fused import CLEANER, MEL_TOL, WAV_TOL, _pipes, loaded  # noqa: F401

REPO = Path(__file__).resolve().parents[1]
# the fused stage against the split one, as JAX's test_fused_corpus_stage_matches_split
STAGE_MEL_TOL, STAGE_WAV_TOL = 1e-6, 1e-5
# chunked against whole-utterance vocoding (JAX's test_chunked_vocoder_matches_full)
CHUNK_TOL = 1e-5


def _corpus(seed=21, n=7):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, 178, size=(int(k),)).astype(np.int32)
            for k in rng.integers(8, 40, size=n)]


def _jax_noise(key):
    """The port's noise per batch: JAX's draw for batch ``bi``."""
    return lambda bi, B, T_y: torch.from_numpy(np.array(jax.random.normal(
        jax.random.fold_in(key, bi), (B, T_y, 80), dtype=jax.numpy.float32)))


@pytest.fixture(scope="module")
def pipes(loaded):  # noqa: F811
    """One (JAX, port) pair for the module: JAX compiles each shape once."""
    return _pipes(loaded)


@pytest.mark.parametrize("stage_window", [64, 2])
def test_corpus_matches_jax(pipes, stage_window):
    """7 utterances in batches of 3 (3 batches; 2 windows at
    ``stage_window=2``): the same batches in the same order, equal host
    lengths, the mel and the waveform within the port's tolerances."""
    jax_pipe, port_pipe = pipes
    utts = _corpus()
    key = jax.random.PRNGKey(13)
    want = list(jax_pipe.synthesise_corpus(utts, key, n_timesteps=1, batch_size=3,
                                           stage_window=stage_window))
    got = list(port_pipe.synthesise_corpus(utts, n_timesteps=1, batch_size=3,
                                           stage_window=stage_window, z=_jax_noise(key)))
    assert [c for c, _ in got] == [c for c, _ in want]
    assert len(got) == 3
    for (_, g), (_, w) in zip(got, want):
        np.testing.assert_array_equal(g["mel_lengths_host"], w["mel_lengths_host"])
        np.testing.assert_array_equal(g["mel_lengths"].numpy(), g["mel_lengths_host"])
        assert g["mel"].shape == tuple(np.asarray(w["mel"]).shape)
        np.testing.assert_allclose(g["mel"].numpy(), np.asarray(w["mel"]), atol=MEL_TOL)
        wav_g, wav_w = g["waveform"].numpy(), np.asarray(w["waveform"])
        assert wav_g.shape == wav_w.shape and np.isfinite(wav_g).all()
        np.testing.assert_allclose(wav_g, wav_w, atol=WAV_TOL)


def test_fused_stage_matches_split(pipes):
    """``fuse_stages=True`` (one ``StageGraph`` body per bucket triple)
    against the split stages on generators seeded alike: the same batches
    and lengths, the mel within 1e-6 and the waveform within 1e-5, and
    ``first_sample`` is the waveform's first sample."""
    _, port_pipe = pipes
    utts = _corpus(seed=5, n=5)
    runs = {fuse: list(port_pipe.synthesise_corpus(
        utts, n_timesteps=1, batch_size=2, fuse_stages=fuse,
        generator=torch.Generator().manual_seed(3))) for fuse in (False, True)}
    split, fused = runs[False], runs[True]
    assert [c for c, _ in split] == [c for c, _ in fused]
    stage_keys = [k for k in port_pipe._graphs if k[0] == "stage"]
    assert len(stage_keys) == len({(*o["attn"].shape, o["waveform"].shape[-1] // 256)
                                   for _, o in fused})  # one per (B, T_x, T_y, T_voc)
    for (_, a), (_, b) in zip(split, fused):
        assert "first_sample" in b and "first_sample" not in a
        np.testing.assert_array_equal(a["mel_lengths_host"], b["mel_lengths_host"])
        np.testing.assert_allclose(a["mel"].numpy(), b["mel"].numpy(), rtol=STAGE_MEL_TOL,
                                   atol=STAGE_MEL_TOL)
        np.testing.assert_allclose(a["waveform"].numpy(), b["waveform"].numpy(),
                                   rtol=STAGE_WAV_TOL, atol=STAGE_WAV_TOL)
        assert float(b["first_sample"]) == float(b["waveform"][0, 0])


def test_corpus_matches_per_batch_path(pipes):
    """Each staged batch equals ``synthesise_batch`` on the same ids and
    noise (the dynamic path picks the same buckets), as JAX's
    test_corpus_serving_matches_per_batch holds its own."""
    _, port_pipe = pipes
    utts = _corpus(seed=0, n=5)
    noise = lambda bi, B, T_y: torch.randn(B, T_y, 80, generator=torch.Generator().manual_seed(bi))
    staged = list(port_pipe.synthesise_corpus(utts, n_timesteps=1, batch_size=2, z=noise))
    order = sorted(range(5), key=lambda i: len(utts[i]))
    for bi, (chunk, out) in enumerate(staged):
        assert chunk == order[bi * 2:bi * 2 + 2]
        x = np.zeros((len(chunk), max(len(utts[i]) for i in chunk)), np.int32)
        xl = np.asarray([len(utts[i]) for i in chunk], np.int32)
        for row, idx in enumerate(chunk):
            x[row, :len(utts[idx])] = utts[idx]
        ref = port_pipe.synthesise_batch(x, xl, n_timesteps=1,
                                         z=lambda T_y: noise(bi, len(chunk), T_y))
        np.testing.assert_array_equal(out["mel_lengths_host"], ref["mel_lengths"].numpy())
        assert torch.equal(out["mel"], ref["mel"])
        assert torch.equal(out["waveform"], ref["waveform"])


class _HostReads(torch.Tensor):
    """A tensor that counts every read of its values on the host; what
    is computed from it stays one. ``cpu()`` hands back a plain tensor, so
    one copy to the host counts once however its values are read after."""

    reads = 0
    HOST = {"cpu", "numpy", "item", "tolist", "__int__", "__float__", "__bool__", "__index__",
            "__array__", "__format__"}

    @classmethod
    def __torch_function__(cls, func, types, args=(), kwargs=None):
        name = getattr(func, "__name__", "")
        out = super().__torch_function__(func, types, args, kwargs or {})
        if name in cls.HOST:
            cls.reads += 1
            if isinstance(out, torch.Tensor):
                out = out.as_subclass(torch.Tensor)
        return out


@pytest.mark.parametrize("fuse", [False, True])
def test_one_host_copy_per_window(pipes, monkeypatch, fuse):
    """The predicted lengths reach the host once per window and nothing
    else of the encoder's outputs does: 3 batches in windows of 2 read
    them twice, the first time before the first batch is yielded and the
    second before the third."""
    _, port_pipe = pipes
    encode = port_pipe.model.encode

    def counted(*a, **k):
        mu_x, w_ceil, y_lengths = encode(*a, **k)
        return (mu_x.as_subclass(_HostReads), w_ceil.as_subclass(_HostReads),
                y_lengths.as_subclass(_HostReads))

    monkeypatch.setattr(port_pipe.model, "encode", counted)
    monkeypatch.setattr(_HostReads, "reads", 0)
    reads = []
    for chunk, out in port_pipe.synthesise_corpus(_corpus(n=6), n_timesteps=1, batch_size=2,
                                                  stage_window=2, fuse_stages=fuse,
                                                  generator=torch.Generator().manual_seed(1)):
        reads.append(_HostReads.reads)
    assert reads == [1, 1, 2]


def test_chunked_vocoder_matches_jax_and_unchunked(loaded, monkeypatch):  # noqa: F811
    """``vocoder_chunk=48`` over a mel of at least 3 windows (no denoiser,
    as JAX's own test). The windows, their halo and the stitching within
    1e-5 of the whole utterance, with the generator run in float64 (its
    plain copy): in float32 on the CPU this random-weight generator moves
    by 3-5e-5 under any change of rounding (a 1e-7 relative change of the
    mel, or the same mel at another batch size), so a halo shorter than
    the receptive field would show only there. In float32 the chunked
    waveform within the port's tolerance of JAX's chunked vocoder and of
    its own whole-utterance one, on the same noise."""
    model, params, voc, voc_params, _ = loaded["jax"]
    port_model, port_voc, _ = loaded["port"]
    jax_pipe = jax_cli.TTSPipeline(model, params, voc, voc_params, None, CLEANER, vocoder_chunk=48)
    full, chunked = (port_pipeline.TTSPipeline(port_model, port_voc, None, CLEANER, device="cpu",
                                               vocoder_chunk=c) for c in (0, 48))
    rng = np.random.default_rng(9)
    x = rng.integers(1, 178, size=(2, 60)).astype(np.int32)
    xl = np.asarray([60, 41], np.int32)
    key = jax.random.PRNGKey(7)
    z = lambda T_y: torch.from_numpy(np.array(jax.random.normal(key, (2, T_y, 80))))
    want = jax_pipe.synthesise_batch(x, xl, key, n_timesteps=1, length_scale=3.0)
    ref = full.synthesise_batch(x, xl, n_timesteps=1, length_scale=3.0, z=z)
    got = chunked.synthesise_batch(x, xl, n_timesteps=1, length_scale=3.0, z=z)
    w_got, w_ref, w_jax = got["waveform"].numpy(), ref["waveform"].numpy(), np.asarray(want["waveform"])
    assert w_got.shape == w_ref.shape == w_jax.shape
    mel = got["mel"].transpose(1, 2)
    assert mel.shape[1] >= 3 * 48, "the mel is too short to cut into 3 windows"
    np.testing.assert_allclose(w_got, w_jax, atol=WAV_TOL)
    np.testing.assert_allclose(w_got, w_ref, atol=WAV_TOL)

    # the first row's first 160 frames: 4 windows, the last a short one
    mel = mel[:1, :160]
    gen64 = copy.deepcopy(port_voc).double()
    monkeypatch.setattr(port_pipeline, "generator_apply_fused",
                        lambda gen, m, w, **kw: gen64(m.double()))
    whole64, chunked64 = full._generate(mel), chunked._generate(mel)
    assert whole64.dtype == torch.float64 and whole64.shape == (1, 160 * 256, 1)
    np.testing.assert_allclose(chunked64.numpy(), whole64.numpy(), rtol=CHUNK_TOL, atol=CHUNK_TOL)


def _wav_frames(path):
    with wave.open(str(path)) as f:
        return f.getnframes()


def test_cli_staged_writes_what_jax_writes(fabricated_ckpts, tmp_path, monkeypatch):  # noqa: F811
    """``--batched --staged`` (and with ``--fused-stage --vocoder-chunk``)
    in one subprocess that loads no JAX module, against JAX's CLI on the
    same 3-line file: the same ``.wav`` and ``.npy`` files, each mel of the
    same length and each wav of mel frames x 256 samples."""
    lines = tmp_path / "lines.txt"
    lines.write_text("hello world\nthe quick brown fox\na longer sentence for the third line\n",
                     encoding="utf-8")
    common = ["--file", str(lines), "--batched", "--staged", "--batch_size", "2",
              "--cleaner", CLEANER, "--steps", "1", "--seed", "3"]
    monkeypatch.setenv("MATCHA_HOME", fabricated_ckpts)
    jax_cli.cli(common + ["--output_folder", str(tmp_path / "jax")])

    runs = {"split": [], "fused": ["--fused-stage", "--vocoder-chunk", "64"]}
    code = ["import sys", "from matcha_tpu_torch.cli import cli"]
    for name, extra in runs.items():
        code.append(f"cli({common + extra + ['--cpu', '--output_folder', str(tmp_path / name)]!r})")
    code += ["bad = [m for m in sys.modules if m.split('.')[0] in "
             "('jax', 'jaxlib', 'flax', 'matcha_tpu')]",
             "assert not bad, bad", "print('NO_JAX_OK')"]
    env = dict(os.environ, MATCHA_HOME=fabricated_ckpts)
    res = subprocess.run([sys.executable, "-c", "\n".join(code)], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=280)
    assert res.returncode == 0, res.stderr[-3000:]
    assert "NO_JAX_OK" in res.stdout
    assert res.stdout.count("Corpus Matcha-TTS + VOCODER RTF") == 2

    def outputs(folder):
        return sorted(p.name for p in folder.iterdir() if p.suffix in (".wav", ".npy"))

    expected = outputs(tmp_path / "jax")
    assert expected == [f"utterance_{i:03d}{s}" for i in range(3) for s in (".npy", ".wav")]
    for name in runs:
        assert outputs(tmp_path / name) == expected
        for i in range(3):
            base = f"utterance_{i:03d}"
            mel = np.load(tmp_path / name / f"{base}.npy")
            want = np.load(tmp_path / "jax" / f"{base}.npy")
            assert mel.shape == want.shape and np.isfinite(mel).all()
            assert (_wav_frames(tmp_path / name / f"{base}.wav")
                    == _wav_frames(tmp_path / "jax" / f"{base}.wav") == mel.shape[1] * 256)


def test_graph_launch_counts_groups_device_events_by_launch():
    """``scripts/trace_settle.graph_launch_counts`` (``chip_smoke.py``'s
    count of K1 inside replays): the device events that share a
    ``cudaGraphLaunch``'s correlation id, per launch in launch order; host
    events and device events of other calls are not counted."""
    from types import SimpleNamespace

    from matcha_tpu_torch.scripts.trace_settle import graph_launch_counts

    cuda, cpu = torch.autograd.DeviceType.CUDA, torch.autograd.DeviceType.CPU

    def ev(name, cid, dev):
        return SimpleNamespace(name=lambda: name, correlation_id=lambda: cid,
                               device_type=lambda: dev)

    events = [ev("cudaGraphLaunch", 7, cpu), ev("cudaGraphLaunch", 3, cpu),
              ev("void mrf_stage_kernel<64>(float const*)", 3, cuda),
              ev("void mrf_stage_kernel<32>(float const*)", 3, cuda),
              ev("elementwise_kernel", 3, cuda), ev("mrf_stage_kernel", 3, cpu),
              ev("void mrf_stage_kernel<64>(float const*)", 7, cuda),
              ev("void mrf_stage_kernel<64>(float const*)", 99, cuda)]
    prof = SimpleNamespace(profiler=SimpleNamespace(
        kineto_results=SimpleNamespace(events=lambda: events)))
    assert graph_launch_counts(prof) == {"graph_launches": 2, "device_events_per_launch": [3, 1],
                                         "k1_per_launch": [2, 1]}


def test_trace_settle_corpus_and_cpu_refusal():
    """The script's corpus is bench.py's filelist (128 utterances of
    64-192 ids, the same for the same seed), and it needs the card."""
    from matcha_tpu_torch.scripts import trace_settle

    utts = trace_settle.corpus_utterances()
    assert len(utts) == 128 and all(64 <= len(u) <= 192 for u in utts)
    assert all(u.dtype == np.int32 and u.min() >= 1 and u.max() <= 177 for u in utts)
    assert all(np.array_equal(a, b) for a, b in zip(utts, trace_settle.corpus_utterances()))
    with pytest.raises(SystemExit, match="needs a CUDA device"):
        trace_settle.main(["--passes", "1"])
