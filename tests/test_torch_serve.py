"""The port's serving daemon (``matcha_tpu_torch/serve.py``) on the CPU.

Every case of tests/test_serve.py, run against the port (with the JAX
suite's ``slow`` marks), over a loopback socket, with the tiny fabricated
checkpoint of tests/test_cli_e2e.py and the full-width HiFi-GAN v1; plus
the port's own: a request's mel frames against JAX's ``synthesise_batch``,
a lone request against the port's fixed-bucket path on the same per-call
generator, ``main`` in a subprocess with no JAX module loaded, the flags
that are not ported, and the offered-load script.
"""

import io
import json
import os
import queue as _queue
import signal
import subprocess
import sys
import threading
import urllib.error
import urllib.request
import wave
from collections import deque
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from matcha_tpu import cli as jax_cli
from matcha_tpu_torch import cli as port_cli
from matcha_tpu_torch import pipeline as port_pipeline
from matcha_tpu_torch import serve
from matcha_tpu_torch.scripts import bench_serve
from matcha_tpu_torch.serve import BatchingServer, make_http_server
from matcha_tpu_torch.text import text_to_sequence
from matcha_tpu_torch.utils.utils import PCM24_SCALE
from tests.test_cli_e2e import fabricated_ckpts  # noqa: F401  (fixture reuse)
from tests.test_torch_multispeaker import ms_home  # noqa: F401  (fixture reuse)

REPO = Path(__file__).resolve().parents[1]
CLEANER = "english_cleaners_no_espeak"


@pytest.fixture(scope="module")
def serve_pipeline(fabricated_ckpts):  # noqa: F811
    """One port pipeline for the module; each test gets its own server
    (queues, counters, threads)."""
    d = os.path.join(fabricated_ckpts, "matcha_tpu")
    model = port_cli.load_matcha(os.path.join(d, "matcha_ljspeech.ckpt"), "cpu")
    vocoder, bias = port_cli.load_vocoder(os.path.join(d, "hifigan_T2_v1"), "cpu")
    return port_pipeline.TTSPipeline(model, vocoder, bias, CLEANER, device="cpu")


@pytest.fixture()
def batcher(serve_pipeline):
    b = BatchingServer(serve_pipeline, max_batch=4, batch_window_ms=200.0, n_timesteps=1)
    yield b
    b.shutdown()


def _http(batcher):
    server = make_http_server(batcher, "127.0.0.1", 0)  # an ephemeral port
    threading.Thread(target=server.serve_forever, daemon=True).start()
    return server, f"http://127.0.0.1:{server.server_address[1]}"


def _post(url, payload, timeout=300):
    req = urllib.request.Request(url, data=json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        return resp.status, dict(resp.headers), resp.read()


def _run_threads(threads, timeout=300.0):
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout)
    assert not any(t.is_alive() for t in threads), "a client thread did not finish"


def _bare_batcher(max_batch=4, window_ms=50.0):
    """A BatchingServer shell with no threads and no pipeline: _enqueue,
    _take_batch and the chunking are queue and text logic only."""
    b = object.__new__(BatchingServer)
    # a single-speaker model's pipeline: speaker ids pass through unchecked
    b.pipeline = type("P", (), {"cleaner": CLEANER, "model": type("M", (), {"n_spks": 1})()})()
    b.default_rate = 1.0
    b.default_spk = None
    b.max_warm_x = None
    b._lock = threading.Lock()
    b.n_requests = 0
    b._q = _queue.Queue()
    b._bulk_backlog = deque()
    b._busy = False
    b._in_flight = 0
    b.max_batch = max_batch
    b.batch_window_s = window_ms / 1e3
    return b


@pytest.mark.slow
def test_concurrent_requests_merge_into_one_batch(batcher):
    """4 concurrent submits inside the window -> one batch."""
    batcher.warmup([(32, 128)])
    results = [None] * 4
    texts = ["hello there", "more words here", "short", "a tiny text"]

    def worker(i):
        results[i] = batcher.submit(texts[i], timeout_s=300.0)

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(4)]
    n0 = batcher.n_batches
    _run_threads(threads)
    for r in results:
        assert r.error is None
        assert r.wav is not None and r.wav.size == r.n_frames * 256
        assert np.isfinite(r.wav).all()
    assert batcher.n_batches == n0 + 1, "requests did not merge into one batch"


def test_mixed_speaking_rates_split_groups(batcher):
    """Different speaking rates run as separate groups; the slower rate
    gives at least as many frames."""
    out = [None, None]

    def w(i, rate):
        out[i] = batcher.submit("some text", speaking_rate=rate, timeout_s=300.0)

    ts = [threading.Thread(target=w, args=(0, 1.0)), threading.Thread(target=w, args=(1, 2.0))]
    n0 = batcher.n_batches
    _run_threads(ts)
    assert all(r.error is None for r in out)
    assert batcher.n_batches >= n0 + 1
    assert out[1].n_frames >= out[0].n_frames


def test_http_server_end_to_end(batcher):
    """POST /synthesise returns a 24-bit WAV, JSON on request; /healthz
    counts; a malformed request is a 400 and the server lives on."""
    server, url = _http(batcher)
    try:
        status, headers, wav_data = _post(url + "/synthesise", {"text": "hello from the server"})
        assert status == 200 and headers["Content-Type"] == "audio/wav"
        assert float(headers["X-Latency-Ms"]) > 0
        with wave.open(io.BytesIO(wav_data)) as f:
            assert (f.getnchannels(), f.getsampwidth(), f.getframerate()) == (1, 3, 22050)
            assert f.getnframes() > 0

        _, _, body = _post(url + "/synthesise", {"text": "again", "format": "json"})
        meta = json.loads(body)
        assert meta["n_samples"] > 0 and meta["rtf"] > 0
        assert set(meta) == {"n_samples", "audio_seconds", "latency_ms", "rtf"}

        with urllib.request.urlopen(f"{url}/healthz", timeout=30) as resp:
            health = json.loads(resp.read())
        assert health["status"] == "ok" and health["requests"] >= 2
        assert set(health) == {"status", "batches", "requests", "fast", "reruns",
                               "frames_answered", "frames_decoded", "queue_depth"}
        assert health["frames_answered"] <= health["frames_decoded"]

        bad = urllib.request.Request(f"{url}/synthesise", data=b"{}")
        with pytest.raises(urllib.error.HTTPError) as ei:
            urllib.request.urlopen(bad, timeout=30)
        assert ei.value.code == 400
    finally:
        server.shutdown()
        server.server_close()


def test_enqueue_quantizes_rate_and_applies_defaults():
    """Client rates snap to the 0.05 grid in [0.5, 2.0], an omitted spk
    gets the default, and texts beyond the largest warmed x bucket are
    refused up front."""
    b = _bare_batcher()
    b.default_spk = 3
    req = b._enqueue("hello", None, None)
    assert req.spk == 3 and req.speaking_rate == 1.0
    assert b._enqueue("hello", 1.517, 5).speaking_rate == 1.5
    assert b._enqueue("hello", 1.517, 5).spk == 5
    assert b._enqueue("hello", 99.0, None).speaking_rate == 2.0
    assert b._enqueue("hello", 0.01, None).speaking_rate == 0.5
    assert (b._enqueue("x", 0.949, None).speaking_rate
            == b._enqueue("x", 0.951, None).speaking_rate == 0.95)
    assert b.n_requests == 7

    b.max_warm_x = 8
    with pytest.raises(ValueError, match="too long"):
        b._enqueue("this sentence is far beyond eight ids", None, None)


@pytest.mark.slow
def test_pipelined_scheduler_opt_in(batcher):
    """The opt-in pipelined scheduler (a responder thread fetches) returns
    well-formed results and drains its in-flight count to zero."""
    b = BatchingServer(batcher.pipeline, max_batch=4, batch_window_ms=50.0, n_timesteps=1,
                       pipelined=True)
    try:
        results = [None] * 3
        texts = ["hello there", "more words", "short"]

        def worker(i):
            results[i] = b.submit(texts[i], timeout_s=300.0)

        _run_threads([threading.Thread(target=worker, args=(i,)) for i in range(3)])
        for r in results:
            assert r.error is None
            assert r.wav is not None and r.wav.size == r.n_frames * 256
            assert np.isfinite(r.wav).all()
        assert b._in_flight == 0
    finally:
        b.shutdown()


def test_fit_chunks_respects_warmed_bucket():
    """Long-form chunks fit the warmed x bucket even where the cleaner
    expands the text (numbers -> words), and no word is lost."""
    b = _bare_batcher()
    b.max_warm_x = 64
    text = ("The year 1999 was quite memorable for many people. "
            "Speech synthesis improved dramatically in recent years. "
            "Monotonic alignment search finds the best path through the grid.")
    chunks = b._fit_chunks(text, max_chars=200)
    assert len(chunks) >= 2
    assert " ".join(chunks).split() == text.split()
    for c in chunks:
        n_ids = 2 * len(text_to_sequence(c, [CLEANER])) + 1
        assert n_ids <= 64, f"chunk exceeds warmed bucket: {c!r} -> {n_ids}"
    b.max_warm_x = None
    assert b._fit_chunks(text, max_chars=200)


def test_default_rate_is_trusted_verbatim():
    """The operator's default rate is kept as given; client rates clamp."""
    b = _bare_batcher()
    b.default_rate = 3.5
    assert b._enqueue("hello", None, None).speaking_rate == 3.5
    assert b._enqueue("hello", 3.5, None).speaking_rate == 2.0


@pytest.mark.slow
def test_fused_single_fast_path_and_saturation_fallback(batcher, monkeypatch):
    """A lone request replays a registered fast-path bucket; one whose
    result saturates the bucket runs again on the dynamic path, so its
    audio is never cut."""
    text = "hello there"
    r0 = batcher.submit(text, timeout_s=600.0)
    assert r0.error is None
    n = r0.n_frames
    T_x = port_pipeline.pick_bucket(len(r0.seq), port_pipeline.X_BUCKETS)

    calls = []
    orig = batcher.pipeline.synthesise_batch

    def spy(*a, **k):
        calls.append(k)
        return orig(*a, **k)

    monkeypatch.setattr(batcher.pipeline, "synthesise_batch", spy)
    T_big = 64 * ((n // 64) + 2)
    batcher._fused_warm[(T_x, batcher.default_rate, False)] = [T_big]
    r1 = batcher.submit(text, timeout_s=600.0)
    assert r1.error is None and r1.n_frames == n
    assert np.isfinite(r1.wav).all() and r1.wav.size == n * 256
    assert calls and calls[-1].get("fixed_y_bucket") == T_big
    assert batcher.n_fast == 1 and batcher.n_rerun == 0

    T_small = max(16, (n - 1) // 16 * 16)
    assert T_small < n
    batcher._fused_warm[(T_x, batcher.default_rate, False)] = [T_small]
    calls.clear()
    r2 = batcher.submit(text, timeout_s=600.0)
    assert r2.error is None and r2.n_frames == n, "the fallback must not cut the audio"
    assert r2.wav.size == n * 256
    assert any(k.get("fixed_y_bucket") == T_small for k in calls)
    assert any(k.get("pack_wav") for k in calls)
    assert batcher.n_fast == 2 and batcher.n_rerun == 1
    assert batcher.frames_answered == 3 * n < batcher.frames_decoded


def test_stream_first_chunk_urgent_marking():
    """A stream's first chunk is urgent only on an idle server; every
    chunk is bulk-class."""
    b = _bare_batcher()
    text = "One sentence here. Another one follows. And then a third."
    reqs = list(b.submit_stream(text, timeout_s=0.01, max_chars=30))
    assert len(reqs) >= 2
    assert reqs[0].urgent and not any(r.urgent for r in reqs[1:])
    assert all(r.bulk for r in reqs)

    while not b._q.empty():
        b._q.get()
    b._busy = True
    reqs2 = list(b.submit_stream(text, timeout_s=0.01, max_chars=30))
    assert not any(r.urgent for r in reqs2)


def test_interactive_over_bulk_scheduling():
    """Interactive requests take batch slots first, bulk chunks fill the
    rest and carry over FIFO; with no interactive traffic bulk fills whole
    batches; the sentinel ends collection."""
    b = _bare_batcher(max_batch=4)
    bulk = [b._enqueue(f"chunk {i}", None, None, bulk=True) for i in range(6)]
    inter = [b._enqueue(f"question {i}", None, None) for i in range(2)]

    batch = b._take_batch()
    assert batch[:2] == inter
    assert batch[2:] == bulk[:2] and len(batch) == 4
    assert list(b._bulk_backlog) == bulk[2:]
    assert b._take_batch() == bulk[2:]
    assert not b._bulk_backlog

    bulk2 = [b._enqueue(f"late chunk {i}", None, None, bulk=True) for i in range(5)]
    first = b._take_batch()
    assert first == bulk2[:4] and list(b._bulk_backlog) == bulk2[4:]
    i2 = b._enqueue("urgent question", None, None)
    batch2 = b._take_batch()
    assert batch2[0] is i2 and batch2[1:] == bulk2[4:]

    tail = [b._enqueue(f"tail chunk {i}", None, None, bulk=True) for i in range(2)]
    inter3 = [b._enqueue(f"q{i}", None, None) for i in range(4)]
    assert b._take_batch() == inter3
    assert list(b._bulk_backlog) == tail

    b._q.put(None)
    b._bulk_backlog.clear()
    assert b._take_batch() == []


def test_parse_warmup():
    assert serve._parse_warmup("128:512,256:1024") == [(128, 512), (256, 1024)]
    assert serve._parse_warmup("") == []


def test_long_form_endpoint_merges_chunks(batcher):
    """/synthesise_long: the chunks merge into at most 2 batches and the
    wav is their concatenation."""
    server, url = _http(batcher)
    try:
        text = ("This is the first sentence. Here comes a second one! "
                "And finally a third, slightly longer sentence?")
        n0 = batcher.n_batches
        _, _, body = _post(url + "/synthesise_long", {"text": text, "format": "json",
                                                      "max_chars": 30}, timeout=600)
        assert json.loads(body)["n_samples"] > 0
        assert batcher.n_batches - n0 <= 2
        assert batcher.n_requests >= 3
    finally:
        server.shutdown()
        server.server_close()


def test_streaming_endpoint(batcher):
    """/synthesise_stream: the WAV header first, then 24-bit PCM per chunk;
    as many samples as the long-form endpoint gives the same text."""
    import http.client
    import struct

    server, url = _http(batcher)
    try:
        text = "First sentence here. Second one follows! Third ends it?"
        _, _, body = _post(url + "/synthesise_long", {"text": text, "format": "json",
                                                      "max_chars": 30}, timeout=600)
        expected_samples = json.loads(body)["n_samples"]

        conn = http.client.HTTPConnection("127.0.0.1", server.server_address[1], timeout=600)
        conn.request("POST", "/synthesise_stream", body=json.dumps({"text": text, "max_chars": 30}),
                     headers={"Content-Type": "application/json"})
        resp = conn.getresponse()
        assert resp.status == 200
        assert resp.getheader("Content-Type") == "audio/wav"
        assert resp.getheader("X-Sample-Rate") == "22050"
        header = resp.read(44)
        assert header[:4] == b"RIFF" and header[8:12] == b"WAVE"
        assert struct.unpack("<I", header[24:28])[0] == 22050
        pcm = resp.read()
        conn.close()
        assert len(pcm) == expected_samples * 3
    finally:
        server.shutdown()
        server.server_close()


def test_http_fuzz_malformed_requests(batcher):
    """Malformed inputs get a 4xx (413 for an oversized body, 404 for an
    unknown path), never a dropped connection, and the server lives on."""
    server, url = _http(batcher)

    def post(path, data, headers=None):
        req = urllib.request.Request(url + path, data=data,
                                     headers={"Content-Type": "application/json",
                                              **(headers or {})})
        try:
            with urllib.request.urlopen(req, timeout=30) as resp:
                return resp.status
        except urllib.error.HTTPError as e:
            return e.code

    try:
        cases = [
            ("no text key", "/synthesise", b"{}", None),
            ("non-JSON body", "/synthesise", b"this is not json", None),
            ("invalid UTF-8", "/synthesise", b"\xff\xfe{", None),
            ("JSON array payload", "/synthesise", b"[1, 2, 3]", None),
            ("JSON scalar payload", "/synthesise", b"42", None),
            ("bad max_chars (stream parse)", "/synthesise_stream",
             json.dumps({"text": "hi", "max_chars": "lots"}).encode(), None),
            ("bad max_chars (long)", "/synthesise_long",
             json.dumps({"text": "hi", "max_chars": "lots"}).encode(), None),
            ("bad Content-Length header", "/synthesise", b"{}", {"Content-Length": "banana"}),
            ("text not a string", "/synthesise", json.dumps({"text": 42}).encode(), None),
            ("text null (stream parse)", "/synthesise_stream",
             json.dumps({"text": None}).encode(), None),
            ("bad speaking_rate type (stream parse)", "/synthesise_stream",
             json.dumps({"text": "hi", "speaking_rate": "fast"}).encode(), None),
            ("bad spk type", "/synthesise", json.dumps({"text": "hi", "spk": "abc"}).encode(),
             None),
        ]
        for name, path, data, headers in cases:
            code = post(path, data, headers)
            assert 400 <= code < 500, f"{name}: expected 4xx, got {code}"
        try:
            code = post("/synthesise", b"x" * ((1 << 20) + 1))
            assert code == 413, f"oversized body: expected 413, got {code}"
        except urllib.error.URLError:
            pass  # a broken pipe while uploading the refused body
        code = post("/synthesise_long", json.dumps({"text": "short text", "max_chars": 0,
                                                    "format": "json"}).encode())
        assert code == 200
        assert post("/nope", b"{}", None) == 404
        try:
            with urllib.request.urlopen(f"{url}/nope", timeout=30) as resp:
                get_code = resp.status
        except urllib.error.HTTPError as e:
            get_code = e.code
        assert get_code == 404
    finally:
        with urllib.request.urlopen(f"{url}/healthz", timeout=30) as resp:
            assert json.loads(resp.read())["status"] == "ok"
        server.shutdown()
        server.server_close()


# -- the port's own cases ---------------------------------------------------


def test_merged_batch_frames_equal_jax(batcher, fabricated_ckpts):  # noqa: F811
    """4 requests queued at once merge into one batch padded as the server pads
    it (B to a power of two, T_x to a bucket); each request's mel frames
    equal JAX's ``synthesise_batch`` lengths for the same padded ids and
    weights (durations do not depend on the noise)."""
    texts = ["hello there", "more words here", "short", "a tiny text"]
    n0 = batcher.n_batches
    results = [batcher._enqueue(t, None, None) for t in texts]  # all queued at once
    for r in results:
        batcher._wait(r, 300.0)
    assert all(r.error is None for r in results)
    assert batcher.n_batches == n0 + 1

    T = batcher._route_x(max(len(r.seq) for r in results))
    x = np.zeros((4, T), np.int32)
    xl = np.asarray([len(r.seq) for r in results], np.int32)
    for i, r in enumerate(results):
        x[i, :len(r.seq)] = r.seq
    model, params = jax_cli.load_matcha(
        "matcha_ljspeech", os.path.join(fabricated_ckpts, "matcha_tpu", "matcha_ljspeech.ckpt"))
    jax_pipe = jax_cli.TTSPipeline(model, params, cleaner=CLEANER)
    want = jax_pipe.synthesise_batch(x, xl, jax.random.PRNGKey(0), n_timesteps=1)
    assert [r.n_frames for r in results] == np.asarray(want["mel_lengths"]).tolist()
    for r in results:
        assert r.wav.size == r.n_frames * 256 and np.isfinite(r.wav).all()


def test_shutdown_gives_the_pipeline_its_capture_setting_back(serve_pipeline):
    """A server closes its pipeline's captures while it lives (only its
    warmup captures) and gives the setting back at shutdown, innermost
    server first, so that the pipeline serves corpus stages again."""
    assert serve_pipeline.capture_allowed is True
    outer = BatchingServer(serve_pipeline, n_timesteps=1)
    inner = BatchingServer(serve_pipeline, n_timesteps=1)
    assert serve_pipeline.capture_allowed is False
    inner.shutdown()
    assert serve_pipeline.capture_allowed is False
    outer.shutdown()
    assert serve_pipeline.capture_allowed is True


def test_lone_request_equals_fixed_bucket_path(batcher):
    """After warmup, a lone request takes the fast path (one fixed-bucket
    call at a warmed bucket) and its samples are the port's
    ``synthesise_batch`` at that bucket on the call's own generator, to
    one 24-bit step; the next call draws other noise."""
    batcher.warmup([(32, 128)])
    assert batcher._fused_warm == {(32, batcher.default_rate, False): [64, 128]}
    assert batcher.max_warm_x == 32 and batcher._warm_x == [32]
    assert batcher.pipeline.capture_allowed is False
    text = "hello there"
    seq = np.asarray(serve.intersperse(text_to_sequence(text, [CLEANER]), 0), np.int32)
    T_y = batcher._pick_fused_bucket(32, batcher.default_rate, False, len(seq))
    n_calls = batcher._n_calls
    r = batcher.submit(text, timeout_s=300.0)
    assert r.error is None and batcher.n_fast == 1
    x1 = np.zeros((1, 32), np.int32)
    x1[0, :len(seq)] = seq
    want = batcher.pipeline.synthesise_batch(
        x1, np.asarray([len(seq)], np.int32), n_timesteps=1, fixed_y_bucket=T_y,
        generator=batcher.call_generator(n_calls + 1))
    n = int(want["mel_lengths"][0])
    assert r.n_frames == n < T_y
    wav = np.clip(want["waveform"][0, :n * 256].numpy(), -1, 1)
    np.testing.assert_allclose(r.wav, wav, rtol=0, atol=2.0 / PCM24_SCALE)
    again = batcher.submit(text, timeout_s=300.0)
    assert again.n_frames == n and np.abs(again.wav - r.wav).max() > 1e-3


@pytest.mark.parametrize("ratios", [[], [1.3], [0.9, 2.4, 3.1, 40.0]],
                         ids=["uncalibrated", "one", "outlier"])
def test_daemon_and_auto_fit_the_same_bucket(serve_pipeline, ratios):
    """Over the same candidates (``FUSED_Y_BUCKETS``, all warmed) and the
    same calibration, the fast path's bucket (``_pick_fused_bucket``) is
    the first bucket ``"auto"`` asks its graph for; a key with nothing
    warmed has none."""
    pipe = port_pipeline.TTSPipeline(serve_pipeline.model, cleaner=CLEANER, device="cpu")
    for r in ratios:
        pipe.observe_dur_ratio(r)
    b = _bare_batcher()
    b.pipeline = pipe
    asked = []
    fused_graph = pipe.fused_graph
    pipe.fused_graph = lambda B, T_x, T_y, *a: asked.append(T_y) or fused_graph(B, T_x, T_y, *a)
    for n, rate in ((9, 1.0), (23, 0.85)):
        T_x = port_pipeline.pick_bucket(n, port_pipeline.X_BUCKETS)
        b._fused_warm = {(T_x, rate, False): list(pipe.FUSED_Y_BUCKETS)}
        assert b._pick_fused_bucket(T_x, rate, True, n) is None
        want = b._pick_fused_bucket(T_x, rate, False, n)
        del asked[:]
        pipe.synthesise_batch(*port_pipeline.pad_ids([np.arange(1, n + 1)], n), n_timesteps=1,
                              length_scale=rate, fixed_y_bucket="auto",
                              generator=torch.Generator().manual_seed(n))
        assert asked[0] == want


def test_warmup_vocodes_every_shape_the_dynamic_path_reaches(serve_pipeline, monkeypatch):
    """``warmup(pairs)`` runs the shared decode -> vocode step
    (``TTSPipeline.vocode_decoded``) at exactly the (B, T_x, T_y, T_voc)
    that its per-bucket loops enumerate: every power-of-two B up to
    ``max_batch``, every ``Y_BUCKETS`` mel bucket up to T_y (T_y itself
    below the table) and every ``VOC_BUCKETS`` length inside each. For a
    T_y of the table these are the buckets the dynamic path picks for
    mels of 1 to T_y frames."""
    seen = set()

    def spy(self, out, T_voc, pack=False):
        assert pack == self.pcm24_transfer
        seen.add((out["mel"].shape[0], out["attn"].shape[1], out["mel"].shape[-1], T_voc))
        return out

    monkeypatch.setattr(port_pipeline.TTSPipeline, "vocode_decoded", spy)
    pairs = [(32, 64), (64, 768)]
    b = BatchingServer(serve_pipeline, max_batch=4, n_timesteps=1, fused_single=False)
    try:
        b.warmup(pairs)
    finally:
        b.shutdown()
    Y, V = port_pipeline.Y_BUCKETS, port_pipeline.VOC_BUCKETS
    want = set()
    for T_x, T_y in pairs:
        for B in (1, 2, 4):
            for T_yb in [y for y in Y if y <= T_y] or [T_y]:
                prev_y = max([y for y in Y if y < T_yb], default=0)
                for T_voc in [v for v in V if prev_y < v <= T_yb] or [T_yb]:
                    want.add((B, T_x, T_yb, T_voc))
    assert seen == want
    reach = set()
    for m in range(1, 769):
        T_y = port_pipeline.pick_bucket(m, Y)
        reach |= {(B, 64, T_y, port_pipeline.voc_bucket(m, T_y)) for B in (1, 2, 4)}
    assert reach == {s for s in seen if s[1] == 64}


def test_call_generators_differ_per_call(serve_pipeline):
    """Each call has a generator of its own on the pipeline's device, seeded
    from (seed, call number): equal for equal pairs, different otherwise."""
    b = object.__new__(BatchingServer)
    b.pipeline, b.seed = serve_pipeline, 1234
    draws = {n: torch.randn(8, generator=b.call_generator(n)) for n in (1, 2)}
    assert torch.equal(draws[1], torch.randn(8, generator=b.call_generator(1)))
    assert not torch.equal(draws[1], draws[2])
    b.seed = 1235
    assert not torch.equal(draws[1], torch.randn(8, generator=b.call_generator(1)))
    assert b.call_generator(1).device == serve_pipeline.device


def test_counters_and_call_numbers_under_contention(serve_pipeline):
    """More threads than cores enqueue and take call generators at once,
    with a short switch interval: no request count and no call number is
    lost or given twice (a lost update would give two calls one noise)."""
    b = _bare_batcher()
    b.pipeline, b.seed, b._n_calls = serve_pipeline, 1234, 0
    seen, lock = [], threading.Lock()
    call_generator = BatchingServer.call_generator

    def record(self, n_call):
        with lock:
            seen.append(n_call)
        return call_generator(self, n_call)

    b.call_generator = record.__get__(b)

    def client():
        for _ in range(50):
            b._enqueue("hi", None, None)
            b._next_generator()

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        _run_threads([threading.Thread(target=client) for _ in range(4 * (os.cpu_count() or 2))],
                     timeout=120.0)
    finally:
        sys.setswitchinterval(interval)
    n = 50 * 4 * (os.cpu_count() or 2)
    assert b.n_requests == b._q.qsize() == n
    assert sorted(seen) == list(range(1, n + 1))


def test_main_serves_on_the_cpu_with_no_jax(fabricated_ckpts, tmp_path):  # noqa: F811
    """``python -m matcha_tpu_torch.serve --cpu --trace-spans PATH`` in a
    subprocess: it warms, serves one /synthesise and /healthz (with the
    daemon's counters), stops on SIGINT, writes its spans as a Chrome
    trace, and never loads a JAX module."""
    trace_path = tmp_path / "spans.json"
    code = ("import atexit, runpy, sys\n"
            "atexit.register(lambda: print('LOADED', sorted({m.split('.')[0] for m in sys.modules"
            " if m.split('.')[0] in ('jax', 'jaxlib', 'flax', 'matcha_tpu')}), flush=True))\n"
            "sys.argv = ['serve', '--cpu', '--port', '0', '--warmup', '32:128', '--max-batch', "
            "'1', '--steps', '1', '--cleaner', 'english_cleaners_no_espeak', '--trace-spans', "
            f"{str(trace_path)!r}]\n"
            "runpy.run_module('matcha_tpu_torch.serve', run_name='__main__')\n")
    env = dict(os.environ, MATCHA_HOME=fabricated_ckpts, PYTHONUNBUFFERED="1")
    proc = subprocess.Popen([sys.executable, "-c", code], cwd=REPO, env=env, text=True,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE)
    try:
        url = None
        for line in proc.stdout:
            if "Serving on http://" in line:
                url = line.split("Serving on ")[1].split()[0]
                break
        assert url, proc.stderr.read()[-3000:]
        status, headers, body = _post(url + "/synthesise", {"text": "hi there"})
        assert status == 200 and headers["Content-Type"] == "audio/wav"
        with wave.open(io.BytesIO(body)) as f:
            n_samples = f.getnframes()
        assert n_samples > 0
        with urllib.request.urlopen(f"{url}/healthz", timeout=30) as resp:
            # one fast-path replay, uncalibrated: B = 1 x the largest warmed mel bucket
            assert json.loads(resp.read()) == {
                "status": "ok", "batches": 1, "requests": 1, "fast": 1, "reruns": 0,
                "frames_answered": n_samples // 256, "frames_decoded": 128, "queue_depth": 0}
        proc.send_signal(signal.SIGINT)
        out, err = proc.communicate(timeout=60)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    assert proc.returncode == 0, err[-3000:]
    assert "LOADED []" in out
    events = json.loads(trace_path.read_text())["traceEvents"]
    names = {e["name"] for e in events}
    assert {"serve.take", "serve.run", "pipeline.synthesise_batch", "serve.complete",
            "serve.frontend", "serve.respond", "serve.request", "serve.service"} <= names
    (run,) = [e for e in events if e["name"] == "serve.run"]
    assert run["args"]["path"] == "fast" and run["args"]["B"] == 1


def test_main_without_cpu_needs_a_gpu():
    """Without ``--cpu`` and with no GPU, ``main`` raises before loading
    anything rather than serving on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["--warmup", ""])


@pytest.mark.parametrize("flag", [[], ["--data-parallel"]])
def test_flags_not_ported_exit(fabricated_ckpts, monkeypatch, flag):  # noqa: F811
    """No flag of the JAX daemon stops ``main`` as not ported any more:
    ``--data-parallel`` builds the pipeline over every visible device,
    which on one device (the CPU here) is one replica, a no-op as in JAX;
    the server starts and the flag is parsed."""
    monkeypatch.setenv("MATCHA_HOME", fabricated_ckpts)
    seen = {}

    class Stop:
        server_address = ("127.0.0.1", 0)

        def serve_forever(self):
            raise KeyboardInterrupt

        def server_close(self):
            pass

    def fake_server(batcher, host, port):
        seen["pipeline"] = batcher.pipeline
        return Stop()

    monkeypatch.setattr(serve, "make_http_server", fake_server)
    serve.main(["--cpu", "--warmup", "", "--cleaner", CLEANER, *flag])
    assert not hasattr(serve, "NOT_PORTED")
    assert serve.build_parser().parse_args(flag).data_parallel is bool(flag)
    assert [r.device for r in seen["pipeline"].replicas] == [torch.device("cpu")]


def test_main_spk_sets_the_default_speaker(ms_home, monkeypatch):
    """``serve.main --spk 3`` on a 4-speaker checkpoint: ``default_spk`` is
    3, a request that omits ``"spk"`` is answered with speaker 3 (the
    port's ``synthesise_batch`` at speaker 3 on the call's generator, to
    one 24-bit step, and not speaker 0's), and an id out of range is a 400
    on /synthesise and /synthesise_stream, before anything is queued."""
    home, ckpt = ms_home
    monkeypatch.setenv("MATCHA_HOME", home)
    real_server = serve.make_http_server
    seen = {}

    class Stop:
        server_address = ("127.0.0.1", 0)

        def serve_forever(self):
            raise KeyboardInterrupt

        def server_close(self):
            pass

    def fake_server(batcher, host, port):
        seen["default_spk"] = batcher.default_spk
        text = "hello there"
        r = batcher.submit(text, timeout_s=300.0)
        assert r.error is None and r.spk == 3
        seq = np.asarray(serve.intersperse(text_to_sequence(text, [CLEANER]), 0), np.int32)
        for spk in (3, 0):
            want = batcher.pipeline.synthesise_batch(
                seq[None], np.asarray([len(seq)], np.int32), n_timesteps=1,
                generator=batcher.call_generator(1), spks=[spk])
            n = int(want["mel_lengths"][0])
            seen[spk] = np.clip(want["waveform"][0, :n * 256].numpy(), -1, 1)
        seen["wav"] = r.wav
        server, url = _http(batcher)
        try:
            for path in ("/synthesise", "/synthesise_stream"):
                with pytest.raises(urllib.error.HTTPError) as e:
                    _post(url + path, {"text": "hi", "spk": 4})
                assert e.value.code == 400 and b"out of range" in e.value.read()
        finally:
            server.shutdown()
            server.server_close()
        assert batcher.n_requests == 1
        return Stop()

    monkeypatch.setattr(serve, "make_http_server", fake_server)
    monkeypatch.setattr(sys.modules[__name__], "make_http_server", real_server)
    serve.main(["--cpu", "--warmup", "", "--steps", "1", "--spk", "3", "--checkpoint_path",
                ckpt, "--cleaner", CLEANER])
    assert seen["default_spk"] == 3
    np.testing.assert_allclose(seen["wav"], seen[3], rtol=0, atol=2.0 / PCM24_SCALE)
    other = seen[0]
    assert other.shape != seen["wav"].shape or np.abs(other - seen["wav"]).max() > 1e-3


def test_bench_serve_runs_a_short_load(batcher):
    """The offered-load script for ~1 s on the tiny model: 2 clients, one
    of them streaming; every request succeeds (``run_window`` raises
    otherwise) and the report adds up, however many finished inside the
    second on a loaded host."""
    batcher.batch_window_s = 0.01
    raw = bench_serve.run_window(batcher, clients=2, duration=1.0, stream=True)
    res = bench_serve.summarise(raw, 2, 10.0, batcher.max_batch, False)
    assert raw["requests"] >= 2 and raw["batches"] >= 1 and raw["wall_s"] >= 1.0
    assert res["req_per_s"] == raw["n_req"] / 1.0
    assert res["audio_x_realtime"] == raw["audio_s"] / 1.0
    assert res["requests_per_batch"] == raw["requests"] / raw["batches"]
    assert res["latency_ms"]["p50"] <= res["latency_ms"]["p99"] == pytest.approx(
        np.percentile(raw["lat_ms"], 99))
    assert res["ttfa_ms"] is not None and len(raw["ttfa_ms"]) >= 1
