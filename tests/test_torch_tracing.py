"""The port's spans and counters (``matcha_tpu_torch/utils/tracing.py``) on
the CPU: the module itself (off, on, nesting across threads, the ring's
bound), the daemon's request and batch spans and its frame counters, the
staged corpus's spans and counters, and ``torch.export`` and the
fixed-bucket body with tracing on. The daemon and the pipelines are the
fixtures of tests/test_torch_serve.py and tests/test_torch_fused.py.
"""

import json
import re
import threading
import time

import numpy as np
import pytest
import torch

from matcha_tpu_torch import cli as port_cli
from matcha_tpu_torch.deploy import export as port_export
from matcha_tpu_torch.models.matcha import MatchaTTS
from matcha_tpu_torch.serve import BatchingServer
from matcha_tpu_torch.utils import tracing
from tests.test_cli_e2e import TINY, fabricated_ckpts  # noqa: F401  (fixture reuse)
from tests.test_torch_fused import CLEANER, loaded  # noqa: F401  (fixture reuse)
from tests.test_torch_serve import serve_pipeline  # noqa: F401  (fixture reuse)

REQUEST_PARTS = ("serve.queue", "serve.batch_wait", "serve.service")


@pytest.fixture()
def traced():
    """Tracing on, on an empty ring, for one test; off and empty after."""
    tracing.reset()
    tracing.enable()
    yield
    tracing.disable()
    tracing.reset()


@pytest.fixture()
def batcher(serve_pipeline):  # noqa: F811
    b = BatchingServer(serve_pipeline, max_batch=4, batch_window_ms=200.0, n_timesteps=1)
    yield b
    b.shutdown()


def _settled(batcher, timeout_s: float = 60.0) -> list:
    """The ring once the batcher has left its last run: a client wakes
    inside the run, before its span closes."""
    deadline = time.monotonic() + timeout_s
    while batcher._busy and time.monotonic() < deadline:
        time.sleep(0.01)
    assert not batcher._busy
    return tracing.spans()


def _by_name(spans) -> dict:
    out = {}
    for s in spans:
        out.setdefault(s.name, []).append(s)
    return out


def test_off_records_nothing_and_returns_the_shared_no_op():
    tracing.disable()
    tracing.reset()
    a, b = tracing.span("serve.run", B=1), tracing.span("pipeline.replay")
    assert a is b and not a and a.sid is None
    with a as s:
        s.set(T_y=64)
    tracing.record("serve.queue", 1, 2)
    assert tracing.spans() == []


def test_nesting_explicit_parents_and_exceptions(traced):
    """The parent is the innermost open span of the same thread; another
    thread names its parent; a span that raises is recorded and closed."""
    with tracing.span("outer", k=1) as outer:
        with tracing.span("inner") as inner:
            inner.set(T_y=128)

        def worker():
            with tracing.span("elsewhere", parent=outer.sid):
                with tracing.span("elsewhere.child"):
                    pass

        t = threading.Thread(target=worker)
        t.start()
        t.join(30)
        assert not t.is_alive()
        with pytest.raises(ValueError):
            with tracing.span("raises"):
                raise ValueError("x")
        with tracing.span("after"):
            pass
    by = {s.name: s for s in tracing.spans()}
    assert by["outer"].parent is None and by["outer"].attrs == {"k": 1}
    assert by["inner"].parent == outer.sid and by["inner"].attrs == {"T_y": 128}
    assert by["elsewhere"].parent == outer.sid and by["elsewhere"].tid != by["outer"].tid
    assert by["elsewhere.child"].parent == by["elsewhere"].sid
    assert by["raises"].parent == by["after"].parent == outer.sid
    for s in by.values():
        assert s.t0_ns <= s.t1_ns
    assert by["outer"].t0_ns <= by["inner"].t0_ns and by["inner"].t1_ns <= by["outer"].t1_ns
    assert tracing.spans(since_ns=by["after"].t0_ns) == [by["after"]]


def test_the_ring_keeps_its_last_spans(traced):
    n = tracing.RING_SPANS + 10
    for i in range(n):
        tracing.record("x", i, i + 1)
    got = tracing.spans()
    assert len(got) == tracing.RING_SPANS
    assert got[0].t0_ns == 10 and got[-1].t0_ns == n - 1


def _request_spans(spans) -> dict:
    """req id -> {name: span} of the request-life spans."""
    out = {}
    for s in spans:
        if s.name in ("serve.request",) + REQUEST_PARTS:
            out.setdefault(s.attrs["req"], {})[s.name] = s
    return out


def _check_requests(spans, reqs) -> None:
    """Each answered request: its four spans share its id, the parts name
    the request span as parent and tile it with no gap."""
    by_req = _request_spans(spans)
    for r in reqs:
        got = by_req[r.rid]
        assert set(got) == {"serve.request"} | set(REQUEST_PARTS)
        req = got["serve.request"]
        assert req.sid == r.rid and req.tid == 0 and req.attrs["batch"] == r.batch
        ends = [req.t0_ns]
        for name in REQUEST_PARTS:
            part = got[name]
            assert part.parent == r.rid and part.attrs == {"req": r.rid, "batch": r.batch}
            assert part.t0_ns == ends[-1] and part.t1_ns >= part.t0_ns
            ends.append(part.t1_ns)
        assert ends[-1] == req.t1_ns
        assert req.t0_ns == tracing.ns(r.t_enqueue) and req.t1_ns == tracing.ns(r.t_done)


def test_dynamic_batch_spans_and_counters(traced, batcher):
    """Three concurrent requests merge into one dynamic batch: each request
    is tiled by its queue wait, batch wait and service; the batch's take,
    run (with B, the path and the buckets), the pipeline's call inside it
    and the models' calls inside that, and its completion, under one batch
    id; frames_decoded is B (padded) x T_y, at least the frames answered."""
    texts = ["hello there", "more words here", "short"]
    reqs = [None] * 3

    def worker(i):
        reqs[i] = batcher.submit(texts[i], timeout_s=300.0)

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(3)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(300)
    assert not any(t.is_alive() for t in threads)
    assert all(r.error is None for r in reqs)
    spans = _settled(batcher)
    _check_requests(spans, reqs)
    by = _by_name(spans)
    batch_ids = {r.batch for r in reqs}
    run = [s for s in by["serve.run"] if s.attrs["batch"] in batch_ids]
    for s in run:
        assert s.attrs["path"] == "dynamic" and s.attrs["B"] in (1, 2, 4)
        assert s.attrs["T_voc"] <= s.attrs["T_y"]
        assert s.tid == batcher._thread.ident
        syn = [p for p in by["pipeline.synthesise_batch"] if p.parent == s.sid]
        assert len(syn) == 1 and syn[0].attrs == {k: s.attrs[k] for k in syn[0].attrs}
        inside = {p.name for p in spans if p.parent == syn[0].sid}
        assert inside == {"models.encode", "pipeline.lengths_sync", "models.decode",
                          "models.vocode", "models.denoise"}
        complete = [p for p in by["serve.complete"] if p.parent == s.sid]
        assert len(complete) == 1 and complete[0].attrs == {"batch": s.attrs["batch"]}
    assert {s.attrs["batch"] for s in by["serve.take"]} >= batch_ids
    decoded = sum(s.attrs["B"] * s.attrs["T_y"] for s in run)
    c = batcher.counters()
    assert c["frames_decoded"] == decoded
    assert c["frames_answered"] == sum(r.n_frames for r in reqs) <= c["frames_decoded"]
    assert c["batches"] == len(run) and c["requests"] == 3 and c["reruns"] == 0


def test_fast_path_and_rerun_spans(traced, batcher):
    """A lone request on the fast path: the fixed-bucket call stages its
    inputs, then runs its body (on the CPU eagerly, its vocoder spanned;
    on a card one replay); one that saturates its bucket runs again inside
    a ``serve.rerun`` span, and ``frames_decoded`` counts both."""
    text = "hello there"
    r0 = batcher.submit(text, timeout_s=600.0)
    n = r0.n_frames
    T_x = port_cli.pick_bucket(len(r0.seq), port_cli.X_BUCKETS)
    T_small = max(16, (n - 1) // 16 * 16)
    batcher._fused_warm[(T_x, batcher.default_rate, False)] = [T_small]
    before = batcher.counters()
    tracing.reset()
    r1 = batcher.submit(text, timeout_s=600.0)
    assert r1.error is None and r1.n_frames == n
    spans = _settled(batcher)
    _check_requests(spans, [r1])
    by = _by_name(spans)
    (run,) = by["serve.run"]
    assert run.attrs == {"batch": r1.batch, "B": 1, "path": "fast", "T_x": T_x,
                         "T_y": T_small, "T_voc": T_small}
    (syn_fast, syn_rerun) = sorted(by["pipeline.synthesise_batch"], key=lambda s: s.t0_ns)
    assert syn_fast.parent == run.sid and syn_fast.attrs["path"] == "fast"
    assert [s.parent for s in by["pipeline.stage_inputs"]] == [syn_fast.sid]
    assert sorted(s.name for s in spans if s.parent == syn_fast.sid) == [
        "models.denoise", "models.vocode", "pipeline.stage_inputs"]
    (rerun,) = by["serve.rerun"]
    assert syn_rerun.parent == rerun.sid and syn_rerun.attrs["path"] == "dynamic"
    (complete,) = by["serve.complete"]
    assert rerun.parent == complete.sid and complete.parent == run.sid
    after = batcher.counters()
    assert after["reruns"] - before["reruns"] == 1 and after["fast"] - before["fast"] == 1
    assert (after["frames_decoded"] - before["frames_decoded"]
            == T_small + syn_rerun.attrs["T_y"])
    assert after["frames_answered"] - before["frames_answered"] == n


def test_tracing_off_records_nothing_from_the_daemon(batcher):
    tracing.disable()
    tracing.reset()
    r = batcher.submit("hello there", timeout_s=300.0)
    assert r.error is None and tracing.spans() == []
    assert batcher.counters()["frames_answered"] == r.n_frames


def _corpus(n=7):
    rng = np.random.default_rng(5)
    return [rng.integers(1, 178, size=(int(k),)).astype(np.int32)
            for k in rng.integers(8, 40, size=n)]


@pytest.mark.parametrize("fuse_stages", [False, True], ids=["split", "fused"])
def test_corpus_spans_and_counters(loaded, traced, fuse_stages):  # noqa: F811
    """7 utterances in batches of 3 over windows of 2 batches: an encode
    and a lengths span per window, a batch span per batch with its
    buckets, none open while the caller holds the generator; split, the
    decode graph's ``pipeline.stage_inputs`` inside each ``models.decode``
    and one capture or replay counted a batch; the frame counters are the
    host lengths and B x T_y."""
    model, voc, bias = loaded["port"]
    pipe = port_cli.TTSPipeline(model, voc, bias, CLEANER, device="cpu")
    gen = pipe.synthesise_corpus(_corpus(), n_timesteps=1, batch_size=3, stage_window=2,
                                 fuse_stages=fuse_stages, generator=torch.Generator().manual_seed(3))
    outs = []
    for chunk, out in gen:
        assert tracing._stack() == []  # nothing open across the yield
        with tracing.span("caller"):
            outs.append((len(chunk), out))
    by = _by_name(tracing.spans())
    assert len(by["pipeline.corpus.encode"]) == 2 and len(by["pipeline.corpus.lengths"]) == 2
    assert [s.attrs["batches"] for s in by["pipeline.corpus.encode"]] == [2, 1]
    batches = by["pipeline.corpus.batch"]
    assert len(batches) == 3 and all(s.parent is None for s in batches)
    assert all(s.parent is None for s in by["caller"])
    for s, (B, out) in zip(batches, outs):
        assert s.attrs["B"] == B and s.attrs["T_y"] == out["mel"].shape[-1]
        assert s.attrs["T_voc"] * 256 == out["waveform"].shape[1]
    inside = {p.name for p in tracing.spans() if p.parent in {s.sid for s in batches}}
    if fuse_stages:  # the stage's body, eager on the CPU (one replay on a card)
        assert inside == {"pipeline.stage_inputs", "models.vocode", "models.denoise"}
    else:
        assert inside == {"models.decode", "models.vocode", "models.denoise"}
        # the decode graph's inputs staged inside each batch's decode (its
        # body eager on the CPU; a capture or a replay beside it on a card)
        decodes = by["models.decode"]
        assert len(decodes) == 3 and {s.parent for s in decodes} == {s.sid for s in batches}
        assert sorted(s.parent for s in by["pipeline.stage_inputs"]) == sorted(
            s.sid for s in decodes)
        assert {p.name for p in tracing.spans() if p.parent in {s.sid for s in decodes}} == {
            "pipeline.stage_inputs"}
        assert pipe.corpus_decode_captures + pipe.corpus_decode_replays == 3
    encode_ids = {s.sid for s in by["pipeline.corpus.encode"]}
    assert len(by["models.encode"]) == 3 and {s.parent for s in by["models.encode"]} <= encode_ids
    assert pipe.corpus_frames_true == sum(int(o["mel_lengths_host"].sum()) for _, o in outs)
    assert pipe.corpus_frames_decoded == sum(B * o["mel"].shape[-1] for B, o in outs)
    assert pipe.corpus_frames_true <= pipe.corpus_frames_decoded


def test_fixed_bucket_body_with_tracing_on_equals_off(loaded, traced):  # noqa: F811
    """The body a CUDA graph captures, run eagerly on the CPU: with
    tracing on it gives the same result as with it off; its spans are the
    call's and its vocoder's (none inside the model's ``synthesise``)."""
    model, voc, bias = loaded["port"]
    pipe = port_cli.TTSPipeline(model, voc, bias, CLEANER, device="cpu")
    tp = port_cli.process_text(0, "Hello world, the 2nd test.", CLEANER)

    def run():
        return pipe.synthesise_batch(tp["x"], tp["x_lengths"], n_timesteps=1, fixed_y_bucket=192,
                                     generator=torch.Generator().manual_seed(7))

    on = run()
    names = [s.name for s in tracing.spans()]
    assert sorted(names) == ["models.denoise", "models.vocode", "pipeline.stage_inputs",
                             "pipeline.synthesise_batch"]
    tracing.disable()
    off = run()
    for k in ("mel", "waveform", "wav_pcm24"):
        assert torch.equal(on[k], off[k]), k


def test_export_with_tracing_on(traced, tmp_path):
    """``torch.export`` of the synthesis graph with tracing on: no span is
    recorded inside what it traces, and the artifact runs as the eager
    module does."""
    torch.manual_seed(0)
    model = MatchaTTS(**TINY).eval()
    ep = port_export.export_graph(model, str(tmp_path / "mel.pt2"), 2, 24, 64, 1)
    assert tracing.spans() == []
    gen = torch.Generator().manual_seed(1)
    args = (torch.randint(1, TINY["n_vocab"], (2, 24), generator=gen), torch.tensor([24, 15]),
            torch.tensor([0.667, 1.0]), torch.randn((2, 64, TINY["n_feats"]), generator=gen))
    with torch.no_grad():
        want = port_export.get_exportable_fn(model, None, 1, 64)(*args)
        got = ep.module()(*args)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=1e-5)


def test_chrome_trace_of_thread_and_request_spans(traced, tmp_path):
    with tracing.span("serve.run", B=1):
        pass
    tracing.record("serve.request", 10_000, 50_000, sid=77, req=77)
    tracing.record("serve.queue", 10_000, 20_000, parent=77, req=77)
    path = tmp_path / "spans.json"
    assert tracing.write_chrome(path) == 3
    events = json.loads(path.read_text())["traceEvents"]
    (run,) = [e for e in events if e["ph"] == "X"]
    assert run["name"] == "serve.run" and run["args"]["B"] == 1 and run["tid"] != 0
    req = [e for e in events if e.get("cat") == "request"]
    assert sorted((e["name"], e["ph"], e["ts"]) for e in req) == [
        ("serve.queue", "b", 10.0), ("serve.queue", "e", 20.0),
        ("serve.request", "b", 10.0), ("serve.request", "e", 50.0)]
    assert {e["id"] for e in req} == {77}


def test_cli_staged_prints_frame_fill_and_writes_spans(fabricated_ckpts, tmp_path,  # noqa: F811
                                                       monkeypatch, capsys):
    """``--batched --staged --trace-spans PATH``: the CLI prints the corpus's
    frame fill from the two counters (its speech frames are the written
    mels' lengths) and the decode graph's replays and captures, and writes the corpus spans as a Chrome trace, with
    tracing off again after the run."""
    monkeypatch.setenv("MATCHA_HOME", fabricated_ckpts)
    lines = tmp_path / "lines.txt"
    lines.write_text("hello world\nthe quick brown fox\na longer sentence for the third line\n",
                     encoding="utf-8")
    path, out = tmp_path / "spans.json", tmp_path / "out"
    tracing.reset()
    port_cli.cli(["--file", str(lines), "--batched", "--staged", "--batch_size", "2",
                  "--cleaner", CLEANER, "--steps", "1", "--cpu", "--output_folder", str(out),
                  "--trace-spans", str(path)])
    assert not tracing.enabled()
    tracing.reset()
    printed = capsys.readouterr().out.splitlines()
    fill = [ln for ln in printed if "Corpus frame fill" in ln]
    assert len(fill) == 1
    speech = sum(np.load(out / f"utterance_{i:03d}.npy").shape[1] for i in range(3))
    pct, true, decoded = (float(v) for v in
                          re.search(r"fill: ([\d.]+) % \((\d+) speech frames of (\d+) decoded",
                                    fill[0]).groups())
    assert true == speech <= decoded and pct == round(100 * true / decoded, 1)
    (decode,) = [ln for ln in printed if "Corpus decode" in ln]
    replays, captures, batches = (int(v) for v in re.search(
        r"decode: (\d+) replays, (\d+) captures, of (\d+) batches", decode).groups())
    assert batches == 2 and replays + captures == batches and captures >= 1
    names = [e["name"] for e in json.loads(path.read_text())["traceEvents"]]
    assert names.count("pipeline.corpus.encode") == names.count("pipeline.corpus.lengths") == 1
    assert names.count("pipeline.corpus.batch") == names.count("models.decode") == 2
    assert names.count("models.encode") == 2
