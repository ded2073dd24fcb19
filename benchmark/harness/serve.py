"""Traffic of kind ``serve``: the daemon (``matcha_tpu_torch/serve.py``)
under open-loop load.

Set-up builds the seeded models, a ``BatchingServer`` with the traffic's
batching settings, warms the (x bucket, mel bucket) pairs the traffic
routes to, sends ``warm_requests`` requests one at a time (they
calibrate the fast path's bucket choice), serves through
``make_http_server`` on 127.0.0.1, port 0, and offers ``warm_seconds``
of the traffic's load before the window (the first seconds under load
ran slower: their median latency was up to 1.9 times the rest's).
A load generator in a process of its own (``loadgen.py``) sends every
request of the schedule at its due time: Poisson arrivals at
``rate_rps`` for the window, texts from the word list, a speaker drawn
uniformly over ``n_speakers`` where the traffic names them (``schedule``).

For the check, the harness keeps what the daemon's calls into the
pipeline were given and gave back (ids, rows, mel and vocoder buckets,
the noise generator's seed, the alignment's frames per id, and the mel
of the rows of the sample, which is drawn before the window), by a
subclass of the pipeline that records each ``synthesise_batch`` call and
changes none.
"""

import multiprocessing
import sys
import threading

import numpy as np
import torch

from benchmark.harness import loadgen, trace
from benchmark.harness.common import derive_seed
from benchmark.harness.textgen import fixed_lengths, make_texts, texts_of_lengths

HOP = 256
SAMPLE_RATE = 22050


def schedule(traffic: dict, seed: int, seconds: float) -> list:
    """[(due_s, payload)] of one run: Poisson arrivals at ``rate_rps`` over
    ``seconds``. The gaps between arrivals and the texts' lengths are one
    sequence for every seed (drawn once from the mix's name), turned by
    an offset the seed draws, with the seed's own words and speakers:
    every seed offers the same load, bursts included, in another order."""
    rng = np.random.default_rng(derive_seed(seed, "traffic"))
    rate = float(traffic["rate_rps"])
    n = int(round(rate * seconds))
    base = np.random.default_rng(derive_seed(0, "arrivals", traffic["name"]))
    gaps = base.exponential(1.0 / rate, size=n + 1)
    gaps *= seconds / gaps.sum()  # the last arrival lands inside the window
    lengths = fixed_lengths(traffic["name"], n + 1, traffic["chars"])
    turn = int(rng.integers(n + 1))
    gaps, lengths = np.roll(gaps, turn)[:n], np.roll(lengths, turn)[:n]
    dues = np.cumsum(gaps)
    texts = texts_of_lengths(rng, lengths)
    n_spk = traffic.get("n_speakers")
    out = []
    for due, text in zip(dues, texts):
        payload = {"text": text, "format": "wav"}
        if n_spk:
            payload["spk"] = int(rng.integers(n_spk))
        out.append((float(due), payload))
    return out


def _ids_key(ids) -> bytes:
    return np.asarray(ids, np.int64).tobytes()


def _recording_pipeline(base_cls, spans):
    class RecordingPipeline(base_cls):
        """The system's pipeline; each ``synthesise_batch`` call's inputs,
        buckets, generator seed and durations (its alignment's frames per
        id) are kept in ``calls``, and the mel of each row whose ids are
        in ``watch`` in ``mels``. Nothing the call returns is changed."""

        record = False

        def synthesise_batch(self, x, x_lengths, *args, **kw):
            with spans.span("bench.pipeline.synthesise_batch"):
                out = super().synthesise_batch(x, x_lengths, *args, **kw)
            if self.record:
                gen = kw.get("generator")
                if "waveform" in out:
                    T_voc = out["waveform"].shape[1] // HOP
                else:
                    T_voc = (out["wav_pcm24"].shape[1] // 3 - 1) // HOP
                x, xl = np.array(x), np.array(x_lengths)
                self.calls.append({
                    "x": x, "x_lengths": xl,
                    "seed": None if gen is None else gen.initial_seed(),
                    "T_y": int(out["mel"].shape[-1]), "T_voc": int(T_voc), "B": int(x.shape[0]),
                    "durations": out["attn"].sum(-1)})
                for b in range(x.shape[0]):
                    key = _ids_key(x[b, :int(xl[b])])
                    if key in self.watch:
                        self.mels[key] = out["mel"][b].clone()
            return out

    return RecordingPipeline


def _spanned_server(base_cls, spans):
    class SpannedServer(base_cls):
        """The system's batcher with harness spans around its steps."""

        def _take_batch(self):
            with spans.span("bench.serve.take_batch"):
                return super()._take_batch()

        def _run(self, reqs, rate, spk):
            with spans.span(f"bench.serve.run.B{len(reqs)}"):
                return super()._run(reqs, rate, spk)

    return SpannedServer


class ServeCell:
    def __init__(self, cell: dict, seed: int, device, traced: bool):
        from matcha_tpu_torch.cli import TTSPipeline
        from matcha_tpu_torch.serve import BatchingServer, make_http_server

        from benchmark.harness import models

        self.cell, self.seed, self.device, self.traced = cell, seed, device, traced
        cfg, tr = cell["config"], cell["traffic"]
        syn = cfg["synthesis"]
        self.spans = trace.Spans(False)
        pipe = models.system_pipeline(cfg, seed, device, cfg["cleaner"],
                                      cls=_recording_pipeline(TTSPipeline, self.spans))
        pipe.calls, pipe.watch, pipe.mels = [], set(), {}
        self.pipeline = pipe
        self.server = _spanned_server(BatchingServer, self.spans)(
            pipe, max_batch=tr["max_batch"], batch_window_ms=tr["batch_window_ms"],
            n_timesteps=syn["n_timesteps"], temperature=syn["temperature"],
            default_rate=syn["length_scale"], seed=derive_seed(seed, "daemon"),
            default_spk=0 if cfg["model"]["n_spks"] > 1 else None)
        pairs = [tuple(int(v) for v in p.split(":")) for p in tr["warmup"].split(",")]
        self.server.warmup(pairs)
        # a daemon that has served a while has calibrated its fast path's
        # frames per id (before that it replays its largest warmed
        # bucket): a few requests of the traffic's sizes, one at a time
        rng = np.random.default_rng(derive_seed(seed, "warm-requests"))
        for text in make_texts(rng, tr["warm_requests"], tr["chars"]):
            spk = int(rng.integers(tr["n_speakers"])) if tr.get("n_speakers") else None
            req = self.server.submit(text, None, spk)
            if req.error:  # the window's answers will show it too
                print(f"a set-up request failed: {req.error}", file=sys.stderr, flush=True)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        self.http = make_http_server(self.server, "127.0.0.1", 0)
        self.port = self.http.server_address[1]
        self.http_thread = threading.Thread(target=self.http.serve_forever, daemon=True)
        self.http_thread.start()
        # and a daemon under load has run the traffic's batches a while: a
        # first seconds' load, at the cell's rate, of a schedule of its own
        if tr.get("warm_seconds"):
            self._drive(schedule(tr, derive_seed(seed, "warm-load"), tr["warm_seconds"]), False)
            self.release()

    def counters(self) -> dict:
        s = self.server
        return {"n_requests": s.n_requests, "n_batches": s.n_batches, "n_fast": s.n_fast}

    def _drive(self, sched: list, traced: bool) -> tuple:
        """Send ``sched`` from a load generator process and wait for every
        answer (or a minute past the last due time): (t0, summary, counters
        before and after, the closed trace or None). The generator waits
        for ``release`` or ``answers``."""
        ctx = multiprocessing.get_context("spawn")
        parent, child = ctx.Pipe()
        proc = ctx.Process(target=loadgen.child_main, args=(child, self.port, 60.0), daemon=True)
        proc.start()
        child.close()
        self.proc, self.conn = proc, parent
        tracer = trace.Trace() if traced else None
        try:
            if tracer:
                tracer.__enter__()
            before = self.counters()
            parent.send(("go", sched))
            _, t0 = parent.recv()
            if tracer:
                tracer.mark_start(t0)
            _, summary = parent.recv()
            after = self.counters()
            if tracer:
                tracer.mark_end(max(summary["t_end"], t0 + (sched[-1][0] if sched else 0.0)))
                tracer.__exit__(None, None, None)
        except BaseException:
            if tracer:
                tracer.__exit__(*sys.exc_info())
            proc.kill()
            raise
        return t0, summary, before, after, tracer

    def window(self, seconds: float) -> dict:
        """The measured window: the run's schedule over ``seconds``, its
        answers, the counters and the trace."""
        from benchmark.harness.judge import reference_ids

        tr = self.cell["traffic"]
        sched = schedule(tr, self.seed, seconds)
        # the sample the check reads, drawn from the seed before the window
        # (the recorder keeps only its rows' mels), with the longest text
        rng = np.random.default_rng(derive_seed(self.seed, "sample"))
        n = len(sched)
        pick = set(rng.choice(n, size=min(tr["check_answers"], n), replace=False).tolist())
        if n:
            pick.add(max(range(n), key=lambda i: len(sched[i][1]["text"])))
        self.pick = sorted(pick)
        cleaner = self.cell["config"]["cleaner"]
        self.pick_ids = {i: reference_ids(sched[i][1]["text"], cleaner) for i in self.pick}
        self.pipeline.watch = {_ids_key(v) for v in self.pick_ids.values()}
        self.pipeline.mels = {}
        self.pipeline.calls.clear()
        self.pipeline.record = True
        self.spans.on = self.traced
        try:
            t0, summary, before, after, tracer = self._drive(sched, self.traced)
        finally:
            self.pipeline.record = False
            self.spans.on = False
        self.sched, self.summary = sched, summary
        lat = np.asarray(summary["latency_s"], np.float64)
        late = np.asarray([v for v in summary["lateness_s"] if v is not None], np.float64)
        print(f"generator lateness: p50 {np.median(late) * 1e3 if late.size else 0:.3f} ms, "
              f"p99 {np.percentile(late, 99) * 1e3 if late.size else 0:.3f} ms, "
              f"max {late.max() * 1e3 if late.size else 0:.3f} ms over {len(sched)} requests",
              file=sys.stderr, flush=True)
        thirds = [lat[k * len(lat) // 3:(k + 1) * len(lat) // 3] for k in range(3)]
        print("latency p50 by third of the window: " + " / ".join(
            f"{np.median(t) * 1e3:.1f}" if len(t) else "-" for t in thirds) + " ms",
            file=sys.stderr, flush=True)
        run = {"kind": "serve", "seconds": seconds, "due": len(sched),
               "answered": int(np.sum(np.isfinite(lat))),
               "latency_ms": (lat * 1e3).tolist(),
               "counters_before": before, "counters_after": after,
               "window_s": max(summary["t_end"], t0 + seconds) - t0}
        if tracer:
            run["trace"] = trace.read(tracer, self.spans)
        return run

    def release(self) -> None:
        """Close the load generator without fetching any answer."""
        self.conn.send(("wavs", []))
        self.conn.recv()
        self.proc.join(timeout=30)
        if self.proc.is_alive():
            self.proc.kill()
            self.proc.join()

    def answers(self) -> list:
        """The sample drawn before the window (``check_answers`` requests
        and the longest text) as rows for ``judge.Reference.check``: each answered
        one's wav and recorded mel; closes the load generator. A sampled
        request that was not answered is counted by ``unanswered``."""
        s = self.summary
        pick = [i for i in self.pick if s["status"][i] == 200]
        self.conn.send(("wavs", pick))
        wavs = self.conn.recv()
        self.proc.join(timeout=30)
        if self.proc.is_alive():
            self.proc.kill()
            self.proc.join()
        for c in self.pipeline.calls:
            c["durations"] = c["durations"].float().cpu().numpy()
        rows = []
        for i in pick:
            payload = self.sched[i][1]
            wav = decode_wav(wavs[i])
            n = len(wav) // HOP
            mel = self.pipeline.mels.get(_ids_key(self.pick_ids[i]))
            rows.append({"text": payload["text"], "spk": payload.get("spk"), "wav": wav, "n": n,
                         "mel": None if mel is None else mel[:, :n].float().cpu().numpy()})
        return rows

    def attach_calls(self, rows: list, cleaner_ids) -> None:
        """Find each row's call (the last that ran its ids: a fast-path
        result that filled its bucket runs again) and fill in what the
        reference follows: the ids, the durations, the buckets and the
        noise row, drawn again from the call's generator seed."""
        calls = self.pipeline.calls
        n_feats = self.cell["config"]["model"]["n_feats"]
        for r in rows:
            ids = cleaner_ids(r["text"])
            hit = None
            for c in calls:
                for b in range(len(c["x_lengths"])):
                    n = int(c["x_lengths"][b])
                    if n == len(ids) and np.array_equal(c["x"][b, :n], ids):
                        hit = (c, b)
            if hit is None:
                r.update(ids=np.zeros(0, np.int64), durations=np.zeros(0), T_y=0, T_voc=0,
                         noise=None)
                continue
            c, b = hit
            gen = torch.Generator(self.device).manual_seed(c["seed"])
            z = torch.randn((c["B"], c["T_y"], n_feats), generator=gen, device=self.device)[b]
            r.update(ids=c["x"][b, :int(c["x_lengths"][b])], durations=c["durations"][b],
                     T_y=c["T_y"], T_voc=c["T_voc"], noise=z)

    def close(self) -> None:
        self.http.shutdown()
        self.http.server_close()
        self.server.shutdown()
        self.http_thread.join(timeout=10)


def decode_wav(data: bytes) -> np.ndarray:
    """A 24-bit mono WAV body -> f32 samples (the daemon's scale)."""
    import io
    import wave
    with wave.open(io.BytesIO(data)) as f:
        raw = f.readframes(f.getnframes())
    u = np.frombuffer(raw, np.uint8).reshape(-1, 3).astype(np.int32)
    v = u[:, 0] | (u[:, 1] << 8) | (u[:, 2] << 16)
    v = (v ^ 0x800000) - 0x800000
    return (v / np.float32(2 ** 23 - 1)).astype(np.float32)
