"""``python -m matcha_tpu_torch.serve``: the HTTP serving daemon of the port.

The counterpart of ``matcha_tpu/serve.py``, on a GPU (or the CPU with
``--cpu``):

* **Warm start.** ``--warmup`` runs every shape that the chosen
  (x bucket, mel bucket) pairs can reach before the port opens (cuDNN's
  plans, cuFFT's, K1's library), and captures the single-request fast
  path's CUDA graphs (``fused.py::FusedGraph``). After warmup the
  pipeline refuses any new capture: the daemon replays only graphs its
  warmup captured.
* **Dynamic micro-batching.** Concurrent requests queue; a batcher thread
  takes up to ``--max-batch`` of them (waiting at most
  ``--batch-window-ms`` while the card is idle), pads them into one
  bucketed batch (B a power of two) and runs the dynamic path once. A
  lone request takes the fast path: one replay of a warmed graph.
* **Data-parallel** (``--data-parallel``): one replica of the models per
  visible GPU (``TTSPipeline(devices=)``); a batch whose size divides by
  the replica count splits its rows over them. The fast path is off then
  (JAX gates it on a pipeline without a mesh) and warmup runs every
  replica's shapes. A no-op with one GPU.
* **Stdlib only:** ``http.server.ThreadingHTTPServer``. JSON in, WAV
  (24-bit PCM) or JSON out.

Endpoints (the JAX daemon's, with its status codes and JSON keys):
  POST /synthesise         {"text": ..., ["speaking_rate": f], ["spk": i],
                            ["format": "wav"|"json"]}
  POST /synthesise_long    the same, sentence-chunked, chunks batched
  POST /synthesise_stream  a live WAV stream, one chunk after another
  GET  /healthz            {"status": "ok", "batches": N, "requests": N, "fast": N,
                            "reruns": N, "frames_answered": N, "frames_decoded": N,
                            "queue_depth": N}

Each call draws its noise from a generator of its own on the pipeline's
device, seeded from (``seed``, the call's number). A multi-speaker model
serves every speaker: ``--spk`` is the default of requests that omit
``"spk"``, requests group by (rate, spk), and one warmed graph per
(x bucket, rate, has_spk) serves every speaker (its speaker id is a
static input). A speaker id outside the model's range is answered with
400 before it is queued. ``--model`` and ``--vocoder`` name the files
as the CLI does, through its ``validate_args`` (each model's default
vocoder, speaking rate and speaker); ``--vocoder
bigvgan_v2_22khz_80band_fmax8k_256x`` serves BigVGAN-v2 (float32 only, so
not with ``--bf16-vocoder`` or ``--vocoder-chunk``).

Tracing (``utils/tracing.py``, off unless ``--trace-spans PATH``): each
request's ``serve.request`` span from its enqueue to its wake-up is tiled
by ``serve.queue`` (until the batcher takes it), ``serve.batch_wait``
(the batch window and the earlier groups of its take) and
``serve.service`` (its group's run, fetch and wake); the handler thread
adds ``serve.frontend`` and ``serve.respond``. The batcher's
``serve.take``, ``serve.run``, ``serve.complete`` and ``serve.rerun`` carry
the batch's id, as each request's spans do. ``--trace-spans`` writes the
ring as a Chrome trace at shutdown.

    python -m matcha_tpu_torch.serve --port 8080 --warmup 128:512 [--cpu]
"""

import argparse
import io
import json
import queue
import struct
import threading
import time
import wave
from collections import deque
from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch

from matcha_tpu_torch import resolve_device
from matcha_tpu_torch.cli import (MATCHA_URLS, VOCODER_URLS, assert_required_models_available,
                                  data_parallel_devices, load_matcha, load_vocoder,
                                  resolve_speaker, validate_args)
from matcha_tpu_torch.models.matcha import check_speakers
from matcha_tpu_torch.pipeline import (HOP, SAMPLE_RATE, X_BUCKETS, Y_BUCKETS, TTSPipeline,
                                       fetch_fused_host, pad_ids, pick_bucket, speaker_batch,
                                       voc_bucket)
from matcha_tpu_torch.text import intersperse, text_to_sequence
from matcha_tpu_torch.text.segment import split_sentences
from matcha_tpu_torch.utils import tracing
from matcha_tpu_torch.utils.utils import pcm24_bytes as pcm24

SR = SAMPLE_RATE
#: request-body cap: text is the only client payload, and 1 MB of it is
#: hours of speech; an unbounded read would let one request hold a
#: handler thread on a huge body
MAX_BODY_BYTES = 1 << 20


def wav_bytes(audio: np.ndarray, sample_rate: int = SR) -> bytes:
    """Mono 24-bit PCM WAV in memory (the encoding of ``write_wav``)."""
    buf = io.BytesIO()
    with wave.open(buf, "wb") as f:
        f.setnchannels(1)
        f.setsampwidth(3)
        f.setframerate(sample_rate)
        f.writeframes(pcm24(audio))
    return buf.getvalue()


def wav_stream_header(sample_rate: int = SR, sampwidth: int = 3) -> bytes:
    """A WAV header with placeholder sizes (0x7FFFFFFF), for a live stream:
    players read PCM until the connection closes."""
    byte_rate = sample_rate * sampwidth
    return (b"RIFF" + struct.pack("<I", 0x7FFFFFFF) + b"WAVE"
            + b"fmt " + struct.pack("<IHHIIHH", 16, 1, 1, sample_rate, byte_rate, sampwidth,
                                    8 * sampwidth)
            + b"data" + struct.pack("<I", 0x7FFFFFFF))


@dataclass
class _Request:
    seq: np.ndarray  # 1-D int32 phoneme ids
    speaking_rate: float
    spk: Optional[int]
    done: threading.Event = field(default_factory=threading.Event)
    wav: Optional[np.ndarray] = None
    n_frames: int = 0
    error: Optional[str] = None
    t_enqueue: float = field(default_factory=time.perf_counter)
    #: taken off the queue by the batcher, and its group's run started
    t_taken: float = 0.0
    t_run: float = 0.0
    t_done: float = 0.0
    #: the id of its ``serve.request`` span, and of the take that batched it
    rid: int = field(default_factory=tracing.new_id)
    batch: int = 0
    #: a stream's first chunk on an idle server: dispatched alone, at once,
    #: instead of waiting out the batch window
    urgent: bool = False
    #: a long-form or stream chunk: fills only the batch slots that
    #: interactive requests leave free
    bulk: bool = False


def _frames_decoded(out: dict) -> int:
    """B (padded) x the mel bucket of one result."""
    B, _, T_y = out["mel"].shape
    return B * T_y


def _run_attrs(out: dict) -> dict:
    """A group's result as its ``serve.run`` span's attributes: B (padded),
    the path and the x, mel and vocoder buckets, read from the shapes."""
    B, _, T_y = out["mel"].shape
    if "waveform" in out:
        samples = out["waveform"].shape[1]
    else:  # the dynamic path's PCM rows, the lengths as a last sample
        samples = out["wav_pcm24"].shape[1] // 3 - 1
    return {"B": B, "path": "fast" if "_fused_T_y" in out else "dynamic",
            "T_x": out["attn"].shape[1], "T_y": T_y, "T_voc": samples // HOP}


def _record_request(r: "_Request") -> None:
    """A woken request's spans: ``serve.request`` from its enqueue to its
    wake-up, tiled by its queue wait, its batch wait and its service."""
    ns = tracing.ns
    tracing.record("serve.request", ns(r.t_enqueue), ns(r.t_done), sid=r.rid, req=r.rid,
                   batch=r.batch)
    for name, t0, t1 in (("serve.queue", r.t_enqueue, r.t_taken),
                         ("serve.batch_wait", r.t_taken, r.t_run),
                         ("serve.service", r.t_run, r.t_done)):
        tracing.record(name, ns(t0), ns(t1), parent=r.rid, req=r.rid, batch=r.batch)


def call_seed(seed: int, n_call: int) -> int:
    """The seed of call ``n_call``'s noise generator: (seed, n_call) hashed
    into 63 bits, its low 32 well mixed (the CPU generator reads only
    those)."""
    return int(np.random.SeedSequence([seed, n_call]).generate_state(1, np.uint64)[0] >> 1)


class BatchingServer:
    """Queue + batcher thread around a warm ``TTSPipeline``.

    Requests with the same (speaking_rate, spk) merge into one batch;
    mixed keys run separately (each rate is a key of the warmed graphs)."""

    #: client rates are clamped to this range and snapped to RATE_STEP, so
    #: that the set of shapes and graphs stays small and warmable
    RATE_RANGE = (0.5, 2.0)
    RATE_STEP = 0.05

    def __init__(self, pipeline: TTSPipeline, max_batch: int = 8,
                 batch_window_ms: float = 10.0, n_timesteps: int = 10,
                 temperature: float = 0.667, default_rate: float = 1.0,
                 seed: int = 1234, default_spk: Optional[int] = None,
                 pipelined: bool = False, fused_single: bool = True):
        self.pipeline = pipeline
        self.max_batch = max_batch
        self.batch_window_s = batch_window_ms / 1e3
        self.n_timesteps = n_timesteps
        self.temperature = temperature
        # the operator's default rate is trusted as given (it is warmed);
        # only client rates are quantised
        self.default_rate = float(default_rate)
        self.default_spk = default_spk
        self.seed = seed
        self._n_calls = 0
        self._q: "queue.Queue[_Request]" = queue.Queue()
        # bulk requests displaced by interactive ones, FIFO; touched only by
        # the batcher thread
        self._bulk_backlog: "deque[_Request]" = deque()
        self._stop = threading.Event()
        # guards the counters and the timeout-against-dispatch race on
        # _Request.error (see _loop_inner and submit)
        self._lock = threading.Lock()
        self.n_batches = 0
        self.n_requests = 0
        #: requests the fast path ran (one replay of a warmed graph each)
        self.n_fast = 0
        #: fast-path results that filled their bucket and ran again
        self.n_rerun = 0
        #: true mel frames woken to clients, and the frames decoded for them
        #: (B padded x the mel bucket of every replay, batch and re-run)
        self.frames_answered = 0
        self.frames_decoded = 0
        # the largest warmed x bucket: longer texts are refused at enqueue
        # (None until warmup runs: accept anything)
        self.max_warm_x: Optional[int] = None
        # opt-in: the batcher only launches work and a responder thread
        # fetches results and wakes clients; maxsize bounds the batches in
        # flight
        self.pipelined = pipelined
        self._completion_q: "queue.Queue" = queue.Queue(maxsize=2)
        self._in_flight = 0  # launched batches not yet fetched
        # the single-request fast path: (T_x bucket, rate, has_spk) -> the
        # mel buckets warmup captured, sorted; only those are ever replayed
        self.fused_single = fused_single
        self._fused_warm: dict = {}
        # warmed x buckets, sorted: shorter texts route up to one of them
        self._warm_x: list = []
        self._busy = False  # the batcher is running a batch
        # only warmup may capture a graph from here on; shutdown gives the
        # pipeline its setting back
        self._capture_allowed_before = pipeline.capture_allowed
        pipeline.capture_allowed = False
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()
        self._responder = threading.Thread(target=self._respond_loop, daemon=True)
        self._responder.start()

    def counters(self) -> dict:
        """The daemon's counters, read together, and the queue's depth."""
        with self._lock:
            return {"batches": self.n_batches, "requests": self.n_requests, "fast": self.n_fast,
                    "reruns": self.n_rerun, "frames_answered": self.frames_answered,
                    "frames_decoded": self.frames_decoded, "queue_depth": self._q.qsize()}

    def _quantize_rate(self, rate: float) -> float:
        lo, hi = self.RATE_RANGE
        rate = min(max(float(rate), lo), hi)
        return round(round(rate / self.RATE_STEP) * self.RATE_STEP, 2)

    def call_generator(self, n_call: int) -> torch.Generator:
        """Call ``n_call``'s noise generator, on the pipeline's device."""
        return torch.Generator(self.pipeline.device).manual_seed(call_seed(self.seed, n_call))

    def _next_generator(self) -> torch.Generator:
        # under the lock: the saturation re-run may run on the responder
        # thread, and a lost increment would give two calls the same noise
        with self._lock:
            self._n_calls += 1
            n_call = self._n_calls
        return self.call_generator(n_call)

    # -- client side ------------------------------------------------------
    def resolve_spk(self, spk: Optional[int]) -> Optional[int]:
        """A request's speaker: ``default_spk`` when it gives none, checked
        against the model's speakers (ValueError, which the HTTP layer
        answers with 400, for an id out of range or a multi-speaker model
        with no speaker at all)."""
        spk = self.default_spk if spk is None else int(spk)
        check_speakers(self.pipeline.model.n_spks, None if spk is None else [spk])
        return spk

    def _enqueue(self, text: str, speaking_rate: Optional[float], spk: Optional[int],
                 urgent: bool = False, bulk: bool = False) -> _Request:
        """Phonemize and queue without waiting."""
        spk = self.resolve_spk(spk)
        seq = intersperse(text_to_sequence(text, [self.pipeline.cleaner]), 0)
        if self.max_warm_x is not None and len(seq) > self.max_warm_x:
            raise ValueError(
                f"text too long: {len(seq)} phoneme ids > largest warmed bucket "
                f"{self.max_warm_x}; split the request (or use /synthesise_long) or restart "
                f"with a bigger --warmup")
        req = _Request(seq=np.asarray(seq, np.int32),
                       speaking_rate=(self.default_rate if speaking_rate is None
                                      else self._quantize_rate(speaking_rate)),
                       spk=spk, urgent=urgent, bulk=bulk)
        with self._lock:
            self.n_requests += 1
        self._q.put(req)
        return req

    def _wait(self, req: _Request, timeout_s: float) -> None:
        if not req.done.wait(timeout_s):
            # the lock the batcher sheds under: a result that landed between
            # the wait's expiry and here is kept
            with self._lock:
                if not req.done.is_set():
                    req.error = "timeout"

    def submit(self, text: str, speaking_rate: Optional[float] = None,
               spk: Optional[int] = None, timeout_s: float = 120.0) -> _Request:
        req = self._enqueue(text, speaking_rate, spk)
        self._wait(req, timeout_s)
        return req

    def _fit_chunks(self, text: str, max_chars: int) -> list:
        """Sentence chunks of ``text`` that fit the warmed x buckets: the
        character budget is first clamped to what ``max_warm_x`` holds
        (about 2 ids per cleaned symbol), then each chunk is checked in ids
        and split again where the cleaner expanded it ("1999" -> "nineteen
        ninety nine")."""
        if self.max_warm_x is not None:
            max_chars = min(max_chars, max(8, (self.max_warm_x - 1) // 2))
        chunks = split_sentences(text, max_chars=max_chars)
        if self.max_warm_x is None:
            return chunks
        out, pending = [], list(chunks)
        while pending:
            c = pending.pop(0)
            if 2 * len(text_to_sequence(c, [self.pipeline.cleaner])) + 1 <= self.max_warm_x:
                out.append(c)
                continue
            halves = split_sentences(c, max_chars=max(8, len(c) // 2))
            if len(halves) <= 1:
                out.append(c)  # unsplittable: _enqueue refuses it with a clear 400
            else:
                pending = halves + pending
        return out

    def submit_stream(self, text: str, speaking_rate: Optional[float] = None,
                      spk: Optional[int] = None, timeout_s: float = 600.0,
                      max_chars: int = 200):
        """Enqueue every sentence chunk at once (they merge into batches),
        then yield each chunk's finished request in order. The first chunk
        is urgent only when the server is idle at enqueue time: it then
        runs alone on the fast path while its siblings merge."""
        chunks = self._fit_chunks(text, max_chars)
        idle = (self._q.empty() and not self._busy and self._in_flight == 0
                and not self._bulk_backlog)
        reqs = [self._enqueue(c, speaking_rate, spk, urgent=(i == 0 and idle and len(chunks) > 1),
                              bulk=True)
                for i, c in enumerate(chunks)]
        for r in reqs:
            self._wait(r, timeout_s)
            yield r

    def submit_long(self, text: str, speaking_rate: Optional[float] = None,
                    spk: Optional[int] = None, timeout_s: float = 600.0,
                    max_chars: int = 200) -> list:
        """Sentence-chunk ``text`` and submit every chunk at once, so that
        one long request fills batches; the chunks' requests in order."""
        return list(self.submit_stream(text, speaking_rate, spk, timeout_s, max_chars=max_chars))

    def shutdown(self):
        self._stop.set()
        self._q.put(None)  # unblock the batcher
        self._thread.join(timeout=5)
        # the batcher queues the responder's sentinel when its loop ends, so
        # that it never overtakes a batch still being launched
        self._responder.join(timeout=5)
        self.pipeline.capture_allowed = self._capture_allowed_before

    # -- batcher thread ---------------------------------------------------
    def _take_batch(self) -> list:
        """Merge queued requests into one batch.

        While a batch is in flight, waiting costs the card nothing, so
        collection goes on until the batch fills or the card frees; the
        ``batch_window_ms`` clock runs only while the card is idle and
        restarts when it frees. Interactive requests take slots first;
        bulk chunks fill the rest and the remainder carries over in
        ``_bulk_backlog`` (FIFO); with no interactive traffic bulk fills
        whole batches."""
        interactive: list = []
        bulk: list = list(self._bulk_backlog)
        self._bulk_backlog.clear()
        if not bulk:
            first = self._q.get()
            if first is None:
                return []
            first.t_taken = time.perf_counter()
            if first.urgent:
                return [first]
            (bulk if first.bulk else interactive).append(first)
        stop = False
        deadline = time.perf_counter() + self.batch_window_s
        busy_prev = self._in_flight > 0
        while not stop and len(interactive) < self.max_batch:
            busy = self._in_flight > 0
            if busy_prev and not busy:
                deadline = time.perf_counter() + self.batch_window_s
            busy_prev = busy
            if len(interactive) + len(bulk) >= self.max_batch and not busy and self._q.empty():
                break
            remaining = deadline - time.perf_counter()
            if not busy and remaining <= 0:
                break
            try:
                nxt = self._q.get(timeout=0.002 if busy else max(remaining, 1e-4))
            except queue.Empty:
                continue
            if nxt is None:
                stop = True
                continue
            nxt.t_taken = time.perf_counter()
            if nxt.bulk and not nxt.urgent:
                bulk.append(nxt)
            else:
                interactive.append(nxt)
        residual = self.max_batch - len(interactive)
        self._bulk_backlog.extend(bulk[residual:])
        return interactive + bulk[:residual]

    def _loop(self):
        try:
            self._loop_inner()
        finally:
            # after every batch this thread launched: the responder drains
            # them, then exits
            self._completion_q.put(None)

    def _loop_inner(self):
        while not self._stop.is_set():
            batch_id = tracing.new_id()
            with tracing.span("serve.take", batch=batch_id):
                batch = self._take_batch()
            if not batch:
                continue
            # shed requests whose submit() already timed out (nobody reads
            # them), under the lock so that no timeout lands in between
            with self._lock:
                batch = [r for r in batch if r.error is None]
            if not batch:
                continue
            groups: dict = {}
            for r in batch:
                r.batch = batch_id
                groups.setdefault((r.speaking_rate, r.spk), []).append(r)
            self._busy = True
            try:
                for (rate, spk), reqs in groups.items():
                    with self._lock:
                        self._in_flight += 1
                    t_run = time.perf_counter()
                    for r in reqs:
                        r.t_run = t_run
                    try:
                        self._run(reqs, rate, spk)
                    except Exception as e:  # a device error: fail the batch, serve on
                        with self._lock:
                            self._in_flight -= 1
                        for r in reqs:
                            r.error = f"{type(e).__name__}: {e}"
                            r.done.set()
            finally:
                self._busy = False

    def _run(self, reqs, rate, spk):
        with tracing.span("serve.run", batch=reqs[0].batch) as span:
            out = self._launch(reqs, rate, spk)
            if span:
                span.set(**_run_attrs(out))
            self._hand_over(reqs, out)

    def _launch(self, reqs, rate, spk) -> dict:
        """One group's synthesis: the fast path's replay (its result marked
        with ``_fused_T_y``) or the dynamic path's batch."""
        if len(reqs) == 1 and self._fused_warm and len(self.pipeline.replicas) == 1:
            # the fast path: one replay of a graph warmup captured
            r = reqs[0]
            T_x = self._route_x(len(r.seq))
            T_y = self._pick_fused_bucket(T_x, rate, spk is not None, len(r.seq))
            if T_y:
                out = self.pipeline.synthesise_batch(
                    *pad_ids([r.seq], T_x), n_timesteps=self.n_timesteps,
                    temperature=self.temperature, length_scale=rate, fixed_y_bucket=T_y,
                    generator=self._next_generator(), spks=speaker_batch(spk, 1))
                out["_fused_T_y"] = T_y  # the saturation check's marker
                return out
        # B padded to a power of two and T_x routed up to a warmed bucket:
        # the batch runs only shapes that warmup ran; dummy rows (length
        # 1, all padding) are fetched with the batch and dropped
        B = 1
        while B < len(reqs):
            B *= 2
        T = self._route_x(max(len(r.seq) for r in reqs))
        return self.pipeline.synthesise_batch(
            *pad_ids([r.seq for r in reqs], T, B), n_timesteps=self.n_timesteps,
            temperature=self.temperature, length_scale=rate, generator=self._next_generator(),
            pack_wav=self.pipeline.pcm24_transfer, spks=speaker_batch(spk, B))

    def _hand_over(self, reqs, out):
        if self.pipelined:
            # to the responder; blocks only when 2 batches await their fetch
            self._completion_q.put((reqs, out))
        else:
            self._complete(reqs, out)

    def _route_x(self, n: int) -> int:
        """The smallest warmed x bucket that holds ``n`` ids (the plain
        bucket grid when no warmed one does)."""
        for b in self._warm_x:
            if b >= n:
                return b
        return pick_bucket(n, X_BUCKETS)

    def _pick_fused_bucket(self, T_x: int, rate: float, has_spk: bool,
                           n_ids: int) -> Optional[int]:
        """The warmed fast-path bucket that ``fit_y_bucket`` picks, as for
        ``"auto"``; None when none is warmed for the key. The saturation
        check in ``_complete`` catches an underestimate."""
        buckets = self._fused_warm.get((T_x, rate, has_spk))
        return self.pipeline.fit_y_bucket(buckets, n_ids, rate) if buckets else None

    def _complete(self, reqs, out):
        """Fetch a batch's results and wake its clients."""
        with tracing.span("serve.complete", batch=reqs[0].batch):
            self._fetch_and_wake(reqs, out)
        if tracing.enabled():
            for r in reqs:
                if r.error is None:
                    _record_request(r)

    def _fetch_and_wake(self, reqs, out):
        try:
            wavs, mel_lengths = fetch_fused_host(out)
            decoded, rerun = _frames_decoded(out), 0
            T_y = out.get("_fused_T_y")
            if T_y is not None:
                self.n_fast += 1
                ml0 = int(mel_lengths[0])
                if ml0 < T_y and reqs[0].speaking_rate > 0:
                    # calibrate from every result that did not saturate
                    self.pipeline.observe_dur_ratio(
                        ml0 / (len(reqs[0].seq) * reqs[0].speaking_rate))
                if ml0 >= T_y:
                    # the warmed bucket was too small: run the request again
                    # on the dynamic path, at a warmed x bucket
                    r = reqs[0]
                    x1, xl1 = pad_ids([r.seq], self._route_x(len(r.seq)))
                    with tracing.span("serve.rerun", batch=r.batch):
                        out2 = self.pipeline.synthesise_batch(
                            x1, xl1, n_timesteps=self.n_timesteps,
                            temperature=self.temperature, length_scale=r.speaking_rate,
                            generator=self._next_generator(),
                            pack_wav=self.pipeline.pcm24_transfer, spks=speaker_batch(r.spk, 1))
                        wavs, mel_lengths = fetch_fused_host(out2)
                    decoded, rerun = decoded + _frames_decoded(out2), 1
        except Exception as e:  # a device error: fail the batch, serve on
            with self._lock:
                self._in_flight -= 1
            for r in reqs:
                r.error = f"{type(e).__name__}: {e}"
                r.done.set()
            return
        with self._lock:  # pairs with the timeout re-check of _wait
            self.n_batches += 1
            self.n_rerun += rerun
            self.frames_decoded += decoded
            self._in_flight -= 1
            for i, r in enumerate(reqs):
                n = int(mel_lengths[i])
                self.frames_answered += n
                r.n_frames = n
                r.wav = wavs[i, :n * HOP]
                r.t_done = time.perf_counter()
                r.done.set()

    def _respond_loop(self):
        """Fetch launched batches and wake their clients (pipelined mode)."""
        while True:
            item = self._completion_q.get()
            if item is None:
                return
            self._complete(*item)

    # -- warmup -----------------------------------------------------------
    def warmup(self, pairs):
        """Run every shape the (T_x, T_y) pairs can reach before serving.

        The dynamic path at every power-of-two B up to ``max_batch``, every
        ``Y_BUCKETS`` mel bucket up to T_y and every ``VOC_BUCKETS`` length
        inside each (the finer vocoder bucket a batch is sliced to): on the
        card that loads cuDNN's and cuFFT's plans and K1's library. Then the
        fast path's graphs (B = 1) are captured at mel buckets
        {max(64, T_y // 2), T_y} with the default speaker and registered;
        they are the only graphs the daemon replays (for every speaker),
        since the pipeline refuses captures outside this call. Texts
        longer than the largest warmed T_x are refused from here on, and
        shorter ones route up to a warmed T_x."""
        p = self.pipeline
        sizes, b = {1}, 1
        while b < self.max_batch:
            b *= 2
            sizes.add(b)
        p.capture_allowed = True
        try:
            with torch.inference_mode():
                for T_x, T_y in pairs:
                    self._warm_dynamic(T_x, T_y, sorted(sizes))
                    if self.fused_single and p.vocoder is not None and len(p.replicas) == 1:
                        key = (T_x, self.default_rate, self.default_spk is not None)
                        for T_f in sorted({max(64, T_y // 2), T_y}):
                            p.synthesise_batch(
                                *pad_ids([np.ones(T_x, np.int32)], T_x),
                                n_timesteps=self.n_timesteps, temperature=self.temperature,
                                length_scale=self.default_rate, fixed_y_bucket=T_f,
                                generator=self.call_generator(0),
                                spks=speaker_batch(self.default_spk, 1))
                            self._fused_warm[key] = sorted(set(self._fused_warm.get(key, []))
                                                           | {T_f})
            for r in p.replicas:
                if r.device.type == "cuda":
                    torch.cuda.synchronize(r.device)
        finally:
            p.capture_allowed = False
        if pairs:
            self.max_warm_x = max(self.max_warm_x or 0, max(T_x for T_x, _ in pairs))
            self._warm_x = sorted(set(self._warm_x) | {T_x for T_x, _ in pairs})

    def _warm_dynamic(self, T_x: int, T_y: int, sizes) -> None:
        """Every replica at the rows a batch of each size gives it."""
        p = self.pipeline
        y_buckets = [y for y in Y_BUCKETS if y <= T_y] or [T_y]
        for B in sizes:
            for r, rows in p._parts(B):
                self._warm_replica(r, rows.stop - rows.start, T_x, y_buckets)

    def _warm_replica(self, r, B: int, T_x: int, y_buckets) -> None:
        gen = torch.Generator(r.device).manual_seed(call_seed(self.seed, 0))
        x, xl = (torch.from_numpy(a).to(r.device)
                 for a in pad_ids([np.ones(T_x, np.int64)] * B, T_x, dtype=np.int64))
        spks = None if self.default_spk is None else torch.full(
            (B,), self.default_spk, dtype=torch.int64, device=r.device)
        mu_x, w_ceil, y_lengths = r.model.encode(x, xl, self.default_rate, spks)
        for T_yb in y_buckets:
            out = r.model.decode(mu_x, w_ceil, xl, y_lengths, self.n_timesteps,
                                 self.temperature, y_max_length=T_yb, generator=gen, spks=spks)
            # every vocoder bucket of the longest mels that land in T_yb
            prev_y = max([y for y in Y_BUCKETS if y < T_yb], default=0)
            for T_voc in sorted({voc_bucket(m, T_yb) for m in range(prev_y + 1, T_yb + 1)}):
                r.vocode_decoded(out, T_voc, r.pcm24_transfer)


def make_http_server(batcher: BatchingServer, host: str = "127.0.0.1", port: int = 8080):
    """A ThreadingHTTPServer wired to the batcher (stdlib only)."""
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):  # no access log
            pass

        def _json(self, code, obj):
            body = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/healthz":
                self._json(200, {"status": "ok", **batcher.counters()})
            else:
                self._json(404, {"error": "not found"})

        def _stream(self, payload, text):
            """The header at once, then 24-bit PCM per sentence chunk as its
            batch finishes (the body ends when the connection closes)."""
            self.send_response(200)
            self.send_header("Content-Type", "audio/wav")
            self.send_header("X-Sample-Rate", str(SR))
            self.end_headers()
            self.wfile.write(wav_stream_header())
            self.wfile.flush()
            for r in batcher.submit_stream(text, payload.get("speaking_rate"), payload.get("spk"),
                                           max_chars=payload["max_chars"]):
                if r.error:
                    break  # an error mid-stream closes the connection early
                self.wfile.write(pcm24(r.wav))
                self.wfile.flush()

        def do_POST(self):
            traced = tracing.enabled()
            t_recv = time.perf_counter() if traced else 0.0
            if self.path not in ("/synthesise", "/synthesise_long", "/synthesise_stream"):
                self._json(404, {"error": "not found"})
                return
            try:
                n = max(0, int(self.headers.get("Content-Length", 0)))
                if n > MAX_BODY_BYTES:
                    self._json(413, {"error": f"body exceeds {MAX_BODY_BYTES} bytes"})
                    return
                payload = json.loads(self.rfile.read(n) or b"{}")
                if not isinstance(payload, dict):
                    raise TypeError("payload must be a JSON object")
                text = payload["text"]
                if not isinstance(text, str):
                    raise TypeError("text must be a string")
                # everything the client typed is checked before any 200
                # header goes out (the stream writes its header first);
                # max_chars <= 0 would spin the sentence splitter
                payload["max_chars"] = min(2000, max(20, int(payload.get("max_chars", 200))))
                if payload.get("speaking_rate") is not None:
                    payload["speaking_rate"] = float(payload["speaking_rate"])
                if payload.get("spk") is not None:
                    payload["spk"] = int(payload["spk"])
                # a speaker out of range is a bad request, answered before
                # anything is queued (or a stream's header goes out)
                batcher.resolve_spk(payload.get("spk"))
            # ValueError covers bad JSON, a bad Content-Length and bodies
            # that are not UTF-8; TypeError a payload that is not an object
            except (KeyError, ValueError, TypeError) as e:
                self._json(400, {"error": f"bad request: {e}"})
                return
            if self.path == "/synthesise_stream":
                try:
                    self._stream(payload, text)
                except Exception as e:
                    self.log_error("stream failed: %s", e)
                return
            try:
                if self.path == "/synthesise_long":
                    reqs = batcher.submit_long(text, payload.get("speaking_rate"),
                                               payload.get("spk"), max_chars=payload["max_chars"])
                    err = next((r.error for r in reqs if r.error), None)
                    if err:
                        self._json(500, {"error": err})
                        return
                    req = reqs[0]
                    req.wav = np.concatenate([r.wav for r in reqs])
                    req.t_done = max(r.t_done for r in reqs)
                else:
                    req = batcher.submit(text, payload.get("speaking_rate"), payload.get("spk"))
            except Exception as e:  # the text frontend refused the text
                self._json(400, {"error": f"text processing failed: {e}"})
                return
            if req.error:
                self._json(500, {"error": req.error})
                return
            if not traced:
                self._respond(payload, req)
                return
            # the parse and text to ids, up to the (first) request's enqueue
            tracing.record("serve.frontend", tracing.ns(t_recv), tracing.ns(req.t_enqueue),
                           parent=req.rid, tid=threading.get_ident(), req=req.rid)
            with tracing.span("serve.respond", parent=req.rid, req=req.rid):
                self._respond(payload, req)

        def _respond(self, payload, req):
            latency_ms = (req.t_done - req.t_enqueue) * 1e3
            audio_s = len(req.wav) / SR
            if payload.get("format") == "json":
                self._json(200, {"n_samples": int(len(req.wav)),
                                 "audio_seconds": round(audio_s, 3),
                                 "latency_ms": round(latency_ms, 2),
                                 "rtf": round(latency_ms / 1e3 / max(audio_s, 1e-9), 4)})
                return
            body = wav_bytes(req.wav)
            self.send_response(200)
            self.send_header("Content-Type", "audio/wav")
            self.send_header("Content-Length", str(len(body)))
            self.send_header("X-Latency-Ms", f"{latency_ms:.2f}")
            self.end_headers()
            self.wfile.write(body)

    return ThreadingHTTPServer((host, port), Handler)


def _parse_warmup(spec: str):
    pairs = []
    for part in spec.split(","):
        if not part.strip():
            continue
        tx, ty = part.split(":")
        pairs.append((int(tx), int(ty)))
    return pairs


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="🍵 Matcha-TTS (PyTorch port) serving daemon")
    p.add_argument("--model", type=str, default="matcha_ljspeech", choices=list(MATCHA_URLS))
    p.add_argument("--checkpoint_path", type=str, default=None,
                   help="a custom Matcha checkpoint: a Lightning .ckpt or the port's native "
                        "checkpoint_<step>")
    p.add_argument("--vocoder", type=str, default=None, choices=list(VOCODER_URLS))
    p.add_argument("--host", type=str, default="127.0.0.1")
    p.add_argument("--port", type=int, default=8080)
    p.add_argument("--max-batch", type=int, default=8)
    p.add_argument("--batch-window-ms", type=float, default=10.0)
    p.add_argument("--steps", type=int, default=10)
    p.add_argument("--temperature", type=float, default=0.667)
    p.add_argument("--speaking_rate", type=float, default=None)
    p.add_argument("--spk", type=int, default=None,
                   help="default speaker of a multi-speaker model (0, with a warning, when "
                        "omitted); requests may name their own with \"spk\"")
    p.add_argument("--warmup", type=str, default="128:512",
                   help="comma list of Tx:Ty bucket pairs to warm up (empty to skip)")
    p.add_argument("--no-fused-single", action="store_true",
                   help="disable the single-request fast path (one replay of a B=1 CUDA graph; "
                        "saves its warmup captures)")
    p.add_argument("--cleaner", type=str, default="english_cleaners2")
    p.add_argument("--bf16-vocoder", action="store_true",
                   help="bf16 vocoder weights and activations (the clip, the denoiser and the "
                        "PCM packing stay f32); the warmed graphs are captured so")
    p.add_argument("--no-pallas-vocoder", action="store_true",
                   help="every vocoder stage as cuDNN convs, no fused MRF kernel")
    p.add_argument("--data-parallel", action="store_true",
                   help="one replica of the models per visible GPU, each batch's rows split "
                        "over them (the single-request fast path is then off); a no-op with "
                        "one GPU")
    p.add_argument("--vocoder-chunk", type=int, default=0)
    p.add_argument("--cpu", action="store_true", help="run on the CPU (default: CUDA)")
    p.add_argument("--trace-spans", type=str, default=None, metavar="PATH",
                   help="record the daemon's spans (utils/tracing.py) and write the last "
                        f"{tracing.RING_SPANS} as a Chrome trace JSON file at shutdown")
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    # the CLI's model-registry checks (they fill the vocoder, rate and spk)
    args.text, args.file, args.batched = "x", None, False
    args = validate_args(args)
    device = resolve_device("cpu" if args.cpu else None)
    if args.trace_spans:
        tracing.enable()
    paths = assert_required_models_available(args)
    model = load_matcha(paths["matcha"], device)
    default_spk = resolve_speaker(model, args.spk)
    vocoder, bias = load_vocoder(paths["vocoder"], device, name=args.vocoder)
    devices = data_parallel_devices(args.data_parallel, device)
    pipeline = TTSPipeline(model, vocoder, bias, cleaner=args.cleaner,
                           device=devices[0] if devices else device,
                           vocoder_chunk=args.vocoder_chunk, vocoder_bf16=args.bf16_vocoder,
                           vocoder_pallas=not args.no_pallas_vocoder, devices=devices)
    batcher = BatchingServer(pipeline, max_batch=args.max_batch,
                             batch_window_ms=args.batch_window_ms, n_timesteps=args.steps,
                             temperature=args.temperature,
                             default_rate=args.speaking_rate,
                             default_spk=default_spk,
                             fused_single=not args.no_fused_single)
    pairs = _parse_warmup(args.warmup)
    if pairs:
        print(f"[!] Warming {len(pairs)} bucket pair(s) x batch sizes {{1,{args.max_batch}}}...",
              flush=True)
        t0 = time.time()
        batcher.warmup(pairs)
        print(f"[+] Warm in {time.time() - t0:.0f}s", flush=True)
    server = make_http_server(batcher, args.host, args.port)
    print(f"[🍵] Serving on http://{args.host}:{server.server_address[1]} "
          f"(max_batch={args.max_batch}, window={args.batch_window_ms}ms)", flush=True)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        server.server_close()
        batcher.shutdown()
        if args.trace_spans:
            n = tracing.write_chrome(args.trace_spans)
            print(f"[+] {n} spans written to {args.trace_spans}", flush=True)


if __name__ == "__main__":
    main()
