"""Offered load on the port's serving daemon (``matcha_tpu_torch/serve.py``).

The counterpart of ``scripts/bench_serve.py``. It drives the in-process
``BatchingServer`` (the daemon's request path without the socket) with N
client threads issuing requests back to back for a fixed time, and
reports:

* request throughput (req/s) and audio throughput (x realtime), counting
  only requests that finished inside the window;
* latency per request, p50 / p90 / p99, and the largest;
* requests per batch (requests / batches run);
* with ``stream=True`` client 0 streams a long text instead and its time
  to first audio is reported, under load and (``ttfa_unloaded``) alone.

    python3 -m matcha_tpu_torch.scripts.bench_serve [--clients 8] [--duration 30]
        [--window-ms 10] [--max-batch 8] [--pipelined | --ab] [--cpu]

It builds the full-width LJSpeech Matcha + HiFi-GAN v1 with weights drawn
from SEED (the work per request is what trained weights cost; durations
differ), and warms the daemon at WARMUP with its default rate RATE, as
the JAX script does. ``chip_smoke.py`` calls ``run_window`` and
``summarise`` on a daemon of its own.
"""

import argparse
import json
import subprocess
import threading
import time

import numpy as np

SENTENCES = [
    "The quick brown fox jumps over the lazy dog.",
    "A TPU chip multiplies matrices in a systolic array.",
    "Flow matching learns a straight path from noise to data.",
    "The weather tomorrow will be partly cloudy with light winds.",
    "Speech synthesis has improved dramatically in recent years.",
    "Please confirm the reservation for four people at seven.",
    "Monotonic alignment search finds the best path through the grid.",
    "This sentence exists to vary the token length distribution a bit more.",
]
LONG_TEXT = " ".join(SENTENCES[:4])  # a multi-sentence article
SR = 22050
SEED = 1234
# the daemon's default rate, the JAX script's (bench.py's length scale)
RATE = 3.5
# the x buckets the sentences and the stream's chunks route to
WARMUP = [(128, 1024), (192, 1024)]


def run_window(batcher, clients: int, duration: float, stream: bool = False,
               sentences=SENTENCES, timeout_s: float = 600.0) -> dict:
    """``clients`` threads, each sending random sentences (seeded by its
    index) back to back for ``duration`` seconds; with ``stream`` client 0
    streams ``LONG_TEXT`` instead. Any request that errors raises here
    once the threads have joined. Returns the raw samples."""
    lat_ms, ttfa_ms, audio_in_window, errors = [], [], [], []
    n_req = [0]
    lock = threading.Lock()
    n0 = batcher.n_batches, batcher.n_requests
    t_start = time.perf_counter()
    stop = t_start + duration

    def client(ci):
        rng = np.random.default_rng(ci)
        try:
            while time.perf_counter() < stop:
                if stream and ci == 0:
                    t0, first = time.perf_counter(), None
                    for r in batcher.submit_stream(LONG_TEXT, max_chars=80, timeout_s=timeout_s):
                        if r.error:
                            raise RuntimeError(r.error)
                        t1 = time.perf_counter()
                        first = t1 if first is None else first
                        with lock:
                            if t1 < stop:
                                audio_in_window.append(len(r.wav) / SR)
                    with lock:
                        ttfa_ms.append((first - t0) * 1e3)
                    continue
                text = sentences[rng.integers(0, len(sentences))]
                t0 = time.perf_counter()
                r = batcher.submit(text, timeout_s=timeout_s)
                t1 = time.perf_counter()
                if r.error:
                    raise RuntimeError(r.error)
                with lock:
                    lat_ms.append((t1 - t0) * 1e3)
                    if t1 < stop:
                        n_req[0] += 1
                        audio_in_window.append(len(r.wav) / SR)
        except Exception as e:
            with lock:
                errors.append(f"client {ci}: {type(e).__name__}: {e}")

    threads = [threading.Thread(target=client, args=(i,)) for i in range(clients)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise RuntimeError(f"{len(errors)} client(s) failed: {errors[:3]}")
    return {"lat_ms": lat_ms, "ttfa_ms": ttfa_ms, "n_req": n_req[0],
            "audio_s": float(sum(audio_in_window)), "duration": duration,
            "batches": batcher.n_batches - n0[0], "requests": batcher.n_requests - n0[1],
            "wall_s": time.perf_counter() - t_start}


def _percentiles(xs, qs=(50, 90, 99)) -> dict:
    return {f"p{q}": float(np.percentile(xs, q)) for q in qs} if xs else None


def summarise(raw: dict, clients: int, window_ms: float, max_batch: int,
              pipelined: bool) -> dict:
    """The reported numbers of one ``run_window``."""
    return {"clients": clients, "window_ms": window_ms, "max_batch": max_batch,
            "pipelined": pipelined,
            "req_per_s": raw["n_req"] / raw["duration"],
            "audio_x_realtime": raw["audio_s"] / raw["duration"],
            "latency_ms": _percentiles(raw["lat_ms"]),
            "max_latency_ms": max(raw["lat_ms"]) if raw["lat_ms"] else None,
            "requests_per_batch": raw["requests"] / max(raw["batches"], 1),
            "batches": raw["batches"], "requests": raw["requests"],
            "ttfa_ms": _percentiles(raw["ttfa_ms"], (50, 90)), "wall_s": raw["wall_s"]}


def ttfa_unloaded(batcher, reps: int = 5) -> float:
    """Median time to the first chunk of a stream on an idle server (each
    stream drained before the next)."""
    solo = []
    for _ in range(reps):
        t0, first = time.perf_counter(), None
        for r in batcher.submit_stream(LONG_TEXT, max_chars=80):
            if r.error:
                raise RuntimeError(r.error)
            first = (time.perf_counter() - t0) * 1e3 if first is None else first
        solo.append(first)
    return float(np.median(solo))


def build_pipeline(device, seed: int):
    """The full-width LJSpeech Matcha + HiFi-GAN v1, weights from ``seed``."""
    import torch

    from matcha_tpu_torch.pipeline import TTSPipeline
    from matcha_tpu_torch.models.denoiser import compute_bias_spec
    from matcha_tpu_torch.models.hifigan import Generator, HiFiGANConfig
    from matcha_tpu_torch.models.hifigan_fused import generator_apply_fused
    from matcha_tpu_torch.models.matcha import MatchaTTS

    torch.manual_seed(seed)
    model = MatchaTTS()
    vocoder = Generator(HiFiGANConfig()).to(device).eval()
    bias = compute_bias_spec(lambda m: generator_apply_fused(vocoder, m), device=device)
    return TTSPipeline(model, vocoder, bias, cleaner="english_cleaners_no_espeak",
                       device=device)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--clients", type=int, default=8)
    ap.add_argument("--duration", type=float, default=30.0)
    ap.add_argument("--window-ms", type=float, default=10.0)
    ap.add_argument("--max-batch", type=int, default=8)
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--pipelined", action="store_true",
                    help="the opt-in scheduler: a responder thread fetches results")
    ap.add_argument("--ab", action="store_true",
                    help="both schedulers, one after the other, in one process")
    ap.add_argument("--cpu", action="store_true", help="run on the CPU (default: CUDA)")
    args = ap.parse_args(argv)

    from matcha_tpu_torch import resolve_device
    from matcha_tpu_torch.serve import BatchingServer

    device = resolve_device("cpu" if args.cpu else None)
    pipeline = build_pipeline(device, SEED)
    batcher = BatchingServer(pipeline, max_batch=args.max_batch, batch_window_ms=args.window_ms,
                             n_timesteps=args.steps, default_rate=RATE, pipelined=args.pipelined)
    try:
        t0 = time.perf_counter()
        batcher.warmup(WARMUP)
        warm_s = time.perf_counter() - t0
        for s in SENTENCES:  # every sentence once, alone
            batcher.submit(s)
        run_window(batcher, args.clients, min(5.0, args.duration), stream=True)
        smi = None
        if device.type == "cuda":
            smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                                  "--format=csv,noheader"], capture_output=True, text=True,
                                 check=True).stdout.strip().splitlines()[0]
        for mode in ([False, True] if args.ab else [args.pipelined]):
            batcher.pipelined = mode
            raw = run_window(batcher, args.clients, args.duration, stream=True)
            result = summarise(raw, args.clients, args.window_ms, args.max_batch, mode)
            result.update(ttfa_unloaded_ms=ttfa_unloaded(batcher), warmup_s=warm_s,
                          dur_ratio=pipeline._dur_ratio, nvidia_smi=smi, device=str(device))
            print(json.dumps(result), flush=True)
    finally:
        batcher.shutdown()


if __name__ == "__main__":
    main()
