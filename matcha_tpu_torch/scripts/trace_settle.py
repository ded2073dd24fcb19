"""Whether a ``torch.profiler`` trace holds every kernel of a CUDA graph's
last replay, by how long the trace stays open after its last synchronise.

LJSpeech MatchaTTS + HiFi-GAN v1 with weights from a seed, f32 with TF32
off: ``bench.py``'s staged corpus (128 utterances of 64-192 ids, length
scale 3.5, B = 8, 10 steps) through ``synthesise_corpus(fuse_stages=True)``,
one CUDA graph per bucket triple, captured in a first untraced pass. Then
``--passes`` rounds, each tracing one pass per ``--settle`` value: the
trace stays open that many seconds after the pass's last synchronise. Per
traced pass: the graph launches, K1's device events, and the device events
of the last launch against the first's (``graph_launch_counts``): every
launch replays all nodes of its graph, so a last launch with fewer events
than the first shows the trace losing records. ``chip_smoke.py`` takes
``TRACE_SETTLE_S`` and ``graph_launch_counts`` from here.

Usage: python -m matcha_tpu_torch.scripts.trace_settle [--passes 5] [--settle 0 0.5 1]

One JSON line per traced pass, then one summary line with the card's name
and power limit.
"""

import argparse
import collections
import json
import subprocess
import time

import numpy as np
import torch

SEED = 1234
CLEANER = "english_cleaners_no_espeak"
#: seconds a trace stays open after its last synchronise. The profiler gets
#: the records of a graph's kernels some time after the replay ends: closed
#: at once, a trace of the corpus's fused stage can lose the last 30 device
#: events of its last replay, K1's second launch among them (on an H100:
#: 1 pass of 5 closed at once, none of 5 left open 0.5 s or 1 s)
TRACE_SETTLE_S = 1.0


def graph_launch_counts(prof) -> dict:
    """Per ``cudaGraphLaunch`` in a ``torch.profiler`` trace, in launch
    order: the device events that share its correlation id, and K1's
    (``mrf_stage_kernel``) among them."""
    events = prof.profiler.kineto_results.events()
    launches = sorted(e.correlation_id() for e in events if e.name() == "cudaGraphLaunch")
    ids = set(launches)
    total, k1 = collections.Counter(), collections.Counter()
    for e in events:
        if e.device_type() == torch.autograd.DeviceType.CUDA and e.correlation_id() in ids:
            total[e.correlation_id()] += 1
            k1[e.correlation_id()] += "mrf_stage_kernel" in e.name()
    return {"graph_launches": len(launches),
            "device_events_per_launch": [total[c] for c in launches],
            "k1_per_launch": [k1[c] for c in launches]}


def corpus_utterances(n: int = 128, seed: int = SEED) -> list:
    """``bench.py``'s filelist: ``n`` id sequences of 64-192 ids."""
    rng = np.random.default_rng(seed)
    lengths = rng.integers(64, 193, size=n)
    return [rng.integers(1, 178, size=(int(k),)).astype(np.int32) for k in lengths]


def traced_pass(pipe, utts, settle_s: float) -> dict:
    """One fused-stage pass over ``utts`` under ``torch.profiler`` (device
    activity), left open ``settle_s`` after its last synchronise."""
    from torch.profiler import ProfilerActivity, profile

    gen = torch.Generator(pipe.device).manual_seed(SEED)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        list(pipe.synthesise_corpus(utts, batch_size=8, fuse_stages=True, generator=gen,
                                    n_timesteps=10, temperature=0.667, length_scale=3.5))
        torch.cuda.synchronize()
        time.sleep(settle_s)
    c = graph_launch_counts(prof)
    events = c["device_events_per_launch"]
    return {"settle_s": settle_s, "graph_launches": c["graph_launches"],
            "k1": sum(c["k1_per_launch"]), "k1_last": c["k1_per_launch"][-1],
            "events_first": events[0], "events_last": events[-1],
            "short": events[-1] < events[0]}


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--passes", type=int, default=5, help="rounds of traced passes")
    parser.add_argument("--settle", type=float, nargs="+", default=[0.0, 0.5, 1.0],
                        help="seconds each round's traces stay open, one pass per value")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("trace_settle: needs a CUDA device")

    from matcha_tpu_torch.pipeline import TTSPipeline
    from matcha_tpu_torch.models.denoiser import compute_bias_spec
    from matcha_tpu_torch.models.hifigan import Generator, HiFiGANConfig
    from matcha_tpu_torch.models.hifigan_fused import generator_apply_fused
    from matcha_tpu_torch.models.matcha import MatchaTTS

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    torch.manual_seed(SEED)
    model = MatchaTTS()
    vocoder = Generator(HiFiGANConfig()).to(dev).eval()
    bias = compute_bias_spec(lambda m: generator_apply_fused(vocoder, m), device=dev)
    pipe = TTSPipeline(model, vocoder, bias, cleaner=CLEANER, device=dev)
    utts = corpus_utterances()
    list(pipe.synthesise_corpus(utts, batch_size=8, fuse_stages=True,  # captures the graphs
                                generator=torch.Generator(dev).manual_seed(SEED),
                                n_timesteps=10, temperature=0.667, length_scale=3.5))
    short = collections.Counter()
    for rnd in range(args.passes):
        for settle in args.settle:
            row = traced_pass(pipe, utts, settle)
            short[settle] += row["short"]
            print(json.dumps({"round": rnd, **row}), flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(json.dumps({"nvidia_smi": smi, "passes_per_settle": args.passes,
                      "short_last_launch": {str(k): v for k, v in short.items()}}), flush=True)


if __name__ == "__main__":
    main()
