#!/usr/bin/env python3
"""Drive the PyTorch port (``matcha_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one output line each (any failure exits non-zero):

1. the card (``nvidia-smi`` name and power limit) and the torch / CUDA /
   nvcc / Triton versions;
2. the build of the three CUDA sources in ``matcha_tpu_torch/csrc`` (one
   ``nvcc`` each, started together) and its seconds;
3. kernel K1 (the fused MRF stage, 3xTF32 on the tensor cores) against
   its plain PyTorch version on the card, TF32 off, at every C in 16..128
   in steps of 16, B in {1, 3}, T shorter than one tile, 1000, two tiles
   + 37 (not a multiple of the tile) and 8192, and one chain of one
   dilation; kernel
   K3 (the MRF stage on channels-last activations, K1's 3xTF32 conv pass)
   against its plain version (the phase-packed products) and against K1
   on the transposed input, at C in {16, 32, 48, 64}, B in {1, 3}, T in
   {100, 700, two tiles + 37, 8192}, and at a clamped explicit tile, with
   whether it equals K1 bit for bit; kernel K2 (Monotonic Alignment
   Search) against its plain version on the card, which must be EQUAL,
   over B, T_x, T_y, ragged lengths, ties and mask dtypes, and at the
   edges of its instances (T_x in {31, 32, 33, 1024, 1025, 4096}, T_y in
   {1, 7, 33, 2051}), with each instance's shared memory as the kernel
   computes it against ``mas_layout``'s;
4. the serving path at full width: LJSpeech MatchaTTS + HiFi-GAN v1 with
   weights drawn from a seed, phoneme ids -> wav through ``TTSPipeline``
   on a few sentences, with the kernels' launch counts read around it;
   the vocoder's variant path (``generator_apply_fused`` with subpixel
   upsamples, K3 on the narrow stages, the fused cap at 128) at the main
   path's shape and at the profilers' B = 8 x 1,024 frames, each variant
   against the plain generator with its K1 and K3 launches counted; then
   the pipeline on a short sentence on the GPU and on the CPU (plain
   path), which must agree;
5. times after warm-up: per-request latency and real-time factor, one
   request split by stage (encode, decode, vocoder, denoise), the card's
   busy time and idle share over that request (``torch.profiler``); the
   fixed-bucket path (``fused_path``): each sentence at an integer bucket
   and under ``"auto"``, one CUDA graph per bucket replayed against the
   same body run eagerly on the card (equal mel lengths, waveform within
   1e-5), K1's launches inside one replay from the profiler trace, replay
   and eager latency in turns, their device busy time, and capture
   seconds and memory per bucket; K1 per
   stage at the path's shapes, at a 512-frame mel and at every mel bucket
   the fixed-bucket path ran (up to 2,048 frames), beside its f32 and
   tensor-core bounds, its plain version and a chain of cuDNN ``F.conv1d``
   calls; K1 over explicit tiles at two short T (the tile floor); K3 per
   narrow stage and K1 at C = 128 at the main path's shape and at
   B = 8 x 1,024 frames, likewise (K3's yardstick: a transpose, the cuDNN
   chain, and a transpose back);
6. the training path at full width (the LJSpeech config, batch 32, no
   segment cut) on a synthetic corpus written from the seed: 5 steps of
   ``python -m matcha_tpu_torch.train`` (through ``train.main``) with
   checkpoints, K2's launches counted against the MAS calls, then one
   step resumed from the ``last`` checkpoint; one ``losses`` + backward on
   the card and on the CPU, which must agree; step time, mel frames per
   second, peak memory, one step split by phase, the card's busy time
   over a step, and K2 at the step's shape beside its bound and its plain
   version, its call split under ``torch.profiler`` into the kernel and
   the wrapper's other device operations;
7. the ``kernels`` line (every TPU kernel of the repo: K1, K2 and K3, all
   ported), then the last line ``{"ok": true, "device": {...}}``.

All f32 with TF32 off, so that every comparison is against full f32.
"""

import csv
import itertools
import json
import math
import os
import statistics
import subprocess
import sys
import tempfile
import time

SEED = 1234
# the three serving sentences are SENTENCES of matcha_tpu_torch/scripts/profile_latency.py
SHORT_SENTENCE = "Hello world."
CLEANER = "english_cleaners_no_espeak"
# H100 SXM published peaks (NVIDIA data sheet): f32 outside the tensor cores,
# TF32 on the tensor cores (dense), HBM3
PEAK_F32_FLOPS = 67e12
PEAK_TF32_FLOPS = 495e12
PEAK_BYTES_PER_S = 3.35e12
# 3xTF32 products summed in f32 over up to 1,408 terms per conv, in another
# order than cuDNN's
K1_TOL = 1e-4
# a full-width vocoder variant against the plain generator, on the tanh
# output: the fused stages' f32 sums in another order than cuDNN's
VARIANT_TOL = 1e-5
# vocoder variants: generator_apply_fused options (None: the plain
# generator) and the K1 and K3 launches each call must make
VARIANTS = {
    "full_pallas_dilated": ({}, 2, 0),
    "full_pallas_subpixel": ({"upsample_impl": "subpixel"}, 2, 0),
    "full_xla_dilated": (None, 0, 0),
    "full_xla_subpixel": (None, 0, 0),
    "full_pallas_phase": ({"narrow_impl": "phase"}, 0, 2),
    "full_pallas_phase_subpixel": ({"narrow_impl": "phase", "upsample_impl": "subpixel"}, 0, 2),
    "cap128_plain": ({"max_fused_channels": 128}, 3, 0),
    "cap128_phase": ({"max_fused_channels": 128, "narrow_impl": "phase"}, 1, 2),
}
PROFILER_SHAPE = (8, 1024)  # B, T_mel of scripts/profile_vocoder*.py
# the port's kernels as the profiler names them (K1, K3, K2)
KERNEL_NAMES = ("mrf_stage_kernel", "mrf_phase_kernel", "mas_kernel")
# the fixed-bucket path: a replay of its CUDA graph against the same body
# run eagerly on the card, on the waveform (the same kernels in the same
# order; cuDNN may pick other algorithms under capture)
GRAPH_TOL = 1e-5
FUSED_REPS = 10  # timed requests per sentence and mode, after one warm-up
# GPU against CPU for one training step's losses and gradient norm: f32
# sums in another order through the full-width model (TF32 off)
TRAIN_RTOL = 1e-4
SR, HOP = 22050, 256
N_TRAIN, N_VAL = 64, 8
TRAIN_STEPS = 5
# public-domain sentences (the Harvard sentences); the corpus cuts runs of
# their words to each clip's length
CORPUS_TEXT = (
    "The birch canoe slid on the smooth planks. Glue the sheet to the dark blue background. "
    "It's easy to tell the depth of a well. These days a chicken leg is a rare dish. "
    "Rice is often served in round bowls. The juice of lemons makes fine punch. "
    "The box was thrown beside the parked truck. The hogs were fed chopped corn and garbage. "
    "Four hours of steady work faced us. A large size in stockings is hard to sell. "
    "The boy was there when the sun rose. A rod is used to catch pink salmon. "
    "The source of the huge river is the clear spring. Kick the ball straight and follow "
    "through. Help the woman get back to her feet. A pot of tea helps to pass the evening. "
    "Smoky fires lack flame and heat. The soft cushion broke the man's fall. "
    "The salt breeze came across from the sea. The girl at the booth sold fifty bonds.")


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def cuda_ms(fn, reps: int) -> float:
    """Mean device time of ``fn()`` over ``reps`` calls, CUDA events."""
    import torch

    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def k1_bound_ms(B: int, C: int, T: int, kernel_sizes, dilations) -> dict:
    """Least time for one stage: the larger of its conv FLOPs over the f32
    peak and its bytes (x read, y written, weights read once) over HBM
    (``bound_ms``); and with the products as K1 takes them, 3 TF32
    products per f32 product over the TF32 tensor-core peak
    (``bound_tc_ms``, bytes alike)."""
    taps = 2 * sum(k * len(d) for k, d in zip(kernel_sizes, dilations))
    flops = 2.0 * B * T * C * C * taps
    weight_floats = sum(2 * len(d) * (k * C * C + C) for k, d in zip(kernel_sizes, dilations))
    t_bytes = 4.0 * (2 * B * C * T + weight_floats) / PEAK_BYTES_PER_S
    t_ops, t_tc = flops / PEAK_F32_FLOPS, 3 * flops / PEAK_TF32_FLOPS
    return {"bound_ms": 1e3 * max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "bound_tc_ms": 1e3 * max(t_tc, t_bytes)}


def device_busy(request, latency_ms: float) -> dict:
    """One ``request()`` under ``torch.profiler``: the time the card spent
    in kernels and copies (union of their intervals), the number of them,
    the names that took the most, and the idle share against the request's
    unprofiled ``latency_ms``. "not measured" when the trace holds no
    device events."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    request()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        request()
        torch.cuda.synchronize()
        profiled_ms = (time.perf_counter() - t0) * 1e3
    events = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    if not events:
        return {"busy_ms": "not measured", "idle_share": "not measured",
                "kernel_launches": "not measured"}
    launches = {k: sum(k in e.name for e in events) for k in KERNEL_NAMES}
    busy_us, end = 0.0, float("-inf")
    by_name = {}
    for e in sorted(events, key=lambda e: e.time_range.start):
        start, stop = e.time_range.start, e.time_range.end
        busy_us += max(0.0, stop - max(start, end))
        end = max(end, stop)
        name = e.name[:60]
        by_name[name] = by_name.get(name, 0.0) + (stop - start) / 1e3
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    return {"busy_ms": busy_us / 1e3, "device_ops": len(events),
            "latency_ms": latency_ms, "idle_share": 1.0 - busy_us / 1e3 / latency_ms,
            "profiled_ms": profiled_ms, "top_ms": dict(top), "kernel_launches": launches,
            "note": "busy = union of device event intervals under torch.profiler; idle "
                    "share against the unprofiled p50 latency of the same request; "
                    "kernel_launches = the device events of each port kernel, by name"}


def k2_bound_ms(B: int, T_x: int, T_y: int, t_xs, t_ys):
    """Least time for one MAS call: the larger of its bytes (the log-prior
    read once, the path written once, both (B, T_x, T_y) f32) over HBM and
    its operations (a max, an add and a compare per cell of each row's
    t_x x t_y grid) over the f32 peak."""
    bytes_ = 2 * 4.0 * B * T_x * T_y
    ops = 3.0 * sum(int(a) * int(b) for a, b in zip(t_xs, t_ys))
    t_ops, t_bytes = ops / PEAK_F32_FLOPS, bytes_ / PEAK_BYTES_PER_S
    return 1e3 * max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


def mas_problem(gen, dev, B, T_x, T_y, t_xs, t_ys, values, bool_mask):
    """(value, mask) on ``dev``: per-row lengths t_xs, t_ys; values normal,
    all zero, or small integers (ties everywhere)."""
    import torch

    if values == "normal":
        value = torch.randn(B, T_x, T_y, generator=gen) * 3
    elif values == "zeros":
        value = torch.zeros(B, T_x, T_y)
    else:
        value = torch.randint(-2, 3, (B, T_x, T_y), generator=gen).float()
    t_xs, t_ys = torch.tensor(t_xs), torch.tensor(t_ys)
    mask = ((torch.arange(T_x)[None, :, None] < t_xs[:, None, None])
            & (torch.arange(T_y)[None, None, :] < t_ys[:, None, None]))
    return value.to(dev), (mask if bool_mask else mask.float()).to(dev)


def k2_check(dev) -> list:
    """K2 against its plain version on the card: the paths must be EQUAL."""
    import torch

    from matcha_tpu_torch.ops import mas

    gen = torch.Generator().manual_seed(SEED)
    ragged32 = [int(v) for v in torch.randint(1, 385, (32,), generator=gen)]
    lib = mas._library()
    cases = [  # B, T_x, T_y, t_xs, t_ys, values, bool mask
        (1, 1, 8, [1], [8], "normal", False),
        (4, 37, 901, [37, 30, 5, 1], [901, 500, 37, 8], "normal", False),
        (4, 37, 901, [37, 30, 5, 1], [901, 500, 37, 8], "zeros", True),
        (32, 384, 901, ragged32, [min(901, 3 * v) for v in ragged32], "normal", False),
        (32, 384, 901, ragged32, [min(901, 2 * v + 7) for v in ragged32], "ints", True),
        (4, 700, 2048, [700, 600, 384, 1], [2048, 1800, 901, 8], "normal", False),
        (4, 700, 2048, [700, 600, 384, 1], [2048, 1800, 901, 8], "zeros", False),
        (1, 700, 901, [700], [901], "ints", False),
        (32, 37, 8, [8] * 16 + [3] * 16, [8] * 32, "ints", False),
        (4, 384, 901, [384, 384, 37, 1], [200, 901, 8, 1], "normal", False),  # t_x > t_y
        # the instances' edges: one lane's cells (T_x 31-33: 1 and 2 per
        # lane), float4 and scalar tile reads (1024, 1025), the widest
        # (4096); T_y 1, 7, 33 (shorter than a tile, T_y % 4 != 0) and 2051
        (3, 31, 33, [31, 20, 0], [33, 33, 5], "ints", True),  # an empty row
        (3, 32, 7, [32, 7, 1], [7, 7, 7], "normal", False),  # t_x > t_y
        (3, 33, 1, [33, 1, 1], [1, 1, 1], "normal", False),
        (2, 33, 2051, [33, 17], [2051, 40], "ints", False),
        (2, 1024, 33, [1024, 33], [33, 33], "zeros", True),
        (2, 1024, 2051, [1024, 700], [2051, 1500], "normal", False),
        (2, 1025, 2051, [1025, 3], [2051, 2051], "ints", True),
        (2, 1025, 7, [1025, 7], [7, 7], "normal", False),
        (2, 4096, 2051, [4096, 2000], [2051, 2051], "normal", False),  # row 0: t_x > t_y
        (2, 4096, 1, [4096, 1], [1, 1], "ints", True),
    ]
    out = []
    for B, T_x, T_y, t_xs, t_ys, values, bool_mask in cases:
        value, mask = mas_problem(gen, dev, B, T_x, T_y, t_xs, t_ys, values, bool_mask)
        got = mas.maximum_path(value, mask)
        want = mas.maximum_path_reference(value, mask)
        torch.cuda.synchronize()
        layout = mas.mas_layout(T_x, T_y)
        cpl, _, rows, smem = layout
        equal = torch.equal(got, want) and got.dtype == mask.dtype
        out.append({"B": B, "T_x": T_x, "T_y": T_y, "values": values,
                    "mask": "bool" if bool_mask else "float32", "equal": equal,
                    "cells_on_path": int(got.sum()), "layout": layout,
                    "kernel_smem_bytes": lib.mas_smem_bytes(cpl, rows)})
        if not equal:
            raise AssertionError(f"K2 differs from its plain version: {out[-1]}")
        if out[-1]["kernel_smem_bytes"] != smem:
            raise AssertionError(f"K2's shared memory differs from mas_layout's: {out[-1]}")
    return out


def write_corpus(root: str, seed: int = SEED) -> dict:
    """A synthetic single-speaker corpus at LJSpeech's clip lengths: 64
    train and 8 val 22,050 Hz wavs of 1.5-10 s (tones, vibrato and noise),
    each with a run of real words long enough for about 3 mel frames per
    id (blanks included), as in LJSpeech. Returns the filelist paths."""
    import numpy as np

    from matcha_tpu_torch.utils.utils import write_wav

    rng = np.random.default_rng(seed)
    words = CORPUS_TEXT.split()
    lines = []
    for i in range(N_TRAIN + N_VAL):
        n = int(rng.uniform(1.5, 10.0) * SR)
        chars = max(8, round((n / HOP / 3 - 1) / 2))  # ids = 2 * chars + 1
        start, text = int(rng.integers(len(words))), []
        while len(" ".join(text)) < chars:
            text.append(words[(start + len(text)) % len(words)])
        t = np.arange(n) / SR
        f0 = rng.uniform(90, 250)
        audio = (0.3 * np.sin(2 * np.pi * (f0 * t + 3 * np.sin(2 * np.pi * 0.7 * t)))
                 + 0.1 * np.sin(2 * np.pi * 3.1 * f0 * t) + rng.normal(0, 0.02, n))
        path = os.path.join(root, f"clip_{i:03d}.wav")
        write_wav(path, audio.astype(np.float32), SR)
        lines.append(f"{path}|{' '.join(text)}")
    paths = {"train": os.path.join(root, "train.txt"), "val": os.path.join(root, "val.txt")}
    for name, part in (("train", lines[:N_TRAIN]), ("val", lines[N_TRAIN:])):
        with open(paths[name], "w", encoding="utf-8") as f:
            f.write("\n".join(part) + "\n")
    return paths


def train_overrides(corpus: dict, out_dir: str) -> list:
    """The full-width LJSpeech training config (batch 32, out_size null)
    on the synthetic corpus: cleaners without espeak, CSV metrics every
    step, checkpoints on."""
    return ["experiment=ljspeech", f"data.train_filelist_path={corpus['train']}",
            f"data.valid_filelist_path={corpus['val']}", f"data.cleaners=[{CLEANER}]",
            "data.frontend=numpy", "logger=csv", "trainer.log_every_n_steps=1",
            f"paths.output_dir={out_dir}"]


def read_metrics(out_dir: str) -> list:
    with open(os.path.join(out_dir, "csv", "metrics.csv"), encoding="utf-8") as f:
        return [{k: float(v) for k, v in row.items() if v} for row in csv.DictReader(f)]


def run_train(argv) -> dict:
    """``train.main(argv)`` with K2's launches and the MAS calls counted
    from 0 over it."""
    from matcha_tpu_torch import train
    from matcha_tpu_torch.models import matcha as matcha_module
    from matcha_tpu_torch.ops import mas

    calls = [0]
    search = matcha_module.maximum_path

    def counted(value, mask):
        calls[0] += 1
        return search(value, mask)

    matcha_module.maximum_path = counted
    mas.LAUNCHES["maximum_path"] = 0
    t0 = time.perf_counter()
    try:
        train.main(argv)
    finally:
        matcha_module.maximum_path = search
    return {"seconds": time.perf_counter() - t0, "mas_calls": calls[0],
            "k2_launches": mas.LAUNCHES["maximum_path"]}


def train_path(root: str) -> dict:
    """The training path through its entry point: 5 steps with
    checkpoints, then 1 step resumed from ``last``."""
    corpus = write_corpus(root)
    out_dir, resume_dir = os.path.join(root, "run"), os.path.join(root, "resumed")
    run = run_train(train_overrides(corpus, out_dir) + [f"trainer.max_steps={TRAIN_STEPS}"])
    rows = read_metrics(out_dir)
    train_rows = [r for r in rows if "loss/train" in r]
    val_rows = [r for r in rows if "loss/val" in r]
    losses = [v for r in rows for k, v in r.items() if k.startswith(("loss/", "sub_loss/"))]
    last = os.path.join(out_dir, "checkpoints", "last")
    if len(train_rows) != TRAIN_STEPS or not val_rows or not all(map(math.isfinite, losses)):
        raise AssertionError(f"training logged {len(train_rows)} steps, {len(val_rows)} "
                             f"validations, finite: {all(map(math.isfinite, losses))}")
    if run["k2_launches"] != run["mas_calls"] or run["mas_calls"] < TRAIN_STEPS:
        raise AssertionError(f"K2 launched {run['k2_launches']} times for {run['mas_calls']} "
                             "MAS calls")
    if not os.path.exists(last):
        raise AssertionError("no `last` checkpoint")
    resumed = run_train(train_overrides(corpus, resume_dir)
                        + [f"trainer.max_steps={TRAIN_STEPS + 1}", f"ckpt_path={last}"])
    with open(os.path.join(resume_dir, "checkpoints", "last.hparams.json"), encoding="utf-8") as f:
        resumed_step = json.load(f)["step"]
    resumed_rows = [r for r in read_metrics(resume_dir) if "loss/train" in r]
    if (resumed_step != TRAIN_STEPS + 1 or len(resumed_rows) != 1
            or resumed["k2_launches"] != resumed["mas_calls"]
            or not math.isfinite(resumed_rows[0]["loss/train"])):
        raise AssertionError(f"resume: step {resumed_step}, rows {resumed_rows}, {resumed}")
    return {"corpus": corpus, "out_dir": out_dir, "run": run, "resumed": resumed,
            "train_rows": train_rows, "val_rows": val_rows, "resumed_row": resumed_rows[0]}


def train_gpu_vs_cpu(dev, cfg, batch) -> dict:
    """One ``losses`` + backward on the first 2 items, on the card and on
    the CPU: same weights, t and z, dropout off."""
    import torch

    from matcha_tpu_torch import train
    from matcha_tpu_torch.training.trainer import global_norm

    small = {k: torch.from_numpy(batch[k][:2]) for k in ("x", "x_lengths", "y", "y_lengths")}
    torch.manual_seed(SEED)
    model = train.build_model_from_cfg(cfg).eval()
    g = torch.Generator().manual_seed(SEED)
    t = torch.rand(2, generator=g)
    z = torch.randn(small["y"].shape, generator=g)
    results = {}
    for name, device in (("gpu", dev), ("cpu", torch.device("cpu"))):
        model.to(device).zero_grad(set_to_none=True)
        out = model.losses(small["x"].long().to(device), small["x_lengths"].to(device),
                           small["y"].to(device), small["y_lengths"].to(device),
                           t=t.to(device), z=z.to(device))
        sum(out[:3]).backward()
        norm = global_norm([p.grad for p in model.parameters() if p.grad is not None])
        results[name] = {"losses": [float(v.detach()) for v in out[:3]],
                         "attn": out[3].detach().cpu(),
                         "grad_norm": float(norm)}
    gpu, cpu = results["gpu"], results["cpu"]
    rel = [abs(a - b) / abs(b) for a, b in zip(gpu["losses"] + [gpu["grad_norm"]],
                                              cpu["losses"] + [cpu["grad_norm"]])]
    attn_equal = torch.equal(gpu["attn"], cpu["attn"])
    line = {"T_x": int(small["x"].shape[1]), "T_y": int(small["y"].shape[1]),
            "attn_equal": attn_equal, "losses_gpu": gpu["losses"], "losses_cpu": cpu["losses"],
            "grad_norm_gpu": gpu["grad_norm"], "grad_norm_cpu": cpu["grad_norm"],
            "max_rel_diff": max(rel), "rtol": TRAIN_RTOL}
    if not attn_equal or not max(rel) <= TRAIN_RTOL:
        raise AssertionError(f"training step differs between GPU and CPU: {line}")
    return line


def train_time(dev, cfg) -> tuple:
    """Step time and its split, peak memory and the card's busy share
    over one step, at the training config's full width. Steps run twice:
    on batches loaded beforehand (no loader thread runs beside the step),
    then as the trainer runs them, with the loader thread preparing the
    next batch meanwhile."""
    import torch

    from matcha_tpu_torch import train
    from matcha_tpu_torch.training.trainer import (
        make_optimizer,
        prefetch_iterator,
        to_device,
        train_step,
    )

    torch.manual_seed(SEED)
    dm = train.build_datamodule_from_cfg(cfg)
    model = train.build_model_from_cfg(cfg).to(dev)
    opt, sched = make_optimizer(model, lr=float(cfg.model.optimizer.lr))
    step = itertools.count()

    def run_steps(source):
        ms, frames, shapes = [], [], []
        for _ in range(TRAIN_STEPS):
            t0 = time.perf_counter()
            raw = next(source)
            train_step(model, opt, sched, to_device(raw, dev), next(step), SEED)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
            frames.append(int(raw["y_lengths"].sum()))
            shapes.append(tuple(raw["y"].shape[:2]) + (int(raw["x"].shape[1]),))
        return ms, frames, shapes, raw

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    # whole epochs, so that no loader thread is left running
    loaded = [b for epoch in range(3) for b in list(dm.train_batches(epoch))][:TRAIN_STEPS]
    pre_ms, _, _, raw = run_steps(iter(loaded))
    pre_p50 = statistics.median(pre_ms[1:])
    batch = to_device(raw, dev)
    busy = device_busy(lambda: train_step(model, opt, sched, batch, next(step), SEED), pre_p50)

    loader = prefetch_iterator((b for epoch in itertools.count()
                                for b in dm.train_batches(epoch)), pin=True)
    step_ms, frames, shapes, raw = run_steps(loader)
    marks = []

    def mark(name):
        torch.cuda.synchronize()
        marks.append((name, time.perf_counter()))

    mark("start")
    split_raw = next(loader)
    split_batch = to_device(split_raw, dev)
    mark("data_wait")
    train_step(model, opt, sched, split_batch, next(step), SEED, on_phase=mark)
    split = {name: (t - t_prev) * 1e3 for (_, t_prev), (name, t) in zip(marks, marks[1:])}
    peak = torch.cuda.max_memory_allocated()
    p50 = statistics.median(step_ms[1:])
    line = {"batch": len(raw["x_lengths"]), "shapes_B_Ty_Tx": shapes, "step_ms": step_ms,
            "step_ms_p50_steps_2_5": p50,
            "mel_frames_per_s": sum(frames[1:]) / (sum(step_ms[1:]) / 1e3),
            "max_memory_allocated_GiB": peak / 2**30, "split_ms": split,
            "preloaded_step_ms": pre_ms, "preloaded_step_ms_p50_steps_2_5": pre_p50,
            "device_busy_preloaded_step": busy,
            "note": "host clock, synchronised after each step; p50 of steps 2-5; step_ms with "
                    "the trainer's loader thread running, preloaded_step_ms on batches loaded "
                    "beforehand; the split is one more loader step with a synchronise after "
                    "each phase; the busy time is one preloaded step under torch.profiler, its "
                    "idle share against preloaded_step_ms_p50"}
    return line, raw


def k2_time(dev, raw) -> dict:
    """K2 at the training step's batch shape and lengths (log-prior values
    drawn from the seed), beside its bound and its plain version."""
    import torch

    from matcha_tpu_torch.ops import mas
    from matcha_tpu_torch.scripts.profile_mas import mas_split

    B, T_x, T_y = len(raw["x_lengths"]), raw["x"].shape[1], raw["y"].shape[1]
    t_xs, t_ys = [int(v) for v in raw["x_lengths"]], [int(v) for v in raw["y_lengths"]]
    gen = torch.Generator().manual_seed(SEED)
    value, mask = mas_problem(gen, dev, B, T_x, T_y, t_xs, t_ys, "normal", False)
    split = mas_split(lambda: mas.maximum_path(value, mask), 20)
    plain_ms = cuda_ms(lambda: mas.maximum_path_reference(value, mask), 2)
    equal = torch.equal(mas.maximum_path(value, mask), mas.maximum_path_reference(value, mask))
    if not equal:
        raise AssertionError("K2 differs from its plain version at the step's shape")
    bound_ms, bound_by = k2_bound_ms(B, T_x, T_y, t_xs, t_ys)
    return {"B": B, "T_x": T_x, "T_y": T_y, "max_t_x": max(t_xs), "max_t_y": max(t_ys),
            "layout": mas.mas_layout(T_x, T_y), "ms": split["ms"],
            "kernel_ms": split["kernel_ms"], "wrapper_ms": split["wrapper_ms"],
            "device_ops_per_call": split["device_ops_per_call"], "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "serial_steps": 2 * max(t_ys),
            "library_ms": None, "equal": equal, "library": "none: no PyTorch call computes MAS",
            "note": "ms: CUDA events, mean of 20 calls of the wrapper; kernel_ms and wrapper_ms: "
                    "torch.profiler device time per call over 20 more, the kernel and the "
                    "wrapper's other device operations; plain_ms: CUDA events, mean of 2; "
                    "serial_steps = the forward's and the backtrack's dependent row steps"}


def random_stage_weights(gen, C: int, dev, kernel_sizes, n_dil: int = 3):
    """One MRF stage's weights from ``gen``, packed as the kernels take them."""
    import torch

    from matcha_tpu_torch.ops import mrf

    return mrf.pack_mrf_weights([
        (torch.randn(shape, generator=gen) * (0.3 / (k * C) ** 0.5)).to(dev)
        for k in kernel_sizes
        for shape in ((n_dil, k, C, C), (n_dil, C), (n_dil, k, C, C), (n_dil, C))])


def k1_check(dev, gen, kernel_sizes, dilations) -> tuple:
    """K1 against its plain version on the card at every width it takes:
    T shorter than one tile, 1000, two tiles + 37 (not a multiple of the
    tile), 8192; then one chain of one dilation (k = 3, d = 1)."""
    import torch

    from matcha_tpu_torch.ops import mrf

    worst, cases = 0.0, []
    stages = [(C, B, T, kernel_sizes, dilations)
              for C in range(16, mrf.MAX_CHANNELS + 1, 16) for B in (1, 3)
              for T in (100, 1000, 2 * mrf.pick_t_tile(C, 10**6, B=B) + 37, 8192)]
    for C, B, T, ks, dils in stages + [(64, 3, 1000, (3,), ((1,),))]:
        x = torch.randn(B, C, T, generator=gen).to(dev)
        weights = random_stage_weights(gen, C, dev, ks, len(dils[0]))
        got = mrf.fused_mrf_stage(x, weights, ks, dils)
        want = mrf.fused_mrf_stage_reference(x, weights, ks, dils)
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        cases.append({"C": C, "B": B, "T": T, "t_tile": mrf.pick_t_tile(C, T, B=B),
                      "chains": len(ks), "dilations": len(dils[0]), "max_abs_err": err})
        worst = max(worst, err)
        if not (got.shape == x.shape and err < K1_TOL):
            raise AssertionError(f"K1 disagrees: {cases[-1]}")
    return worst, cases


def k1_tiles(dev, gen, kernel_sizes, dilations) -> list:
    """K1 at B = 1 over explicit tiles at two short T, beside the tile
    ``pick_t_tile`` chooses: where a smaller tile stops paying is the
    floor of its choice (``mrf.MIN_TILE``)."""
    import torch

    from matcha_tpu_torch.ops import mrf

    rows = []
    for C, T in ((64, 4096), (32, 8192)):
        x = torch.randn(1, C, T, generator=gen).to(dev)
        weights = random_stage_weights(gen, C, dev, kernel_sizes)
        row = {"C": C, "T": T, "picked": mrf.pick_t_tile(C, T), "ms": {}}
        for t in (16, 32, 48, 64, 96, 128, 192):
            row["ms"][t] = cuda_ms(lambda t=t: mrf.fused_mrf_stage(x, weights, kernel_sizes,
                                                                   dilations, t_tile=t), 10)
        rows.append(row)
    return rows


def k3_check(dev, gen, kernel_sizes, dilations) -> dict:
    """K3 against its plain version (the phase-packed products) and
    against K1 on the transposed input, on the card, at every width it
    takes: T shorter than one tile, 700, two of the batch's tiles + 37 (not
    a multiple of the tile), 8192; then JAX's default tile of 2048, which
    K3 clamps to the largest that fits. Both within K1_TOL; whether K3
    equals K1 bit for bit is reported."""
    import torch

    from matcha_tpu_torch.ops import mrf, mrf_phase

    stages = [(C, B, T, None) for C in (16, 32, 48, 64) for B in (1, 3)
              for T in (100, 700, 2 * mrf.pick_t_tile(C, 10**6, B=B) + 37, 8192)]
    worst, cases = 0.0, []
    for C, B, T, t_tile in stages + [(64, 3, 1000, 2048)]:
        x = torch.randn(B, T, C, generator=gen).to(dev)
        weights = random_stage_weights(gen, C, dev, kernel_sizes)
        got = mrf_phase.fused_mrf_stage_phase(x, weights, kernel_sizes, dilations, t_tile=t_tile)
        want = mrf_phase.fused_mrf_stage_phase_reference(x, weights, kernel_sizes, dilations)
        k1 = mrf.fused_mrf_stage(x.transpose(1, 2).contiguous(), weights, kernel_sizes,
                                 dilations).transpose(1, 2)
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        err_k1 = (got - k1).abs().max().item()
        cases.append({"C": C, "B": B, "T": T, "t_tile_given": t_tile,
                      "t_tile": mrf_phase.launch_geometry(C, T, B, t_tile)[0],
                      "max_abs_err": err, "max_abs_err_vs_k1": err_k1,
                      "equal_k1": torch.equal(got, k1)})
        worst = max(worst, err, err_k1)
        if not (got.shape == x.shape and err < K1_TOL and err_k1 < K1_TOL):
            raise AssertionError(f"K3 disagrees: {cases[-1]}")
    return {"tolerance": K1_TOL, "max_abs_err": worst,
            "max_abs_err_vs_plain": max(c["max_abs_err"] for c in cases),
            "max_abs_err_vs_k1": max(c["max_abs_err_vs_k1"] for c in cases),
            "equal_k1_cases": sum(c["equal_k1"] for c in cases), "n_cases": len(cases),
            "cases": cases}


def vocoder_variants(dev, vocoder, shapes) -> dict:
    """The vocoder's variant path at full width: every variant at each
    (label, B, T_mel) shape on one mel from the seed, 3 calls each, held
    against the plain generator with the same upsample; K1's and K3's
    launches set to 0 before and read after each variant's calls."""
    import torch

    from matcha_tpu_torch.models.hifigan import Generator
    from matcha_tpu_torch.models.hifigan_fused import fused_stage_weights, generator_apply_fused
    from matcha_tpu_torch.ops import mrf, mrf_phase

    reps = 3
    plain = {"dilated": vocoder, "subpixel": Generator(vocoder.h, upsample_impl="subpixel")}
    plain["subpixel"].load_state_dict(vocoder.state_dict())
    plain["subpixel"].to(dev).eval()
    packed = {64: fused_stage_weights(vocoder), 128: fused_stage_weights(vocoder, 128)}
    gen = torch.Generator().manual_seed(SEED + 7)
    out = {"tolerance": VARIANT_TOL, "calls_per_variant": reps, "shapes": []}
    totals = {"k1": 0, "k3": 0}
    for label, B, T_mel in shapes:
        mel = torch.randn(B, T_mel, vocoder.h.num_mels, generator=gen).to(dev)
        want = {impl: g(mel) for impl, g in plain.items()}
        rows = {}
        for name, (kwargs, k1_per_call, k3_per_call) in VARIANTS.items():
            impl = "subpixel" if "subpixel" in name else "dilated"
            if kwargs is None:
                def fn(impl=impl):
                    return plain[impl](mel)
            else:
                weights = packed[kwargs.get("max_fused_channels", 64)]

                def fn(kwargs=kwargs, weights=weights):
                    return generator_apply_fused(vocoder, mel, weights, **kwargs)
            torch.cuda.synchronize()
            mrf.LAUNCHES["mrf_stage"] = mrf_phase.LAUNCHES["mrf_stage_phase"] = 0
            err = 0.0
            for _ in range(reps):
                wav = fn()
                err = max(err, (wav - want["dilated" if kwargs is None else impl]).abs().max().item())
            torch.cuda.synchronize()
            k1, k3 = mrf.LAUNCHES["mrf_stage"], mrf_phase.LAUNCHES["mrf_stage_phase"]
            totals["k1"] += k1
            totals["k3"] += k3
            rows[name] = {"k1_launches": k1, "k3_launches": k3, "max_abs_err": err,
                          "ms": cuda_ms(fn, reps)}
            if (k1, k3) != (reps * k1_per_call, reps * k3_per_call):
                raise AssertionError(f"{name} at {label}: K1 launched {k1} and K3 {k3} times in "
                                     f"{reps} calls, expected {k1_per_call} and {k3_per_call} each")
            if not (wav.shape == (B, T_mel * 256, 1) and err < VARIANT_TOL
                    and bool(torch.isfinite(wav).all())):
                raise AssertionError(f"{name} at {label}: {tuple(wav.shape)}, error {err}")
        out["shapes"].append({"shape": label, "B": B, "T_mel": T_mel, "variants": rows})
    out["launches"] = totals
    out["note"] = ("error against the plain generator with the same upsample (the subpixel plain "
                   "generator against the dilated one); ms: CUDA events, mean of 3 calls after "
                   "the checked ones")
    return out


def stage_times(dev, vocoder, shapes) -> tuple:
    """K3 at every narrow stage (C <= 64) and K1 at C = 128, at each
    (label, B, T_mel) shape, on the activations a random mel gives there:
    each beside its bound, its plain version and its cuDNN yardstick, and
    K3 beside K1 on the same data."""
    import torch

    from matcha_tpu_torch.ops import mrf, mrf_phase

    h = vocoder.h
    ks, dils = h.resblock_kernel_sizes, h.resblock_dilation_sizes
    gen = torch.Generator().manual_seed(SEED + 8)
    k3_rows, k1_rows = [], []
    for label, B, T_mel in shapes:
        reps = 20 if B * T_mel <= 256 else 5
        mel = torch.randn(B, T_mel, h.num_mels, generator=gen).to(dev)
        with torch.inference_mode():
            x = vocoder.conv_pre(mel.transpose(1, 2))
            for i in range(len(vocoder.ups)):
                x = vocoder.upsample(i, x)
                C, T = x.shape[1], x.shape[2]
                if C == mrf.MAX_CHANNELS or 128 // C >= 2:
                    weights = mrf.mrf_weights_from_resblocks(vocoder.stage_blocks(i))
                    xc = x.contiguous()
                    row = {"shape": label, "B": B, "T_mel": T_mel, "C": C, "T": T,
                           **k1_bound_ms(B, C, T, ks, dils)}
                    if C == mrf.MAX_CHANNELS:
                        got = mrf.fused_mrf_stage(xc, weights, ks, dils)
                        want = mrf.fused_mrf_stage_reference(xc, weights, ks, dils)
                        row.update(
                            ms=cuda_ms(lambda: mrf.fused_mrf_stage(xc, weights, ks, dils), reps),
                            plain_ms=cuda_ms(lambda: mrf.fused_mrf_stage_reference(
                                xc, weights, ks, dils), reps),
                            library_ms=cuda_ms(lambda i=i: vocoder.mrf_stage(i, xc), reps),
                            max_abs_err=(got - want).abs().max().item())
                        k1_rows.append(row)
                    else:
                        xt = x.transpose(1, 2).contiguous()
                        got = mrf_phase.fused_mrf_stage_phase(xt, weights, ks, dils)
                        want = mrf_phase.fused_mrf_stage_phase_reference(xt, weights, ks, dils)
                        row.update(
                            ms=cuda_ms(lambda: mrf_phase.fused_mrf_stage_phase(
                                xt, weights, ks, dils), reps),
                            plain_ms=cuda_ms(lambda: mrf_phase.fused_mrf_stage_phase_reference(
                                xt, weights, ks, dils), reps),
                            library_ms=cuda_ms(lambda i=i: vocoder.mrf_stage(
                                i, xt.transpose(1, 2).contiguous()).transpose(1, 2).contiguous(),
                                reps),
                            k1_ms=cuda_ms(lambda: mrf.fused_mrf_stage(xc, weights, ks, dils), reps),
                            max_abs_err=(got - want).abs().max().item())
                        k3_rows.append(row)
                    if not row["max_abs_err"] < K1_TOL:
                        raise AssertionError(f"kernel disagrees at {row}")
                x = vocoder.mrf_stage(i, x)
    torch.cuda.synchronize()
    return k3_rows, k1_rows


def fused_path(dev, model, vocoder, bias, texts, requests, dynamic_lat) -> dict:
    """The fixed-bucket path at full width through ``TTSPipeline``: each
    sentence at one integer bucket (the first of ``FUSED_Y_BUCKETS`` above
    the longest mel) and under ``"auto"`` (the first call at the top
    bucket, then calibrated), a CUDA graph's replay against the same body
    run eagerly on the card (``cuda_graph=False``, its own pipeline, so
    that both calibrate alike) on the same noise; K1's launches inside one
    replay from a ``torch.profiler`` trace; replay and eager latency
    alternating in one process, and their device time; capture seconds
    and memory per bucket. K1's wrapper count is set to 0 before and read
    after (it counts at capture and in eager runs, never in a replay)."""
    import torch

    from matcha_tpu_torch.cli import TTSPipeline
    from matcha_tpu_torch.ops import mrf

    bucket = next(b for b in TTSPipeline.FUSED_Y_BUCKETS
                  if b > max(r["mel_frames"] for r in requests))
    pipes = {m: TTSPipeline(model, vocoder, bias, cleaner=CLEANER, device=dev)
             for m in ("graph", "eager")}
    modes = {"graph": None, "eager": False}
    seen = {}
    for mode, p in pipes.items():
        def spy(B, T_x, T_y, *a, _fn=p.fused_graph, _seen=seen.setdefault(mode, []), **k):
            _seen.append(T_y)
            return _fn(B, T_x, T_y, *a, **k)
        p.fused_graph = spy

    def noise(T_y):  # the same unit noise at a bucket in every mode
        g = torch.Generator().manual_seed(SEED + T_y)
        return torch.randn(1, T_y, model.n_feats, generator=g).to(dev)

    def run(mode, tp, fixed, **kw):
        return pipes[mode].synthesise_batch(tp["x"], tp["x_lengths"], fixed_y_bucket=fixed,
                                            cuda_graph=modes[mode], **kw)

    mrf.LAUNCHES["mrf_stage"] = 0
    checks = []
    for fixed in (bucket, "auto"):
        for i, tp in enumerate(texts):
            n = {m: len(seen[m]) for m in modes}
            z = noise(bucket) if fixed == bucket else noise
            out = {m: run(m, tp, fixed, z=z) for m in modes}
            torch.cuda.synchronize()
            g, e = out["graph"], out["eager"]
            T_y = g["mel"].shape[-1]
            err = (g["waveform"] - e["waveform"]).abs().max().item()
            row = {"bucket": fixed, "sentence": i, "buckets_run": seen["graph"][n["graph"]:],
                   "T_y": T_y, "mel_frames": int(g["mel_lengths"][0]),
                   "mel_lengths_equal": torch.equal(g["mel_lengths"], e["mel_lengths"]),
                   "max_abs_err": err, "bit_equal": torch.equal(g["waveform"], e["waveform"]),
                   "pcm24_bit_equal": torch.equal(g["wav_pcm24"], e["wav_pcm24"])}
            checks.append(row)
            if not (row["mel_lengths_equal"] and err <= GRAPH_TOL
                    and seen["graph"][n["graph"]:] == seen["eager"][n["eager"]:]
                    and g["waveform"].shape == (1, T_y * HOP) and row["mel_frames"] < T_y
                    and bool(torch.isfinite(g["waveform"]).all())):
                raise AssertionError(f"fixed-bucket graph against eager: {row}")
    if checks[len(texts)]["buckets_run"][0] != TTSPipeline.FUSED_Y_BUCKETS[-1]:
        raise AssertionError(f"the first 'auto' call ran at {checks[len(texts)]['buckets_run']}")
    wrapper_launches = mrf.LAUNCHES["mrf_stage"]

    # latency: a request draws its noise from a generator, graph and eager in turns
    lat = {}
    for i, tp in enumerate(texts):
        gens = {m: torch.Generator(dev).manual_seed(SEED + i) for m in modes}
        runs = {m: [] for m in modes}
        for _ in range(FUSED_REPS + 1):
            for m in modes:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = run(m, tp, bucket, generator=gens[m])
                torch.cuda.synchronize()
                runs[m].append(time.perf_counter() - t0)
        audio_s = int(out["mel_lengths"][0]) * HOP / SR
        dynamic = dynamic_lat[f"sentence_{i}"]
        row = lat[f"sentence_{i}"] = {"audio_s": audio_s, "dynamic_p50_ms": dynamic["p50_ms"],
                                      "dynamic_rtf": dynamic["rtf"]}
        for m in modes:
            ms = statistics.median(runs[m][1:]) * 1e3
            row.update({f"{m}_p50_ms": ms, f"{m}_rtf": ms / 1e3 / audio_s})
    tp = texts[1]
    gens = {m: torch.Generator(dev).manual_seed(SEED + 1) for m in modes}
    busy = {m: device_busy(lambda m=m: run(m, tp, bucket, generator=gens[m]),
                           lat["sentence_1"][f"{m}_p50_ms"]) for m in modes}
    replay_k1 = busy["graph"]["kernel_launches"]
    if replay_k1 != "not measured" and replay_k1["mrf_stage_kernel"] != 2:
        raise AssertionError(f"K1 ran {replay_k1} times in one replay, expected 2")
    captures = [{"T_x": fg.x.shape[1], "T_y": fg.T_y, "seconds": fg.capture_seconds,
                 "memory_allocated_before_after_MiB": [v / 2**20 for v in fg.memory_allocated]}
                for fg in pipes["graph"]._graphs.values() if fg.graph is not None]
    return {"integer_bucket": bucket, "tolerance": GRAPH_TOL, "checks": checks,
            "auto_buckets": [c["buckets_run"] for c in checks if c["bucket"] == "auto"],
            "k1_launches_per_replay": (replay_k1 if replay_k1 == "not measured"
                                       else replay_k1["mrf_stage_kernel"]),
            "k1_wrapper_launches": wrapper_launches, "latency": lat,
            "device_busy_graph": busy["graph"], "device_busy_eager": busy["eager"],
            "captures": captures,
            "note": f"latency: host clock around synthesise_batch at the integer bucket, "
                    f"synchronised, median of {FUSED_REPS} after 1 warm-up, graph and eager in "
                    f"turns; dynamic_p50_ms from the latency phase; device busy of one request "
                    f"of sentence 1; k1_wrapper_launches counts captures and eager runs"}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from matcha_tpu_torch.cli import VOC_BUCKETS, Y_BUCKETS, TTSPipeline, pick_bucket, process_text
    from matcha_tpu_torch.models.denoiser import compute_bias_spec
    from matcha_tpu_torch.models.hifigan import Generator, HiFiGANConfig
    from matcha_tpu_torch.models.hifigan_fused import MAX_FUSED_CHANNELS, generator_apply_fused
    from matcha_tpu_torch.models.matcha import MatchaTTS
    from matcha_tpu_torch.ops import cuda_build, mrf, mrf_phase
    from matcha_tpu_torch.scripts.profile_latency import SENTENCES, request_latency, stage_split

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")

    # 1. the card and the software
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    nvcc = subprocess.run([cuda_build.nvcc_path(), "--version"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[-1]
    try:
        import triton
        triton_version = triton.__version__
    except ImportError:
        triton_version = None
    emit({"phase": "device", "nvidia_smi": smi, "torch": torch.__version__,
          "cuda": torch.version.cuda, "nvcc": nvcc, "triton": triton_version,
          "python": sys.version.split()[0], "device_count": torch.cuda.device_count()})

    # 2. build K1, K2 and K3, one nvcc each, started together
    names = ("mrf_stage", "mas", "mrf_phase")
    compiled = [n for n in names if not cuda_build.library_path(n).exists()]
    t0 = time.perf_counter()
    cuda_build.load_all(names)
    emit({"phase": "build", "kernels": list(names), "seconds": round(time.perf_counter() - t0, 3),
          "compiled": compiled})

    # 3. K1 against its plain version
    h = HiFiGANConfig()
    ks, dils = h.resblock_kernel_sizes, h.resblock_dilation_sizes
    gen_cpu = torch.Generator().manual_seed(SEED)
    worst, cases = k1_check(dev, gen_cpu, ks, dils)
    emit({"phase": "k1_check", "tolerance": K1_TOL, "max_abs_err": worst, "cases": cases})
    k3 = k3_check(dev, gen_cpu, ks, dils)
    emit({"phase": "k3_check", **k3})
    k2_cases = k2_check(dev)
    emit({"phase": "k2_check", "rule": "torch.equal", "cases": k2_cases})

    # 4. the main path at full width, weights from the seed
    torch.manual_seed(SEED)
    model = MatchaTTS()
    vocoder = Generator(h).to(dev).eval()
    bias = compute_bias_spec(lambda m: generator_apply_fused(vocoder, m), device=dev)
    pipe = TTSPipeline(model, vocoder, bias, cleaner=CLEANER, device=dev)
    texts = [process_text(i, s, CLEANER) for i, s in enumerate(SENTENCES)]
    mrf.LAUNCHES["mrf_stage"] = mrf_phase.LAUNCHES["mrf_stage_phase"] = 0
    outs = []
    for i, tp in enumerate(texts):
        g = torch.Generator(dev).manual_seed(SEED + i)
        outs.append(pipe.synthesise_batch(tp["x"], tp["x_lengths"], generator=g))
    torch.cuda.synchronize()
    launches = mrf.LAUNCHES["mrf_stage"]
    if launches != 2 * len(texts) or mrf_phase.LAUNCHES["mrf_stage_phase"]:
        raise AssertionError(f"K1 launched {launches} times and K3 "
                             f"{mrf_phase.LAUNCHES['mrf_stage_phase']} for {len(texts)} vocoder "
                             "calls")
    requests = []
    for tp, out in zip(texts, outs):
        ml, T_y = int(out["mel_lengths"][0]), out["mel"].shape[-1]
        wav = out["waveform"]
        if not bool(torch.isfinite(wav).all()):
            raise AssertionError("non-finite waveform")
        T_voc = min(T_y, pick_bucket(min(ml, T_y), VOC_BUCKETS))
        if wav.shape != (1, T_voc * h.hop_size) or ml * h.hop_size > wav.shape[-1]:
            raise AssertionError(f"waveform {tuple(wav.shape)} for {ml} frames (bucket {T_voc})")
        requests.append({"ids": int(tp["x_lengths"][0]), "mel_frames": ml, "T_y": T_y,
                         "T_voc": T_voc, "samples": int(wav.shape[-1])})
    emit({"phase": "main_path", "model": "MatchaTTS LJSpeech defaults + HiFi-GAN v1, seed weights",
          "requests": requests, "k1_launches": launches, "vocoder_calls": len(texts)})

    # the vocoder's variant path, at the main path's shape and the profilers'
    shapes = [("main_path", 1, requests[0]["T_voc"]), ("profilers", *PROFILER_SHAPE)]
    variants = vocoder_variants(dev, vocoder, shapes)
    emit({"phase": "vocoder_variants", **variants})

    # the same pipeline on the CPU (plain path) must agree on a short input
    tp = process_text(99, SHORT_SENTENCE, CLEANER)
    mu_x, _, y_len = pipe.model.encode(torch.from_numpy(tp["x"]).long().to(dev),
                                       torch.from_numpy(tp["x_lengths"]).to(dev))
    T_y = pick_bucket(int(y_len.max()), Y_BUCKETS)
    z = torch.randn(1, T_y, model.n_feats, generator=torch.Generator().manual_seed(SEED))
    gpu_out = pipe.synthesise_batch(tp["x"], tp["x_lengths"], z=z)
    cpu_pipe = TTSPipeline(model.cpu(), vocoder.cpu(), bias.cpu(), cleaner=CLEANER, device="cpu")
    cpu_out = cpu_pipe.synthesise_batch(tp["x"], tp["x_lengths"], z=z)
    pipe = TTSPipeline(model, vocoder, bias, cleaner=CLEANER, device=dev)
    if not torch.equal(gpu_out["mel_lengths"].cpu(), cpu_out["mel_lengths"]):
        raise AssertionError("GPU and CPU mel lengths differ")
    # tolerance relative to the signal: f32 sums in another order through
    # ~40 conv layers
    checks = {}
    for key in ("mel", "waveform"):
        err = (gpu_out[key].cpu() - cpu_out[key]).abs().max().item()
        scale = cpu_out[key].abs().max().item()
        checks[key] = {"max_abs_err": err, "max_abs": scale, "tol": 1e-4 * scale + 1e-7}
        if not err <= checks[key]["tol"]:
            raise AssertionError(f"GPU and CPU pipelines disagree on {key}: {err}")
    emit({"phase": "gpu_vs_cpu", "sentence": SHORT_SENTENCE, **checks})

    # 5. times: latency per sentence, and where one request's time goes
    # (each stage of the path, synchronised)
    lat = request_latency(pipe, texts, 5)
    emit({"phase": "latency", "requests": lat, "note": "host clock around synthesise_batch, "
          "synchronised; median of 5 after 1 warm-up"})
    tp = texts[1]
    emit({"phase": "breakdown", "sentence": 1, **stage_split(pipe, tp, 3),
          "note": "host clock per stage, synchronised; median of 3 after 1 warm-up"})
    g = torch.Generator(dev).manual_seed(SEED + 1)
    emit({"phase": "device_busy", "sentence": 1, **device_busy(
        lambda: pipe.synthesise_batch(tp["x"], tp["x_lengths"], generator=g),
        lat["sentence_1"]["p50_ms"])})
    fused = fused_path(dev, model, vocoder, bias, texts, requests, lat)
    emit({"phase": "fused_path", **fused})
    torch.cuda.empty_cache()

    # K1 at the dynamic path's shape, at 512 frames, and at every mel bucket
    # the fixed-bucket graphs ran (their replays are held only against the
    # eager body, which runs K1 too)
    stages = []
    path_T_voc = requests[0]["T_voc"]
    fused_T = {fused["integer_bucket"], *itertools.chain.from_iterable(fused["auto_buckets"])}
    for T_mel, label in ((path_T_voc, "main_path"), (512, "T_mel_512"),
                         *((T, f"fused_path_{T}") for T in sorted(fused_T - {path_T_voc, 512}))):
        mel = torch.randn(1, T_mel, h.num_mels, generator=gen_cpu).to(dev)
        with torch.inference_mode():
            x = vocoder.conv_pre(mel.transpose(1, 2))
            for i in range(len(vocoder.ups)):
                x = vocoder.upsample(i, x)
                C, T = x.shape[1], x.shape[2]
                if C <= MAX_FUSED_CHANNELS:
                    weights = mrf.mrf_weights_from_resblocks(vocoder.stage_blocks(i))
                    xc = x.contiguous()
                    reps = 20 if T_mel <= 256 else 5
                    k_ms = cuda_ms(lambda: mrf.fused_mrf_stage(xc, weights, ks, dils), reps)
                    p_ms = cuda_ms(lambda: mrf.fused_mrf_stage_reference(xc, weights, ks, dils), reps)
                    l_ms = cuda_ms(lambda i=i: vocoder.mrf_stage(i, xc), reps)
                    err = (mrf.fused_mrf_stage(xc, weights, ks, dils)
                           - mrf.fused_mrf_stage_reference(xc, weights, ks, dils)).abs().max().item()
                    if not err < K1_TOL:
                        raise AssertionError(f"K1 disagrees at C={C} T={T} ({label}): {err}")
                    stages.append({"shape": label, "T_mel": T_mel, "C": C, "T": T,
                                   "t_tile": mrf.pick_t_tile(C, T), "ms": k_ms, "plain_ms": p_ms,
                                   "library_ms": l_ms, **k1_bound_ms(1, C, T, ks, dils),
                                   "max_abs_err": err})
                    emit({"phase": "k1_time", **stages[-1]})
                x = vocoder.mrf_stage(i, x)
    torch.cuda.synchronize()
    emit({"phase": "k1_tiles", "rows": k1_tiles(dev, gen_cpu, ks, dils),
          "note": "CUDA events, mean of 10 calls per explicit t_tile"})
    k3_rows, k1_wide = stage_times(dev, vocoder, shapes)
    for row in k3_rows:
        emit({"phase": "k3_time", **row})
    for row in k1_wide:
        emit({"phase": "k1_wide_time", **row})

    # 6. the training path at full width, on a corpus written from the seed
    from matcha_tpu_torch import train
    from matcha_tpu_torch.utils.config import compose

    del pipe, cpu_pipe, model, vocoder, bias
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as root:
        trained = train_path(root)
        emit({"phase": "train", "config": "experiment=ljspeech, batch 32, out_size null",
              "corpus": f"{N_TRAIN} train + {N_VAL} val synthetic wavs, 1.5-10 s",
              "run": trained["run"], "train_losses": trained["train_rows"],
              "val_losses": trained["val_rows"], "resumed": trained["resumed"],
              "resumed_step": trained["resumed_row"]})
        cfg = compose("train", train_overrides(trained["corpus"], trained["out_dir"]))
        first = next(train.build_datamodule_from_cfg(cfg).train_batches(0))
        emit({"phase": "train_gpu_vs_cpu", **train_gpu_vs_cpu(dev, cfg, first)})
        line, raw = train_time(dev, cfg)
        emit({"phase": "train_time", **line})
        k2 = k2_time(dev, raw)
        emit({"phase": "k2_time", **k2})

    # 7. kernels: K1's and K3's ms, plain_ms, bound_ms, library_ms summed
    # over the two narrow stages of one vocoder call at the serving path's
    # shape; K2's at the training step's shape
    path = [s for s in stages if s["shape"] == "main_path"]
    k3_path = [s for s in k3_rows if s["shape"] == "main_path"]
    emit({"kernels": [
        {"name": "mrf_stage", "route": "cuda", "status": "ported",
         "engine": "tensor cores: 3xTF32 mma.sync.m16n8k8, f32 sums",
         "source": "matcha_tpu_torch/csrc/mrf_stage.cu",
         "replaces": "matcha_tpu/ops/mrf_pallas.py:121",
         "launches": launches,
         "fused_path_launches_per_replay": fused["k1_launches_per_replay"],
         "max_abs_err": max([worst] + [s["max_abs_err"] for s in stages]),
         "ms": sum(s["ms"] for s in path),
         "plain_ms": sum(s["plain_ms"] for s in path),
         "bound_ms": sum(s["bound_ms"] for s in path),
         "bound_by": ("operations" if all(s["bound_by"] == "operations" for s in path)
                      else "bytes"),
         "bound_tc_ms": sum(s["bound_tc_ms"] for s in path),
         "library_ms": sum(s["library_ms"] for s in path)},
        {"name": "maximum_path", "route": "cuda", "status": "ported", "path": "training",
         "source": "matcha_tpu_torch/csrc/mas.cu",
         "replaces": "matcha_tpu/ops/mas_pallas.py:69",
         "engine": "one chain warp per batch row, cp.async log-prior tiles, per-lane bit words",
         "launches": trained["run"]["k2_launches"], "max_abs_err": 0.0, "ms": k2["ms"],
         "kernel_ms": k2["kernel_ms"], "wrapper_ms": k2["wrapper_ms"], "layout": k2["layout"],
         "plain_ms": k2["plain_ms"], "bound_ms": k2["bound_ms"], "bound_by": k2["bound_by"],
         "library_ms": None},
        {"name": "mrf_stage_phase", "route": "cuda", "status": "ported",
         "path": "vocoder variants, narrow_impl='phase'",
         "engine": "tensor cores: 3xTF32 mma.sync.m16n8k8, f32 sums",
         "source": "matcha_tpu_torch/csrc/mrf_phase.cu",
         "replaces": "matcha_tpu/ops/mrf_pallas.py:347",
         "launches": variants["launches"]["k3"],
         "max_abs_err": max([k3["max_abs_err"]] + [s["max_abs_err"] for s in k3_rows]),
         "ms": sum(s["ms"] for s in k3_path),
         "plain_ms": sum(s["plain_ms"] for s in k3_path),
         "bound_ms": sum(s["bound_ms"] for s in k3_path),
         "bound_by": ("operations" if all(s["bound_by"] == "operations" for s in k3_path)
                      else "bytes"),
         "bound_tc_ms": sum(s["bound_tc_ms"] for s in k3_path),
         "library_ms": sum(s["library_ms"] for s in k3_path)},
    ]})
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
