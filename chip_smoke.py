#!/usr/bin/env python3
"""Drive the PyTorch port (``matcha_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one output line each (any failure exits non-zero):

1. the card (``nvidia-smi`` name and power limit) and the torch / CUDA /
   nvcc / Triton versions;
2. the build of K1's CUDA source from ``matcha_tpu_torch/csrc`` and its
   seconds;
3. kernel K1 (the fused MRF stage) against its plain PyTorch version on
   the card, TF32 off, at C in {32, 64}, B in {1, 4}, T shorter than one
   tile, T not a multiple of the tile, and the main path's T;
4. the main path at full width: LJSpeech MatchaTTS + HiFi-GAN v1 with
   weights drawn from a seed, phoneme ids -> wav through ``TTSPipeline``
   on a few sentences, with K1's launch count read around it; then the
   same pipeline on a short sentence on the GPU and on the CPU (plain
   path), which must agree;
5. times after warm-up: per-request latency and real-time factor, one
   request split by stage (encode, decode, vocoder, denoise), the card's
   busy time and idle share over that request (``torch.profiler``), and K1 per
   stage at the path's shapes and at a 512-frame mel, beside its bound,
   its plain version and a chain of cuDNN ``F.conv1d`` calls;
6. the ``kernels`` line (every TPU kernel of the repo: K1 ported, K2 and
   K3 not yet, with null times), then the last line
   ``{"ok": true, "device": {...}}``.

All f32 with TF32 off, so that every comparison is against full f32.
"""

import json
import statistics
import subprocess
import sys
import time

SEED = 1234
SENTENCES = [
    "The birch canoe slid on the smooth planks.",
    "Printing, in the only sense with which we are at present concerned, differs from most "
    "if not from all the arts and crafts represented in the Exhibition.",
    "In 1834, Dr. Smith paid $3.50 for the 2nd edition; it was worth every cent.",
]
SHORT_SENTENCE = "Hello world."
CLEANER = "english_cleaners_no_espeak"
# H100 SXM published peaks (NVIDIA data sheet): f32 outside the tensor cores, HBM3
PEAK_F32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12
K1_TOL = 1e-4  # f32 sums over up to 704 products per conv, taken in another order


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


def k1_bound_ms(B: int, C: int, T: int, kernel_sizes, dilations):
    """Least time for one stage: the larger of its conv FLOPs over the f32
    peak and its bytes (x read, y written, weights read once) over HBM."""
    taps = 2 * sum(k * len(d) for k, d in zip(kernel_sizes, dilations))
    flops = 2.0 * B * T * C * C * taps
    weight_floats = sum(2 * len(d) * (k * C * C + C) for k, d in zip(kernel_sizes, dilations))
    bytes_ = 4.0 * (2 * B * C * T + weight_floats)
    t_ops, t_bytes = flops / PEAK_F32_FLOPS, bytes_ / PEAK_BYTES_PER_S
    return 1e3 * max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


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
        return {"busy_ms": "not measured", "idle_share": "not measured"}
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
            "profiled_ms": profiled_ms, "top_ms": dict(top),
            "note": "busy = union of device event intervals under torch.profiler; idle "
                    "share against the unprofiled p50 latency of the same request"}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    import numpy as np

    from matcha_tpu_torch.cli import (
        VOC_BUCKETS,
        X_BUCKETS,
        Y_BUCKETS,
        TTSPipeline,
        pick_bucket,
        process_text,
    )
    from matcha_tpu_torch.models.denoiser import compute_bias_spec, denoise
    from matcha_tpu_torch.models.hifigan import Generator, HiFiGANConfig
    from matcha_tpu_torch.models.hifigan_fused import MAX_FUSED_CHANNELS, generator_apply_fused
    from matcha_tpu_torch.models.matcha import MatchaTTS
    from matcha_tpu_torch.ops import cuda_build, mrf

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

    # 2. build K1
    compiled = not cuda_build.library_path("mrf_stage").exists()
    t0 = time.perf_counter()
    cuda_build.load("mrf_stage")
    emit({"phase": "build", "kernel": "mrf_stage", "seconds": round(time.perf_counter() - t0, 3),
          "compiled": compiled})

    # 3. K1 against its plain version
    h = HiFiGANConfig()
    ks, dils = h.resblock_kernel_sizes, h.resblock_dilation_sizes
    gen_cpu = torch.Generator().manual_seed(SEED)
    worst = 0.0
    cases = []
    for C in (32, 64):
        for B in (1, 4):
            for T in (100, 1000, 2 * 128 * 64 // (C // 32)):
                x = torch.randn(B, C, T, generator=gen_cpu).to(dev)
                weights = mrf.pack_mrf_weights([
                    (torch.randn(shape, generator=gen_cpu) * (0.3 / (k * C) ** 0.5)).to(dev)
                    for k in ks for shape in ((3, k, C, C), (3, C), (3, k, C, C), (3, C))])
                got = mrf.fused_mrf_stage(x, weights, ks, dils)
                want = mrf.fused_mrf_stage_reference(x, weights, ks, dils)
                torch.cuda.synchronize()
                err = (got - want).abs().max().item()
                cases.append({"C": C, "B": B, "T": T, "max_abs_err": err})
                worst = max(worst, err)
                if not err < K1_TOL:
                    raise AssertionError(f"K1 disagrees at C={C} B={B} T={T}: {err}")
    emit({"phase": "k1_check", "tolerance": K1_TOL, "max_abs_err": worst, "cases": cases})

    # 4. the main path at full width, weights from the seed
    torch.manual_seed(SEED)
    model = MatchaTTS()
    vocoder = Generator(h).to(dev).eval()
    bias = compute_bias_spec(lambda m: generator_apply_fused(vocoder, m), device=dev)
    pipe = TTSPipeline(model, vocoder, bias, cleaner=CLEANER, device=dev)
    texts = [process_text(i, s, CLEANER) for i, s in enumerate(SENTENCES)]
    mrf.LAUNCHES["mrf_stage"] = 0
    outs = []
    for i, tp in enumerate(texts):
        g = torch.Generator(dev).manual_seed(SEED + i)
        outs.append(pipe.synthesise_batch(tp["x"], tp["x_lengths"], generator=g))
    torch.cuda.synchronize()
    launches = mrf.LAUNCHES["mrf_stage"]
    if launches != 2 * len(texts):
        raise AssertionError(f"K1 launched {launches} times for {len(texts)} vocoder calls")
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

    # 5. times
    lat = {}
    for i, tp in enumerate(texts):
        g = torch.Generator(dev).manual_seed(SEED + i)
        runs = []
        for _ in range(6):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = pipe.synthesise_batch(tp["x"], tp["x_lengths"], generator=g)
            torch.cuda.synchronize()
            runs.append(time.perf_counter() - t0)
        ms = statistics.median(runs[1:]) * 1e3
        audio_s = int(out["mel_lengths"][0]) * h.hop_size / h.sampling_rate
        lat[f"sentence_{i}"] = {"p50_ms": ms, "audio_s": audio_s, "rtf": ms / 1e3 / audio_s}
    emit({"phase": "latency", "requests": lat, "note": "host clock around synthesise_batch, "
          "synchronised; median of 5 after 1 warm-up"})

    # where one request's time goes: each stage of the path, synchronised
    tp = texts[1]
    x_pad = np.zeros((1, pick_bucket(tp["x"].shape[-1], X_BUCKETS)), np.int64)
    x_pad[:, :tp["x"].shape[-1]] = tp["x"]
    x_t, xl = torch.from_numpy(x_pad).to(dev), torch.from_numpy(tp["x_lengths"]).to(dev)
    split = {}
    for rep in range(4):
        marks = [time.perf_counter()]

        def mark():
            torch.cuda.synchronize()
            marks.append(time.perf_counter())

        mu_x, w_ceil, y_len = model.encode(x_t, xl)
        mark()
        max_y = int(y_len.max())
        T_y = pick_bucket(max_y, Y_BUCKETS)
        out = model.decode(mu_x, w_ceil, xl, y_len, 10, 0.667, y_max_length=T_y,
                           generator=torch.Generator(dev).manual_seed(SEED))
        mark()
        T_voc = min(T_y, pick_bucket(min(max_y, T_y), VOC_BUCKETS))
        wav = generator_apply_fused(vocoder, out["mel"].transpose(1, 2)[:, :T_voc],
                                    pipe.vocoder_weights)[..., 0]
        mark()
        denoise(torch.clamp(wav, -1.0, 1.0), bias, strength=pipe.denoiser_strength)
        mark()
        if rep:  # the first pass is the warm-up
            for name, a, b in zip(("encode", "decode_10_steps", "vocoder", "denoise"),
                                  marks, marks[1:]):
                split.setdefault(name, []).append((b - a) * 1e3)
    emit({"phase": "breakdown", "sentence": 1, "T_y": T_y, "T_voc": T_voc,
          "ms": {k: statistics.median(v) for k, v in split.items()},
          "note": "host clock per stage, synchronised; median of 3 after 1 warm-up"})
    g = torch.Generator(dev).manual_seed(SEED + 1)
    emit({"phase": "device_busy", "sentence": 1, **device_busy(
        lambda: pipe.synthesise_batch(tp["x"], tp["x_lengths"], generator=g),
        lat["sentence_1"]["p50_ms"])})

    stages = []
    path_T_voc = requests[0]["T_voc"]
    for T_mel, label in ((path_T_voc, "main_path"), (512, "T_mel_512")):
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
                    b_ms, b_by = k1_bound_ms(1, C, T, ks, dils)
                    err = (mrf.fused_mrf_stage(xc, weights, ks, dils)
                           - mrf.fused_mrf_stage_reference(xc, weights, ks, dils)).abs().max().item()
                    if not err < K1_TOL:
                        raise AssertionError(f"K1 disagrees at C={C} T={T} ({label}): {err}")
                    stages.append({"shape": label, "T_mel": T_mel, "C": C, "T": T, "ms": k_ms,
                                   "plain_ms": p_ms, "library_ms": l_ms, "bound_ms": b_ms,
                                   "bound_by": b_by, "max_abs_err": err})
                    emit({"phase": "k1_time", **stages[-1]})
                x = vocoder.mrf_stage(i, x)
    torch.cuda.synchronize()

    # 6. kernels: ms, plain_ms, bound_ms, library_ms summed over the two
    # narrow stages of one vocoder call at the main path's shape
    path = [s for s in stages if s["shape"] == "main_path"]
    not_ported = {"route": None, "source": None, "launches": 0, "max_abs_err": None, "ms": None,
                  "plain_ms": None, "bound_ms": None, "bound_by": None, "library_ms": None}
    emit({"kernels": [
        {"name": "mrf_stage", "route": "cuda", "status": "ported",
         "source": "matcha_tpu_torch/csrc/mrf_stage.cu",
         "replaces": "matcha_tpu/ops/mrf_pallas.py:121",
         "launches": launches,
         "max_abs_err": max([worst] + [s["max_abs_err"] for s in stages]),
         "ms": sum(s["ms"] for s in path),
         "plain_ms": sum(s["plain_ms"] for s in path),
         "bound_ms": sum(s["bound_ms"] for s in path),
         "bound_by": ("operations" if all(s["bound_by"] == "operations" for s in path)
                      else "bytes"),
         "library_ms": sum(s["library_ms"] for s in path)},
        {"name": "maximum_path", "status": "not ported", "path": "training",
         "replaces": "matcha_tpu/ops/mas_pallas.py:69", **not_ported},
        {"name": "mrf_stage_phase", "status": "not ported", "path": "opt-in narrow_impl='phase'",
         "replaces": "matcha_tpu/ops/mrf_pallas.py:347", **not_ported},
    ]})
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
