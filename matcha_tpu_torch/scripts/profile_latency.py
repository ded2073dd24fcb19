"""The dynamic serving path's request latency at full width, split by stage.

LJSpeech MatchaTTS + HiFi-GAN v1 with weights from a seed, batch 1, f32
with TF32 off, the three sentences ``chip_smoke.py`` serves:
``TTSPipeline.synthesise_batch`` per sentence (``request_latency``), then
one request of the second sentence split by stage (``stage_split``:
encode, the 10 U-Net steps, vocoder, denoise). Host clock, synchronised,
median of ``--reps`` after one warm-up. ``chip_smoke.py`` calls the two
functions for its ``latency`` and ``breakdown`` lines.

Usage: python -m matcha_tpu_torch.scripts.profile_latency [--reps 20] [--label new]

One JSON line, with the package's path and the card's name and power
limit. The script uses only the dynamic path's interface, which has not
changed since it was ported, so it also times another checkout (an A/B in
one run: old, new, new, old) when run as a file with that checkout first
on the path:
    PYTHONPATH=<other checkout> python3 matcha_tpu_torch/scripts/profile_latency.py
"""

import argparse
import json
import statistics
import subprocess
import time

import numpy as np
import torch

SEED = 1234
SENTENCES = [  # chip_smoke.py serves these too
    "The birch canoe slid on the smooth planks.",
    "Printing, in the only sense with which we are at present concerned, differs from most "
    "if not from all the arts and crafts represented in the Exhibition.",
    "In 1834, Dr. Smith paid $3.50 for the 2nd edition; it was worth every cent.",
]
CLEANER = "english_cleaners_no_espeak"
STAGES = ("encode", "decode_10_steps", "vocoder", "denoise")


def request_latency(pipe, texts, reps: int) -> dict:
    """Per processed sentence i: ``pipe.synthesise_batch`` on the dynamic
    path, noise from a generator seeded ``SEED + i``; p50 (and min, max)
    ms of ``reps`` requests after one warm-up, seconds of audio, RTF."""
    dev, h = pipe.device, pipe.vocoder.h
    latency = {}
    for i, tp in enumerate(texts):
        g = torch.Generator(dev).manual_seed(SEED + i)
        runs = []
        for _ in range(reps + 1):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = pipe.synthesise_batch(tp["x"], tp["x_lengths"], generator=g)
            torch.cuda.synchronize()
            runs.append((time.perf_counter() - t0) * 1e3)
        audio_s = int(out["mel_lengths"][0]) * h.hop_size / h.sampling_rate
        p50 = statistics.median(runs[1:])
        latency[f"sentence_{i}"] = {"ids": int(tp["x_lengths"][0]), "p50_ms": p50,
                                    "min_ms": min(runs[1:]), "max_ms": max(runs[1:]),
                                    "audio_s": audio_s, "rtf": p50 / 1e3 / audio_s}
    return latency


def stage_split(pipe, tp, reps: int) -> dict:
    """One dynamic-path request of the processed sentence ``tp`` stage by
    stage, a synchronise after each: median ms of ``reps`` after one
    warm-up per stage, with the mel and vocoder buckets it ran at."""
    from matcha_tpu_torch.models.denoiser import denoise
    from matcha_tpu_torch.pipeline import X_BUCKETS, Y_BUCKETS, pad_ids, pick_bucket, voc_bucket

    dev = pipe.device
    x_pad, _ = pad_ids(tp["x"], pick_bucket(tp["x"].shape[-1], X_BUCKETS), dtype=np.int64)
    x_t, xl = torch.from_numpy(x_pad).to(dev), torch.from_numpy(tp["x_lengths"]).to(dev)
    split = {name: [] for name in STAGES}
    for rep in range(reps + 1):
        marks = [time.perf_counter()]

        def mark():
            torch.cuda.synchronize()
            marks.append(time.perf_counter())

        mu_x, w_ceil, y_len = pipe.model.encode(x_t, xl)
        mark()
        max_y = int(y_len.max())
        T_y = pick_bucket(max_y, Y_BUCKETS)
        out = pipe.model.decode(mu_x, w_ceil, xl, y_len, 10, 0.667, y_max_length=T_y,
                                generator=torch.Generator(dev).manual_seed(SEED))
        mark()
        T_voc = voc_bucket(max_y, T_y)
        wav = pipe._generate(out["mel"].transpose(1, 2)[:, :T_voc])[..., 0]
        mark()
        denoise(torch.clamp(wav, -1.0, 1.0), pipe.denoiser_bias, strength=pipe.denoiser_strength)
        mark()
        if rep:  # the first pass is the warm-up
            for name, a, b in zip(STAGES, marks, marks[1:]):
                split[name].append((b - a) * 1e3)
    return {"T_y": T_y, "T_voc": T_voc, "ms": {k: statistics.median(v) for k, v in split.items()}}


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--reps", type=int, default=20, help="timed requests after one warm-up")
    parser.add_argument("--label", default="", help="a tag copied into the output line")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_latency: needs a CUDA device")

    import matcha_tpu_torch
    from matcha_tpu_torch.cli import process_text
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
    texts = [process_text(i, s, CLEANER) for i, s in enumerate(SENTENCES)]
    latency = request_latency(pipe, texts, args.reps)
    split = stage_split(pipe, texts[1], args.reps)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(json.dumps({"label": args.label, "package": matcha_tpu_torch.__file__, "nvidia_smi": smi,
                      "latency": latency, "breakdown": {"sentence": 1, **split},
                      "note": f"host clock, synchronised; median of {args.reps} after 1 warm-up"}),
          flush=True)


if __name__ == "__main__":
    main()
