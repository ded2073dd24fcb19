#!/usr/bin/env python3
"""Drive the PyTorch port (``matcha_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one output line each (any failure exits non-zero):

1. the card (``nvidia-smi`` name and power limit) and the torch / CUDA /
   nvcc / Triton versions;
2. the build of the four CUDA sources in ``matcha_tpu_torch/csrc`` (one
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
   staged corpus synthesis (``staged_corpus``): bench.py's 128-utterance
   filelist through ``synthesise_corpus`` split, with the fused stage as
   one CUDA graph per bucket triple, and as ``synthesise_batch`` per batch,
   on the same noise (equal batches and lengths, fused and loop against
   split), audio seconds per wall second, one copy to the host per window
   and K1's launches from a ``torch.profiler`` trace, the graphs' capture
   seconds and memory; the chunked vocoder (256 frames) against the whole
   one at B = 8 x 1,024 (1e-5, peak memory, ms); K1 against its plain
   version at every (B, C, T) the corpus ran it at (``K1Shapes``); the
   serving daemon (``serve``) in process on 127.0.0.1, warmed at 384:768:
   lone requests replay a warmed graph and equal the eager body on their
   call's generator, 8 concurrent requests merge into at most 2 batches
   with the predicted frames, the long-form and streaming endpoints and
   /healthz answer, the card's busy time and idle share over one merged
   batch of 8, then 8 clients in a closed loop for 10 s
   (``scripts/bench_serve.py``: req/s, x realtime, latency percentiles,
   requests per batch, batch ms), and K1 against its plain version at
   every (B, C, T) the daemon ran it at after warmup and in its graphs;
   serving precision (``precision``): the fixed-bucket path at the
   integer bucket in five modes (full precision, torch's default cuDNN
   TF32, ``bf16_latency``, ``vocoder_bf16``, ``vocoder_pallas=False``),
   each mode's replay p50, busy ms, K1 per replay, its replay against its
   eager body, and its waveform's deviation from full precision's on the
   same noise, with equal mel lengths in every mode that keeps the
   encoder f32; the generator alone in five precisions (f32 and bf16,
   hybrid and all-cuDNN, and K1's bf16-product instance) at B = 1 x 256
   and B = 8 x 1,024; K1's bf16-product instance against its plain version
   at the narrow stages of both, timed beside the 3xTF32 instance and the
   bf16 cuDNN chain; the daemon with ``--bf16-vocoder`` and with
   ``--no-pallas-vocoder``, one request each; the CLI with its four flags
   on checkpoints written from the seed weights; K1 against its plain
   version at every (B, C, T, instance) the phase ran it at;
   the multi-speaker model (the VCTK Matcha: 109 speakers, spk_emb_dim
   64) at two speakers on the dynamic path, the fixed-bucket path (one
   capture per x bucket serving both speakers, each replay bit-equal to
   its eager body), ``--fused-stage`` over 32 of bench.py's utterances
   against the split stages, and the daemon with a default speaker, a
   request's own ``"spk"`` and an id out of range (400); the conformer
   decoder (every U-Net stage, GroupNorm and BatchNorm modes) at the
   fixed bucket (replay bit-equal to eager), and one decoder step at
   B = 1, T = 2,048 against the transformer decoder's peak memory; K1
   against its plain version at every shape these paths ran; after the
   data-parallel serving phase, the ``bigvgan`` line: BigVGAN-v2 at its
   published widths behind the LJSpeech Matcha (``bigvgan_phase``: the
   daemon's fast path and the corpus, split and ``--fused-stage``, with
   K4's 109 launches per vocoder call counted, and K4 against its plain
   version at every shape they ran);
6. the training path at full width (the LJSpeech config, batch 32, no
   segment cut) on a synthetic corpus written from the seed: 5 steps of
   ``python -m matcha_tpu_torch.train`` (through ``train.main``) with
   checkpoints, K2's launches counted against the MAS calls, then one
   step resumed from the ``last`` checkpoint; one ``losses`` + backward on
   the card and on the CPU, which must agree; step time, mel frames per
   second, peak memory, one step split by phase, the card's busy time
   over a step, and K2 at the step's shape beside its bound and its plain
   version, its call split under ``torch.profiler`` into the kernel and
   the wrapper's other device operations; ``train_bf16``: 3 steps of
   ``trainer.precision=bf16-mixed``, the f32 and bf16 losses on one batch
   and noise (within 2 %), K2 on the bf16 step's log-prior (EQUAL to its
   plain version, its ties counted), preloaded step times in turns and
   peak memory; ``multispeaker``: the serving checks above and 3 steps of
   ``experiment=multispeaker`` in f32 and in bf16 on a ``path|spk|text``
   corpus; ``conformer``: the serving checks above and one step at batch
   32 in each norm mode; ``train_extras``: 4 steps at batch 16 through
   ``train.main`` with the native mel frontend, ``trainer.profiler=jax``
   and tensorboard + CSV loggers (the trace's kernel events, the image
   tags written after the validation, K2's launches against the MAS
   calls), the native mel against numpy's over the corpus (5e-4, ms per
   clip), one forward + backward with ``remat`` on and off (gradients
   within 1e-6, peak memory), then 8 alternating pairs of them timed
   (median, min, max); ``vocoder_train``: ``python -m
   matcha_tpu_torch.training.vocoder_train`` (through its ``main``) at
   the v1 width with the MPD and MSD, batch 16 x 8,192 samples, for 2
   epochs of the corpus and one more resumed from ``last`` (losses finite,
   scale 0's u moved, the rate's staircase, the restored state equal to
   the saved one, K1 never launched; step ms, peak memory, the step's
   FLOPs and their share of the f32 peak), and one step of the tiny
   vocoder on the card against the CPU;
   ``deploy_eval`` (LJSpeech Matcha + HiFi-GAN v1 from the seed): the CLI
   through the model registry (``--model``/``--vocoder`` under a temporary
   ``$MATCHA_HOME``; .wav, .npy and .png per sentence; K1 2 launches for
   the denoiser's bias and 2 per sentence), on the training run's native
   checkpoint and on the same weights as a ``.ckpt`` (equal mel lengths);
   ``deploy/export.py`` at B = 1 x 256 x 1,024, 5 steps, with and without
   the vocoder (export seconds, MB, the reloaded artifact against its
   eager wrapper on one z within 1e-5, their times in turns);
   ``deploy/infer.py`` on 6 lines through B = 4 artifacts in its three
   output modes (RTF per batch); ``eval.main`` on the training run's
   checkpoint (K2 once per validation batch, EQUAL to its plain version
   on that batch's log-prior; finite losses and MCD); the app's
   ``load_model`` + ``synthesise_mel`` (K1 2 launches a request) and its
   ``main()`` without gradio; the sweep's ``run_sweep`` with its training
   objective (2 trials of 2 steps at batch 8); K1 against its plain
   version at every shape these ran;
   ``data_parallel``: serving replicas ``TTSPipeline(devices=[cuda:0,
   cuda:0])`` against one device on the same seed (B = 8 on the dynamic
   path and at mel bucket 576, one graph per replica; ``--fused-stage``
   over 16 of bench.py's utterances; lengths equal, the largest
   differences, bit-equality; K1 twice per replica chunk; p50 in turns,
   an overhead figure), the daemon as ``--data-parallel`` builds it on
   one card and over the two replicas (4 concurrent requests each);
   training through ``DistributedDataParallel``: NCCL at world size 1
   against the plain step (3 steps at batch 32), and two gloo ranks
   sharing cuda:0 (spawned) against the one-process step on the same 32
   rows, a 2-step fit with a validation, one checkpoint and a resume,
   every training process spawned in deterministic mode (the world-1
   step and the resume bit-equal); K2 per step and rank;
   ``tensor_parallel``: the LJSpeech config at batch 32 split over gloo
   ranks sharing cuda:0 (spawned, deterministic mode): ``n_model = 2``
   for 3 steps, a 2-step ``Trainer(n_model_axis=2)`` fit with a
   validation, one full-width checkpoint that the CLI loads and a resume
   bit-equal to the uninterrupted run; ``n_model = 4`` (half a head per
   rank) for one step; each against the plain one-process steps on the
   same batches and noise (losses, gathered gradients, the ranks'
   replicated tensors bit-equal), the plain steps run twice for their
   spread; K2 once per step and validation batch on every rank; step ms
   beside the card's name and power limit;
7. the ``kernels`` line (every TPU kernel of the repo: K1 in its two
   instances, K2 and K3, all ported; K1 with its launches on each path),
   then the last line ``{"ok": true, "device": {...}}``.

All f32 with TF32 off, so that every comparison is against full f32, but
where the precision phase sets a mode of its own.
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
import weakref

SEED = 1234
# the three serving sentences are SENTENCES of matcha_tpu_torch/scripts/profile_latency.py
SHORT_SENTENCE = "Hello world."
CLEANER = "english_cleaners_no_espeak"
# H100 SXM published peaks (NVIDIA data sheet): f32 outside the tensor cores,
# TF32 on the tensor cores (dense), HBM3
PEAK_F32_FLOPS = 67e12
PEAK_TF32_FLOPS = 495e12
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES_PER_S = 3.35e12
# 3xTF32 products summed in f32 over up to 1,408 terms per conv, in another
# order than cuDNN's
K1_TOL = 1e-4
# K1's bf16-product instance against its plain version (both round every
# conv's operands to bf16 and sum in f32), as fractions of the bf16
# rounding's own effect on the same input (the plain bf16 version against
# the plain f32 one): sums in another order move a few operands of the
# next conv across a bf16 rounding boundary, and the tensor cores' bf16
# sums are less exact than f32's (cuBLAS bf16 -> f32 measured 4x f32's
# error on an H100), so the flips, rare and each worth about one bf16 step
# of an operand, grow with the element count and the weights' scale
# (measured: max 0.18-0.40 and mean 0.01-0.09 of the effect)
K1_BF16_TOL = {"max_of_effect": 1.0, "mean_of_effect": 0.2}
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
# staged corpus synthesis, bench.py's protocol: utterances, batch, length scale
CORPUS_UTTS, CORPUS_BATCH, CORPUS_RATE = 128, 8, 3.5
# the chunked vocoder against the whole: JAX's bound (tests/test_cli_e2e.py),
# as numpy's allclose reads rtol and atol
CHUNK_FRAMES, CHUNK_TOL = 256, 1e-5
# the daemon: the warmed pair (the three serving sentences route to x bucket
# 384), lone requests per sentence, and the closed loop's clients and seconds
SERVE_WARMUP, SERVE_REPS, SERVE_CLIENTS, SERVE_SECONDS = "384:768", 5, 8, 10.0
# BigVGAN-v2 at its published widths behind the LJSpeech Matcha: K4 (the
# anti-aliased SnakeBeta) against its plain version, as a share of the plain
# output's largest magnitude (tests/test_torch_kernels_cuda.py::K4_TOL), its
# launches per vocoder call, and the daemon's warmed pair
K4_TOL, K4_PER_CALL, BIGVGAN_WARMUP = 1e-4, 109, "128:512"
N_TRAIN, N_VAL = 64, 8
# serving precision: the fixed-bucket path's modes, each (TTSPipeline
# options, cuDNN TF32 on, K1 launches per stage pass of the 3xTF32 and the
# bf16-product instance, bound on the wav's mean deviation from
# full_precision: JAX's for its bf16 modes, tests/test_cli_e2e.py; the f32
# vocoder variants' VARIANT_TOL without the fused kernel); every mode but
# tf32_default turns TF32 off
PRECISION_MODES = {
    "full_precision": ({}, False, 2, 0, 0.0),
    "tf32_default": ({}, True, 2, 0, 0.02),
    "bf16_latency": ({"bf16_latency": True}, False, 2, 0, 0.03),
    "vocoder_bf16": ({"vocoder_bf16": True}, False, 2, 0, 0.02),
    "no_pallas_vocoder": ({"vocoder_pallas": False}, False, 0, 0, VARIANT_TOL),
}
PRECISION_REPS = 10
# the CLI's precision flags, each set run once on the card
PRECISION_CLI = {
    "bf16_latency": ["--fixed-y-bucket", "128", "--bf16-latency", "--full-precision"],
    "bf16_vocoder_no_pallas": ["--bf16-vocoder", "--no-pallas-vocoder"],
}
# the generator alone: (bf16 generator, fused cap, K1's compute_dtype, K1
# launches per call of the 3xTF32 and the bf16-product instance)
VOCODER_PRECISIONS = {
    "f32_hybrid": (False, 64, "float32", 2, 0),
    "bf16_hybrid": (True, 64, "float32", 2, 0),
    "bf16_cudnn": (True, 0, "float32", 0, 0),
    "f32_cudnn": (False, 0, "float32", 0, 0),
    "f32_hybrid_bf16_products": (False, 64, "bfloat16", 0, 2),
}
TRAIN_STEPS = 5
# the VCTK Matcha (configs/data/vctk.yaml, configs/experiment/multispeaker.yaml:
# 109 speakers, spk_emb_dim 64 from configs/model/matcha.yaml, VCTK's mel
# statistics); the two speakers it serves, the fixed bucket (the serving
# sentences' at LJSpeech widths), the corpus cut of bench.py's utterances,
# the daemon's warmed pair, timed repetitions; training steps of each new
# configuration; the conformer decoder's two norm modes
VCTK = {"n_spks": 109, "spk_emb_dim": 64, "mel_mean": -6.630575, "mel_std": 2.482914}
MS_SPEAKERS, MS_BUCKET, MS_CORPUS_UTTS, MS_WARMUP, MS_REPS = (7, 100), 576, 32, (128, 256), 10
EXTRA_STEPS = 3
CONFORMER_MODES = {"groupnorm": False, "batchnorm": True}
# data parallelism on the one card: the serving replicas' batch of bench.py's
# utterances, fixed mel bucket, corpus cut, timed reps and daemon requests;
# their bound against one device on mel and waveform (a part runs cuDNN at
# half the rows, which may pick other algorithms); the training steps at
# NCCL world 1, the gloo ranks sharing cuda:0, their bounds against one
# process (losses and gradient norm relative; each gradient tensor's
# largest difference over its largest value: the two halves' sums in
# another order; measured 8.7e-8 and 4.0e-6-4.2e-6 on an H100, so 1e-6 and
# 1e-4, down from 1e-4 and 1e-3) and the spawn's time limit; in
# deterministic mode the world-1 steps and the resume are held bit-equal
DP_BATCH, DP_BUCKET, DP_CORPUS_UTTS, DP_REPS, DP_REQUESTS = 8, 576, 16, 5, 4
DP_TOL = 1e-4
DP_STEPS, DP_RANKS, DP_RTOL, DP_GRAD_TOL, DP_TIMEOUT_S = 3, 2, 1e-6, 1e-4, 600
# the training comparisons of data_parallel and tensor_parallel run in
# spawned processes in this mode, its cuBLAS setting in their environment
# before CUDA starts (``launch_deterministic``, ``deterministic``)
DETERMINISTIC_ENV = {"CUBLAS_WORKSPACE_CONFIG": ":4096:8"}
# tensor parallelism on the one card: the n_model = 2 job's steps, the
# bounds against the plain one-process steps (the CPU tests' own: losses
# and gradient norm relative; each gathered gradient tensor's largest
# difference within TP_GRAD_OF_MAX of its largest value plus TP_GRAD_ATOL),
# loosened only to the measured spread of two plain runs (in deterministic
# and in default mode, and with cuDNN's convolutions against torch's own:
# on an H100 that last spread is 1.27e-4 of the largest, in the same
# tensor as the split step's largest difference: the 5th encoder FFN's
# conv_1 weight), and the spawn's time limit
TP_STEPS, TP_RTOL, TP_GRAD_OF_MAX, TP_GRAD_ATOL, TP_TIMEOUT_S = 3, 1e-5, 1e-4, 1e-7, 600
DETERMINISTIC_MODE = ("torch.use_deterministic_algorithms(True), "
                      "torch.backends.cudnn.deterministic = True, CUBLAS_WORKSPACE_CONFIG=:4096:8, "
                      "TF32 off")
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


def deterministic() -> None:
    """A spawned comparison's mode (DETERMINISTIC_MODE); its cuBLAS
    workspace setting comes from the environment it was spawned with."""
    import torch

    torch.use_deterministic_algorithms(True)
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False


def launch_deterministic(fn, args: tuple, nprocs: int, backend: str, workdir: str,
                         timeout_s: float) -> None:
    """``dist.launch_local`` with DETERMINISTIC_ENV in the ranks'
    environment (a spawned process copies it when it starts, before CUDA
    does); ``fn`` calls ``deterministic`` first."""
    from matcha_tpu_torch.parallel import dist

    saved = {k: os.environ.get(k) for k in DETERMINISTIC_ENV}
    os.environ.update(DETERMINISTIC_ENV)
    try:
        dist.launch_local(fn, args, nprocs, backend, workdir, timeout_s=timeout_s)
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


#: seconds of each graph's warm-up and capture (its first call), by graph
CAPTURE_S = weakref.WeakKeyDictionary()


def time_captures() -> None:
    """Time every graph's warm-up and capture (``CapturedBody._capture``)
    into ``CAPTURE_S``, with the program's tracing left off, so that every
    phase runs as a user runs it."""
    from matcha_tpu_torch.fused import CapturedBody
    capture = CapturedBody._capture

    def timed(self):
        t0 = time.perf_counter()
        capture(self)
        CAPTURE_S[self] = time.perf_counter() - t0

    CapturedBody._capture = timed


def capture_seconds(graph):
    """Seconds of ``graph``'s warm-up and capture (``time_captures``)."""
    return CAPTURE_S.get(graph, "not measured")


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


def k1_bound_ms(B: int, C: int, T: int, kernel_sizes, dilations,
                peak: float = PEAK_F32_FLOPS) -> dict:
    """Least time for one stage: the larger of its conv FLOPs over ``peak``
    (the f32 one, or the bf16 tensor cores' for the bf16-product instance)
    and its bytes (x read, y written, f32 weights read once) over HBM
    (``bound_ms``); and with the products as the 3xTF32 instance takes
    them, 3 TF32 products per f32 product over the TF32 tensor-core peak
    (``bound_tc_ms``, bytes alike)."""
    taps = 2 * sum(k * len(d) for k, d in zip(kernel_sizes, dilations))
    flops = 2.0 * B * T * C * C * taps
    weight_floats = sum(2 * len(d) * (k * C * C + C) for k, d in zip(kernel_sizes, dilations))
    t_bytes = 4.0 * (2 * B * C * T + weight_floats) / PEAK_BYTES_PER_S
    t_ops, t_tc = flops / peak, 3 * flops / PEAK_TF32_FLOPS
    return {"bound_ms": 1e3 * max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "bound_tc_ms": 1e3 * max(t_tc, t_bytes)}


def within_k1_tol(row: dict, compute_dtype) -> bool:
    """Whether a K1 check's errors are within its instance's tolerance
    (the bf16 instance's against the row's ``bf16_effect_max`` /
    ``_mean``)."""
    import torch

    if compute_dtype == torch.bfloat16:
        return (row["max_abs_err"] < K1_BF16_TOL["max_of_effect"] * row["bf16_effect_max"]
                and row["mean_abs_err"] < K1_BF16_TOL["mean_of_effect"] * row["bf16_effect_mean"])
    return row["max_abs_err"] < K1_TOL


def k1_errors(got, want, f32=None) -> dict:
    """max and mean |got - want|, and with ``f32`` (the plain f32 stage)
    the bf16 rounding's own effect, max and mean |want - f32|."""
    err = (got - want).abs()
    row = {"max_abs_err": err.max().item(), "mean_abs_err": err.mean().item()}
    if f32 is not None:
        effect = (want - f32).abs()
        row.update(bf16_effect_max=effect.max().item(), bf16_effect_mean=effect.mean().item())
    return row


def device_busy(request, latency_ms: float) -> dict:
    """One ``request()`` under ``torch.profiler``: the time the card spent
    in kernels and copies (union of their intervals), the number of them,
    the names that took the most, and the idle share against the request's
    unprofiled ``latency_ms``. "not measured" when the trace holds no
    device events."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from matcha_tpu_torch.scripts.trace_settle import TRACE_SETTLE_S

    request()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        request()
        torch.cuda.synchronize()
        profiled_ms = (time.perf_counter() - t0) * 1e3
        time.sleep(TRACE_SETTLE_S)
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
    """K2 against its plain version on the card and against the host
    search (``maximum_path_numpy``, ``native/mas/mas.cpp`` through g++):
    the paths must be EQUAL."""
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
        # the host search (the reference's C++) holds only where every row
        # has a path, 1 <= t_x <= t_y: it leaves the cells outside the band
        # unscored where the kernel (as JAX's scan and Pallas paths) scores
        # them -1e9, and with t_x = 0 it writes before its row
        feasible = all(1 <= a <= b for a, b in zip(t_xs, t_ys))
        equal_host = None
        if feasible:
            host = mas.maximum_path_numpy(value.cpu().numpy(), mask.cpu().numpy())
            equal_host = torch.equal(got.float().cpu(), torch.from_numpy(host))
        layout = mas.mas_layout(T_x, T_y)
        cpl, _, rows, smem = layout
        equal = torch.equal(got, want) and got.dtype == mask.dtype
        out.append({"B": B, "T_x": T_x, "T_y": T_y, "values": values,
                    "mask": "bool" if bool_mask else "float32", "equal": equal,
                    "equal_host": equal_host,
                    "cells_on_path": int(got.sum()), "layout": layout,
                    "kernel_smem_bytes": lib.mas_smem_bytes(cpl, rows)})
        if not equal:
            raise AssertionError(f"K2 differs from its plain version: {out[-1]}")
        if equal_host is False:
            raise AssertionError(f"K2 differs from the host search: {out[-1]}")
        if out[-1]["kernel_smem_bytes"] != smem:
            raise AssertionError(f"K2's shared memory differs from mas_layout's: {out[-1]}")
    return out


def write_corpus(root: str, seed: int = SEED, speakers: int = 0) -> dict:
    """A synthetic corpus at LJSpeech's clip lengths: 64 train and 8 val
    22,050 Hz wavs of 1.5-10 s (tones, vibrato and noise), each with a run
    of real words long enough for about 3 mel frames per id (blanks
    included), as in LJSpeech. With ``speakers`` the filelists are
    ``path|spk|text``, clip i spoken by speaker 37 i mod ``speakers``.
    Returns the filelist paths (and the speaker ids used)."""
    import numpy as np

    from matcha_tpu_torch.utils.utils import write_wav

    os.makedirs(root, exist_ok=True)
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
        spk = f"{37 * i % speakers}|" if speakers else ""
        lines.append(f"{path}|{spk}{' '.join(text)}")
    paths = {"train": os.path.join(root, "train.txt"), "val": os.path.join(root, "val.txt")}
    if speakers:
        paths["speakers"] = sorted({37 * i % speakers for i in range(N_TRAIN + N_VAL)})
    for name, part in (("train", lines[:N_TRAIN]), ("val", lines[N_TRAIN:])):
        with open(paths[name], "w", encoding="utf-8") as f:
            f.write("\n".join(part) + "\n")
    return paths


def train_overrides(corpus: dict, out_dir: str, experiment: str = "ljspeech") -> list:
    """A full-width training config (``experiment``: ljspeech, or
    multispeaker, the VCTK one; batch 32, out_size null) on the synthetic
    corpus: cleaners without espeak, CSV metrics every step, checkpoints
    on."""
    return [f"experiment={experiment}", f"data.train_filelist_path={corpus['train']}",
            f"data.valid_filelist_path={corpus['val']}", f"data.cleaners=[{CLEANER}]",
            "data.frontend=numpy", "logger=csv", "trainer.log_every_n_steps=1",
            f"paths.output_dir={out_dir}"]


def read_metrics(out_dir: str) -> list:
    with open(os.path.join(out_dir, "csv", "metrics.csv"), encoding="utf-8") as f:
        return [{k: float(v) for k, v in row.items() if v} for row in csv.DictReader(f)]


class CountMas:
    """While active, counts the MAS calls of ``MatchaTTS.losses`` and K2's
    launches from 0, and keeps the first call's log-prior and mask."""

    def __enter__(self):
        from matcha_tpu_torch.models import matcha as matcha_module
        from matcha_tpu_torch.ops import mas

        self.calls, self.first = 0, None
        self._search = search = matcha_module.maximum_path

        def counted(value, mask):
            self.calls += 1
            if self.first is None:
                self.first = (value.detach().clone(), mask.detach().clone())
            return search(value, mask)

        matcha_module.maximum_path = counted
        mas.LAUNCHES["maximum_path"] = 0
        return self

    def __exit__(self, *exc):
        from matcha_tpu_torch.models import matcha as matcha_module
        from matcha_tpu_torch.ops import mas

        matcha_module.maximum_path = self._search
        self.launches = mas.LAUNCHES["maximum_path"]


def run_train(argv) -> dict:
    """``train.main(argv)`` with K2's launches and the MAS calls counted
    from 0 over it."""
    from matcha_tpu_torch import train

    t0 = time.perf_counter()
    with CountMas() as counted:
        train.main(argv)
    return {"seconds": time.perf_counter() - t0, "mas_calls": counted.calls,
            "k2_launches": counted.launches}


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


class K1Shapes:
    """While active, records every (B, C, T, t_tile, compute_dtype) at which
    the vocoder calls K1's wrapper, eagerly or under a graph capture, with
    the stage's weights and the tags it ran under (``tag``, and "graph" when
    captured), so that ``check`` holds K1 against its plain version at
    exactly the shapes and in the instance a path ran (``pick_t_tile`` picks
    its tile from B, C and T)."""

    def __init__(self):
        self.seen, self.tag = {}, None

    def __enter__(self):
        import torch

        from matcha_tpu_torch.models import hifigan_fused

        self._orig = launch = hifigan_fused.fused_mrf_stage

        def recording(x, weights, kernel_sizes, dilations, t_tile=None,
                      compute_dtype=torch.float32):
            key = (*x.shape, t_tile, compute_dtype)
            entry = self.seen.setdefault(key, {"args": (weights, kernel_sizes, dilations),
                                               "tags": set()})
            capturing = x.is_cuda and torch.cuda.is_current_stream_capturing()
            entry["tags"].add("graph" if capturing else self.tag)
            return launch(x, weights, kernel_sizes, dilations, t_tile=t_tile,
                          compute_dtype=compute_dtype)

        hifigan_fused.fused_mrf_stage = recording
        return self

    def __exit__(self, *exc):
        from matcha_tpu_torch.models import hifigan_fused

        hifigan_fused.fused_mrf_stage = self._orig

    def check(self, dev, gen, tags) -> list:
        """K1 against its plain version on random input at each recorded
        shape that ran under one of ``tags``, in the instance it ran; raises
        past K1_TOL (K1_BF16_TOL for the bf16-product instance)."""
        import torch

        from matcha_tpu_torch.ops import mrf

        rows = []
        for (B, C, T, t_tile, cd), entry in sorted(self.seen.items(),
                                                   key=lambda kv: (*kv[0][:3], str(kv[0][4]))):
            if not entry["tags"] & set(tags):
                continue
            x = torch.randn(B, C, T, generator=gen).to(dev)
            with torch.inference_mode():
                got = mrf.fused_mrf_stage(x, *entry["args"], t_tile=t_tile, compute_dtype=cd)
                want = mrf.fused_mrf_stage_reference(x, *entry["args"], compute_dtype=cd)
                f32 = (None if cd == torch.float32
                       else mrf.fused_mrf_stage_reference(x, *entry["args"]))
            rows.append({"B": B, "C": C, "T": T, "t_tile": mrf.pick_t_tile(C, T, t_tile, B=B),
                         "compute_dtype": str(cd).split(".")[-1], "ran_in": sorted(entry["tags"]),
                         **k1_errors(got, want, f32)})
            del x, got, want, f32
            if not within_k1_tol(rows[-1], cd):
                raise AssertionError(f"K1 disagrees with its plain version at {rows[-1]}")
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

    from matcha_tpu_torch.pipeline import TTSPipeline
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
    captures = [{"T_x": fg.x.shape[1], "T_y": fg.T_y, "seconds": capture_seconds(fg),
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


def device_counts(prof) -> dict:
    """K1's launches (device events by kernel name), device-to-host copies
    and host waits (``cudaStreamSynchronize`` / ``cudaDeviceSynchronize``)
    in a ``torch.profiler`` trace."""
    names = [e.name for e in prof.events()]
    return {"k1": sum("mrf_stage_kernel" in n for n in names),
            "dtoh": sum(n.startswith("Memcpy DtoH") for n in names),
            "syncs": sum(n in ("cudaStreamSynchronize", "cudaDeviceSynchronize") for n in names)}


def corpus_run(pipe, dev, utts, mode: str, profile: bool = False):
    """One pass over the corpus: ``split`` or ``fused`` through
    ``synthesise_corpus``, ``loop`` as ``synthesise_batch`` per batch on
    the same sorted batches; one generator seeded from SEED, so every mode
    draws the same noise. Returns (batches, wall seconds, counts): K1's
    wrapper launches, the stage graphs' replays and, with ``profile``, the
    trace's ``device_counts`` and ``graph_launch_counts``. Nothing is
    fetched inside the pass but the path's own copies."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile as trace

    from matcha_tpu_torch.ops import mrf
    from matcha_tpu_torch.scripts.trace_settle import TRACE_SETTLE_S, graph_launch_counts

    gen = torch.Generator(dev).manual_seed(SEED)
    kw = dict(n_timesteps=10, temperature=0.667, length_scale=CORPUS_RATE)

    def run():
        if mode != "loop":
            return list(pipe.synthesise_corpus(utts, batch_size=CORPUS_BATCH,
                                               fuse_stages=mode == "fused", generator=gen, **kw))
        order = sorted(range(len(utts)), key=lambda i: len(utts[i]))
        outs = []
        for s in range(0, len(order), CORPUS_BATCH):
            chunk = order[s:s + CORPUS_BATCH]
            x = np.zeros((len(chunk), max(len(utts[i]) for i in chunk)), np.int32)
            for row, idx in enumerate(chunk):
                x[row, :len(utts[idx])] = utts[idx]
            xl = np.asarray([len(utts[i]) for i in chunk], np.int32)
            outs.append((chunk, pipe.synthesise_batch(x, xl, generator=gen, **kw)))
        return outs

    def replays():
        return sum(g.replays for k, g in pipe._graphs.items() if k[0] == "stage")

    torch.cuda.synchronize()
    mrf.LAUNCHES["mrf_stage"] = 0
    replays0 = replays()
    t0 = time.perf_counter()
    if profile:
        with trace(activities=[ProfilerActivity.CUDA]) as prof:
            outs = run()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            time.sleep(TRACE_SETTLE_S)
        counts = {**device_counts(prof), **graph_launch_counts(prof)}
    else:
        outs = run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = {}
    counts.update(k1_wrapper=mrf.LAUNCHES["mrf_stage"], replays=replays() - replays0)
    for _, out in outs:
        out.setdefault("mel_lengths_host", out["mel_lengths"].cpu().numpy())
    return outs, wall, counts


def staged_corpus(dev, model, vocoder, bias) -> dict:
    """``bench.py``'s protocol through the port's ``synthesise_corpus``: 128
    utterances of 64-192 ids, length scale 3.5, B = 8, 10 steps,
    temperature 0.667. Three modes in turns on the same noise: the split
    stages (the flow one CUDA graph per (B, T_y)), the fused stage (one
    CUDA graph per bucket triple; both captured in first untimed passes), and ``synthesise_batch`` per batch; then the two
    staged modes again under ``torch.profiler``. Checks: the same batches
    and host lengths in every mode; fused against split (mel 1e-6,
    waveform GRAPH_TOL) and the loop against split alike; one copy to the
    host per window in the staged modes; K1 twice per batch (split: in
    the trace; loop: its wrapper's count; fused: one replay per batch and
    K1 twice in each replay's trace events). Then the chunked vocoder
    (``vocoder_chunk`` CHUNK_FRAMES against 0, no denoiser) at B = 8 x
    1,024 frames. Last, K1 against its plain version at every (B, C, T)
    that any of these runs gave it."""
    import numpy as np
    import torch

    from matcha_tpu_torch.pipeline import TTSPipeline
    from matcha_tpu_torch.ops import mrf
    from matcha_tpu_torch.scripts.trace_settle import corpus_utterances

    pipe = TTSPipeline(model, vocoder, bias, cleaner=CLEANER, device=dev)
    utts = corpus_utterances(CORPUS_UTTS, SEED)
    modes = ("split", "fused", "loop")
    mel = torch.randn(*PROFILER_SHAPE, model.n_feats, generator=torch.Generator().manual_seed(SEED))
    mel = mel.to(dev)
    chunk = {}
    with K1Shapes() as shapes:
        shapes.tag = "corpus"
        corpus_run(pipe, dev, utts, "split")  # captures every (B, T_y) decode graph
        first_s = corpus_run(pipe, dev, utts, "fused")[1]  # captures every triple's graph
        checked = {m: corpus_run(pipe, dev, utts, m) for m in modes}
        traced = {m: corpus_run(pipe, dev, utts, m, profile=True) for m in ("split", "fused")}
        shapes.tag = "chunk"
        for frames in (0, CHUNK_FRAMES):
            p = TTSPipeline(model, vocoder, None, cleaner=CLEANER, device=dev, vocoder_chunk=frames)
            with torch.inference_mode():
                p.vocode(mel)
                torch.cuda.synchronize()
                base = torch.cuda.memory_allocated(dev)
                torch.cuda.reset_peak_memory_stats(dev)
                mrf.LAUNCHES["mrf_stage"] = 0
                wav = p.vocode(mel)
                torch.cuda.synchronize()
                chunk[frames] = {"peak_MiB": (torch.cuda.max_memory_allocated(dev) - base) / 2**20,
                                 "k1_wrapper_launches": mrf.LAUNCHES["mrf_stage"],
                                 "ms": cuda_ms(lambda p=p: p.vocode(mel), 3), "wav": wav}
    captured = [{"B": g.mu_x.shape[0], "T_x": g.mu_x.shape[1], "T_y": g.T_y, "T_voc": g.T_voc,
                 "seconds": capture_seconds(g),
                 "memory_allocated_before_after_MiB": [v / 2**20 for v in g.memory_allocated]}
                for k, g in pipe._graphs.items() if k[0] == "stage" and g.graph is not None]

    split = checked["split"][0]
    n_batches = len(split)
    audio_s = sum(int(o["mel_lengths_host"].sum()) for _, o in split) * HOP / SR
    errs = {}
    for m in ("fused", "loop"):
        outs = checked[m][0]
        if [c for c, _ in outs] != [c for c, _ in split]:
            raise AssertionError(f"staged corpus: {m} ran other batches than split")
        e = {"mel": 0.0, "waveform": 0.0}
        for (_, a), (_, b) in zip(split, outs):
            if not np.array_equal(a["mel_lengths_host"], b["mel_lengths_host"]):
                raise AssertionError(f"staged corpus: {m} lengths differ from split")
            for key in e:
                if a[key].shape != b[key].shape:
                    raise AssertionError(f"staged corpus: {m} {key} {tuple(b[key].shape)}")
                e[key] = max(e[key], (a[key] - b[key]).abs().max().item())
        errs[m] = e
        if not (e["mel"] <= 1e-6 and e["waveform"] <= GRAPH_TOL):
            raise AssertionError(f"staged corpus: {m} against split {e}")
    counts = {m: {**checked[m][2], **(traced[m][2] if m in traced else {})} for m in modes}
    c = counts["split"], counts["fused"], counts["loop"]
    if not (c[0]["dtoh"] == c[1]["dtoh"] == 1 and c[0]["k1"] == 2 * n_batches
            and c[1]["replays"] == c[1]["graph_launches"] == n_batches
            and c[1]["k1"] == 2 * n_batches and c[1]["k1_per_launch"] == [2] * n_batches
            and c[2]["k1_wrapper"] == 2 * n_batches):
        raise AssertionError(f"staged corpus: {counts} for {n_batches} batches in one window")
    if not all(bool(torch.isfinite(o["waveform"]).all()) for _, o in split):
        raise AssertionError("staged corpus: non-finite waveform")
    a, b = chunk[0].pop("wav"), chunk[CHUNK_FRAMES].pop("wav")
    chunk_err = (a - b).abs().max().item()
    if not (a.shape == b.shape and bool(((a - b).abs() <= CHUNK_TOL + CHUNK_TOL * b.abs()).all())):
        raise AssertionError(f"chunked vocoder against whole: {chunk_err}")
    walls = {m: checked[m][1] for m in modes}
    traced_walls = {m: traced[m][1] for m in traced}
    t_ys = sorted({o["mel"].shape[-1] for _, o in split})
    del checked, traced, split, a, b
    torch.cuda.empty_cache()
    k1_rows = shapes.check(dev, torch.Generator().manual_seed(SEED), ("corpus", "chunk"))

    runs = {}
    for m in modes:
        runs[m] = {"wall_s": walls[m], "audio_s_per_wall_s": audio_s / walls[m], **counts[m],
                   "k1_launches": counts[m].get("k1", counts[m]["k1_wrapper"])}
        if m in traced_walls:
            runs[m].update(profiled_wall_s=traced_walls[m],
                           host_copies_per_window=counts[m]["dtoh"])
    runs["fused"]["first_pass_wall_s"] = first_s
    return {"utterances": CORPUS_UTTS, "batch": CORPUS_BATCH, "batches": n_batches,
            "windows": 1, "length_scale": CORPUS_RATE, "steps": 10, "temperature": 0.667,
            "audio_s": audio_s, "T_y": t_ys, "modes": runs, "max_abs_err_vs_split": errs,
            "graphs": captured,
            "chunk": {"frames": CHUNK_FRAMES, "shape": list(PROFILER_SHAPE), "tolerance":
                      CHUNK_TOL, "max_abs_err": chunk_err, "by_chunk": chunk},
            "k1_shapes": k1_rows,
            "note": "wall: host clock from the call to the last batch, synchronised, after "
                    "the fused mode's capturing pass (first_pass_wall_s); audio: true frames x "
                    "hop / sr; k1 (trace: device events by name), dtoh (Memcpy DtoH events) "
                    "and syncs (cudaStreamSynchronize calls) from a second, profiled pass of "
                    "the staged modes (device activity only); graph_launches, "
                    "device_events_per_launch and k1_per_launch: the trace's events per "
                    "cudaGraphLaunch by correlation id; k1_wrapper: eager launches in the "
                    "timed pass; chunk: pipeline.vocode without the denoiser, CUDA events, "
                    "peak over the allocation before the call; k1_shapes: K1 against its "
                    "plain version on random input at every (B, C, T) the runs gave it"}


def _wav_samples(body: bytes):
    """A 24-bit mono WAV's samples as floats, and its header fields."""
    import io
    import wave

    import numpy as np

    with wave.open(io.BytesIO(body)) as f:
        fields = (f.getnchannels(), f.getsampwidth(), f.getframerate())
        raw = np.frombuffer(f.readframes(f.getnframes()), np.uint8).reshape(-1, 3).astype(np.int32)
    v = raw[:, 0] | (raw[:, 1] << 8) | (raw[:, 2] << 16)
    return ((v ^ 0x800000) - 0x800000) / float(2**23 - 1), fields


def serve_phase(dev, model, vocoder, bias) -> dict:
    """The daemon in process on 127.0.0.1: ``max_batch`` 8, warmed at
    SERVE_WARMUP (the dynamic shapes and the fast path's graphs). Lone
    /synthesise requests of the three serving sentences must replay a
    warmed graph and equal ``synthesise_batch`` at that bucket run
    eagerly on the call's generator (GRAPH_TOL plus one 24-bit step); 8
    concurrent requests merge into at most 2 batches with the frames
    ``encode`` predicts, and K1 runs twice per replay and per batch in the
    trace; /synthesise_long, /synthesise_stream and /healthz answer
    well-formed; one merged batch of 8 on an idle server, timed inside the
    batcher and then traced (the card's busy time and idle share); a
    closed loop of SERVE_CLIENTS client threads for SERVE_SECONDS
    (``scripts/bench_serve.py``) with each batch's time inside the
    batcher. Any failed request fails the phase. Last, K1 against its
    plain version at every (B, C, T) the daemon gave it after warmup or in
    a graph warmup captured."""
    import http.client
    import json as _json
    import threading
    import urllib.request

    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile as trace

    from matcha_tpu_torch.pipeline import TTSPipeline
    from matcha_tpu_torch.ops import mrf
    from matcha_tpu_torch.scripts import bench_serve
    from matcha_tpu_torch.scripts.profile_latency import SENTENCES
    from matcha_tpu_torch.scripts.trace_settle import TRACE_SETTLE_S, graph_launch_counts
    from matcha_tpu_torch.serve import BatchingServer, _parse_warmup, make_http_server
    from matcha_tpu_torch.text import intersperse, text_to_sequence

    pipe = TTSPipeline(model, vocoder, bias, cleaner=CLEANER, device=dev)
    server = BatchingServer(pipe, max_batch=8, n_timesteps=10, temperature=0.667, seed=SEED)
    httpd, shapes = None, K1Shapes().__enter__()
    run, run_ms = server._run, []

    def timed_run(reqs, rate, spk):  # a batch's time inside the batcher thread
        t = time.perf_counter()
        run(reqs, rate, spk)
        run_ms.append(((time.perf_counter() - t) * 1e3, len(reqs)))

    server._run = timed_run
    try:
        shapes.tag = "warmup"
        t0 = time.perf_counter()
        server.warmup(_parse_warmup(SERVE_WARMUP))
        warm_s = time.perf_counter() - t0
        shapes.tag = "requests"
        captures = [{"T_y": g.T_y, "seconds": capture_seconds(g),
                     "memory_allocated_before_after_MiB": [v / 2**20 for v in g.memory_allocated]}
                    for g in pipe._graphs.values() if g.graph is not None]
        httpd = make_http_server(server, "127.0.0.1", 0)
        threading.Thread(target=httpd.serve_forever, daemon=True).start()
        url = f"http://127.0.0.1:{httpd.server_address[1]}"

        def post(path, payload):
            req = urllib.request.Request(url + path, data=_json.dumps(payload).encode(),
                                         headers={"Content-Type": "application/json"})
            with urllib.request.urlopen(req, timeout=300) as resp:
                return resp.status, resp.headers, resp.read()

        T_x = server._warm_x[-1]
        seqs = [np.asarray(intersperse(text_to_sequence(s, [CLEANER]), 0), np.int32)
                for s in SENTENCES]
        batch_texts = bench_serve.SENTENCES

        def burst():
            """bench_serve's sentences submitted at once to an idle server,
            inside one batch window of 0.1 s"""
            results = [None] * len(batch_texts)

            def client(j):
                results[j] = server.submit(batch_texts[j], timeout_s=300.0)

            threads = [threading.Thread(target=client, args=(j,)) for j in range(len(results))]
            server.batch_window_s = 0.1
            for t in threads:
                t.start()
            for t in threads:
                t.join()
            server.batch_window_s = 0.01
            return results

        mrf.LAUNCHES["mrf_stage"] = 0
        replays0 = sum(g.replays for g in pipe._graphs.values())
        lone, merged = [], {}
        with trace(activities=[ProfilerActivity.CUDA]) as prof:
            for rep in range(SERVE_REPS):
                for i, s in enumerate(SENTENCES):
                    T_y = server._pick_fused_bucket(T_x, server.default_rate, False, len(seqs[i]))
                    n_call = server._n_calls + 1
                    t1 = time.perf_counter()
                    status, headers, body = post("/synthesise", {"text": s})
                    ms = (time.perf_counter() - t1) * 1e3
                    lone.append({"sentence": i, "rep": rep, "T_y": T_y, "n_call": n_call,
                                 "client_ms": ms, "server_ms": float(headers["X-Latency-Ms"]),
                                 "body": body})
            n0 = server.n_batches
            results = burst()
            torch.cuda.synchronize()
            time.sleep(TRACE_SETTLE_S)
        merged["batches"] = server.n_batches - n0
        counts = {**device_counts(prof), **graph_launch_counts(prof)}
        wrapper = mrf.LAUNCHES["mrf_stage"]
        replays = sum(g.replays for g in pipe._graphs.values()) - replays0

        if replays != len(lone) or server.n_fast != len(lone):
            raise AssertionError(f"serve: {replays} replays and {server.n_fast} fast-path "
                                 f"requests for {len(lone)} lone requests")
        if counts["k1"] != 2 * (len(lone) + merged["batches"]):
            raise AssertionError(f"serve: K1 ran {counts['k1']} times for {len(lone)} replays "
                                 f"and {merged['batches']} batches ({counts})")
        for r in lone:
            got, fields = _wav_samples(r.pop("body"))
            x1 = np.zeros((1, T_x), np.int32)
            seq = seqs[r["sentence"]]
            x1[0, :len(seq)] = seq
            want = pipe.synthesise_batch(x1, np.asarray([len(seq)], np.int32), fixed_y_bucket=r["T_y"],
                                         cuda_graph=False, generator=server.call_generator(r["n_call"]))
            n = int(want["mel_lengths"][0])
            ref = want["waveform"][0, :n * HOP].clamp(-1, 1).cpu().numpy()
            r.update(frames=n, max_abs_err=float(np.abs(got - ref).max()) if got.size == ref.size
                     else None)
            if not (fields == (1, 3, SR) and got.size == n * HOP and n < r["T_y"]
                    and r["max_abs_err"] <= GRAPH_TOL + 2.0 / (2**23 - 1)):
                raise AssertionError(f"serve: lone request against the eager body: {r}")
        errors = [r.error for r in results if r.error]
        frames = []
        for text, r in zip(batch_texts, results):
            seq = np.zeros((1, T_x), np.int64)
            ids = intersperse(text_to_sequence(text, [CLEANER]), 0)
            seq[0, :len(ids)] = ids
            _, _, y_len = pipe.model.encode(torch.from_numpy(seq).to(dev),
                                            torch.tensor([len(ids)], dtype=torch.int32, device=dev),
                                            server.default_rate)
            frames.append((r.n_frames, int(y_len[0])))
        if errors or merged["batches"] > 2 or any(a != b for a, b in frames):
            raise AssertionError(f"serve: 8 concurrent requests: errors {errors}, "
                                 f"{merged['batches']} batches, frames {frames}")
        merged.update(requests=len(results), frames=[a for a, _ in frames],
                      requests_per_batch=len(results) / max(merged["batches"], 1))

        # a burst of 8 alone: its batches' time inside the batcher (the
        # second of two bursts), then the card's busy time over another
        # under torch.profiler, whose idle share is read against that time
        bursts = []

        def timed_burst():
            k, n0 = len(run_ms), server.n_batches
            results = burst()
            # a batch wakes its clients before its _run returns
            t = time.perf_counter()
            while len(run_ms) - k < server.n_batches - n0 and time.perf_counter() - t < 10:
                time.sleep(0.001)
            bursts.append((results, run_ms[k:]))

        timed_burst()
        timed_burst()
        batch_ms = sum(ms for ms, _ in bursts[-1][1])
        busy = device_busy(timed_burst, batch_ms)
        if any(r.error for rs, _ in bursts for r in rs):
            raise AssertionError(f"serve: a burst of 8 failed: {bursts}")
        merged.update(burst_batch_ms=batch_ms, burst_batches=[[n for _, n in runs]
                                                              for _, runs in bursts],
                      profiled_burst_batch_ms=sum(ms for ms, _ in bursts[-1][1]),
                      device_busy=busy)

        long_text = " ".join(SENTENCES)
        status, _, body = post("/synthesise_long", {"text": long_text, "max_chars": 120})
        long_wav, fields = _wav_samples(body)
        conn = http.client.HTTPConnection("127.0.0.1", httpd.server_address[1], timeout=300)
        conn.request("POST", "/synthesise_stream", body=_json.dumps({"text": long_text,
                                                                      "max_chars": 120}),
                     headers={"Content-Type": "application/json"})
        resp = conn.getresponse()
        header, pcm = resp.read(44), resp.read()
        conn.close()
        with urllib.request.urlopen(url + "/healthz", timeout=30) as h:
            health = _json.loads(h.read())
        if not (status == 200 and fields == (1, 3, SR) and long_wav.size > 0
                and header[:4] == b"RIFF" and header[8:12] == b"WAVE"
                and len(pcm) == 3 * long_wav.size
                and health == {"status": "ok", **server.counters()}):
            raise AssertionError(f"serve: long {status} {fields} {long_wav.size}, stream "
                                 f"{header[:12]} {len(pcm)}, healthz {health}")

        del run_ms[:]
        raw = bench_serve.run_window(server, SERVE_CLIENTS, SERVE_SECONDS, stream=True)
        load = bench_serve.summarise(raw, SERVE_CLIENTS, 1e3 * server.batch_window_s, 8, False)
        load["batch_ms"] = {"p50": statistics.median(ms for ms, _ in run_ms),
                            "max": max(ms for ms, _ in run_ms), "batches": len(run_ms)}
    finally:
        if httpd is not None:
            httpd.shutdown()
            httpd.server_close()
        server.shutdown()
        shapes.__exit__()
    torch.cuda.empty_cache()
    k1_rows = shapes.check(dev, torch.Generator().manual_seed(SEED), ("requests", "graph"))
    by_sentence = {}
    for r in lone:
        by_sentence.setdefault(r["sentence"], []).append(r)
    return {"warmup": SERVE_WARMUP, "max_batch": 8, "warmup_s": warm_s, "graphs": captures,
            "lone": {f"sentence_{i}": {"T_y": rs[-1]["T_y"], "frames": rs[0]["frames"],
                                       "client_p50_ms": statistics.median(r["client_ms"] for r in rs),
                                       "server_p50_ms": statistics.median(r["server_ms"] for r in rs),
                                       "max_abs_err": max(r["max_abs_err"] for r in rs)}
                     for i, rs in by_sentence.items()},
            "replays": replays, "merged": merged,
            "long_form": {"samples": int(long_wav.size)}, "healthz": health,
            "k1_launches": counts["k1"], "k1_wrapper_launches": wrapper,
            "graph_launches": counts["graph_launches"], "k1_per_graph_launch": counts["k1_per_launch"],
            "dtoh_copies": counts["dtoh"], "load": load, "k1_shapes": k1_rows,
            "note": f"lone: {SERVE_REPS} requests per sentence over HTTP, client clock and the "
                    f"server's X-Latency-Ms, each held against the eager body on its call's "
                    f"generator; k1_launches: device events by name over the lone and merged "
                    f"requests; merged.burst_batch_ms: host clock around the batcher's _run, "
                    f"synchronised by its fetch; merged.device_busy: the union of device "
                    f"intervals over one more burst, idle share against burst_batch_ms; "
                    f"load: bench_serve.run_window, client 0 streaming, batch_ms per _run; "
                    f"k1_shapes: K1 against its plain version on random input"}


def set_tf32(cudnn: bool) -> None:
    """cuDNN's TF32 as given; matmuls in full f32 (torch's default)."""
    import torch

    torch.backends.cudnn.allow_tf32 = cudnn
    torch.backends.cuda.matmul.allow_tf32 = False


def precision_fixed_bucket(dev, model, vocoder, bias, tp, bucket, shapes) -> dict:
    """The fixed-bucket path at ``bucket`` in each of PRECISION_MODES on
    the same noise: one capture, then PRECISION_REPS timed replays (host
    clock, synchronised, after one more), the card's busy time over one,
    a run of the same body eagerly (bit-equal?), and the waveform's max and
    mean deviation from full precision's, the mean within the mode's
    bound. The modes that keep the encoder f32 (all but torch's TF32
    default) must give full precision's mel lengths."""
    import torch

    from matcha_tpu_torch.pipeline import TTSPipeline
    from matcha_tpu_torch.ops import mrf

    z = torch.randn(1, bucket, model.n_feats, generator=torch.Generator().manual_seed(SEED + 5))
    z = z.to(dev)
    rows, ref = {}, None
    for mode, (kw, tf32, k1, k1_bf16, mean_bound) in PRECISION_MODES.items():
        set_tf32(tf32)
        shapes.tag = mode
        pipe = TTSPipeline(model, vocoder, bias, cleaner=CLEANER, device=dev, **kw)

        def run(cuda_graph=None, pipe=pipe):
            return pipe.synthesise_batch(tp["x"], tp["x_lengths"], fixed_y_bucket=bucket, z=z,
                                         cuda_graph=cuda_graph)

        torch.cuda.synchronize()
        mrf.LAUNCHES.update(mrf_stage=0, mrf_stage_bf16=0)
        out = run()
        torch.cuda.synchronize()
        launches = dict(mrf.LAUNCHES)
        times = []
        for _ in range(PRECISION_REPS + 1):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            run()
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        p50 = statistics.median(times[1:]) * 1e3
        busy = device_busy(run, p50)
        eager = run(cuda_graph=False)
        torch.cuda.synchronize()
        wav = out["waveform"]
        if ref is None:
            ref = out
        same_len = torch.equal(out["mel_lengths"], ref["mel_lengths"])
        d = (wav - ref["waveform"]).abs()
        row = rows[mode] = {
            "tf32_cudnn": tf32, **kw, "wav_mean_dev_bound": mean_bound,
            "replay_p50_ms": p50, "busy_ms": busy["busy_ms"], "idle_share": busy["idle_share"],
            "k1_in_replay": busy["kernel_launches"], "k1_wrapper_launches_at_capture": launches,
            "mel_frames": int(out["mel_lengths"][0]), "mel_lengths_equal_full": same_len,
            "wav_max_abs_dev": d.max().item(), "wav_mean_abs_dev": d.mean().item(),
            "mel_max_abs_dev": (out["mel"] - ref["mel"]).abs().max().item(),
            "replay_bit_equal_eager": torch.equal(wav, eager["waveform"]),
            "replay_max_abs_err_eager": (wav - eager["waveform"]).abs().max().item()}
        if not (bool(torch.isfinite(wav).all()) and wav.shape == (1, bucket * HOP)
                and (same_len or tf32) and row["wav_mean_abs_dev"] <= mean_bound
                and launches == {"mrf_stage": 2 * k1, "mrf_stage_bf16": 2 * k1_bf16}
                and torch.equal(out["mel_lengths"], eager["mel_lengths"])
                and row["replay_max_abs_err_eager"] <= GRAPH_TOL):
            raise AssertionError(f"precision, fixed-bucket path, {mode}: {row}")
        del pipe, out, eager
        torch.cuda.empty_cache()
    return rows


def precision_vocoder(dev, vocoder, shapes_run, shapes) -> dict:
    """The generator alone in each of VOCODER_PRECISIONS at each (label, B,
    T_mel), CUDA events, TF32 off: ms, K1's launches per call by instance,
    and the deviation from the f32 hybrid. Returns the rows and the
    launches of K1's bf16-product instance (its counts set to 0 before and
    read after the calls that use it)."""
    import copy

    import torch

    from matcha_tpu_torch.models.hifigan_fused import fused_stage_weights, generator_apply_fused
    from matcha_tpu_torch.ops import mrf

    set_tf32(False)
    gens = {False: (vocoder, fused_stage_weights(vocoder))}
    gen16 = copy.deepcopy(vocoder).to(torch.bfloat16).eval()
    gens[True] = (gen16, fused_stage_weights(gen16))
    g = torch.Generator().manual_seed(SEED + 9)
    rows, bf16_launches = [], 0
    for label, B, T_mel in shapes_run:
        mel = torch.randn(B, T_mel, vocoder.h.num_mels, generator=g).to(dev)
        reps = 20 if B * T_mel <= 256 else 5
        row, ref = {"shape": label, "B": B, "T_mel": T_mel, "modes": {}}, None
        for name, (bf16, cap, cd, k1, k1_bf16) in VOCODER_PRECISIONS.items():
            gen, weights, cd = *gens[bf16], getattr(torch, cd)
            m = mel.to(torch.bfloat16) if bf16 else mel
            shapes.tag = f"vocoder_{name}"

            def fn(gen=gen, m=m, weights=weights, cap=cap, cd=cd):
                return generator_apply_fused(gen, m, weights, max_fused_channels=cap,
                                             compute_dtype=cd)

            torch.cuda.synchronize()
            mrf.LAUNCHES.update(mrf_stage=0, mrf_stage_bf16=0)
            wav = fn().float()
            torch.cuda.synchronize()
            launches = dict(mrf.LAUNCHES)
            bf16_launches += launches["mrf_stage_bf16"]
            ref = wav if ref is None else ref
            d = (wav - ref).abs()
            row["modes"][name] = {"ms": cuda_ms(fn, reps), "k1_launches": launches,
                                  "max_abs_dev": d.max().item(), "mean_abs_dev": d.mean().item()}
            if not (launches == {"mrf_stage": k1, "mrf_stage_bf16": k1_bf16}
                    and bool(torch.isfinite(wav).all()) and wav.shape == (B, T_mel * HOP, 1)):
                raise AssertionError(f"precision, vocoder {name} at {label}: {row['modes'][name]}")
        rows.append(row)
    return rows, bf16_launches


def precision_k1_bf16(dev, vocoder, shapes_run) -> list:
    """K1's bf16-product instance at each narrow stage (C <= 64) of a
    random mel at each (label, B, T_mel), against its plain version
    (K1_BF16_TOL), timed (CUDA events) beside the 3xTF32 instance, its
    plain version and the bf16 generator's cuDNN conv chain, with its
    bf16 tensor-core bound."""
    import copy

    import torch

    from matcha_tpu_torch.models.hifigan_fused import MAX_FUSED_CHANNELS
    from matcha_tpu_torch.ops import mrf

    set_tf32(False)
    h = vocoder.h
    ks, dils = h.resblock_kernel_sizes, h.resblock_dilation_sizes
    gen16 = copy.deepcopy(vocoder).to(torch.bfloat16).eval()
    g = torch.Generator().manual_seed(SEED + 10)
    bf16, rows = torch.bfloat16, []
    for label, B, T_mel in shapes_run:
        reps = 20 if B * T_mel <= 256 else 5
        mel = torch.randn(B, T_mel, h.num_mels, generator=g).to(dev)
        with torch.inference_mode():
            x = vocoder.conv_pre(mel.transpose(1, 2))
            for i in range(len(vocoder.ups)):
                x = vocoder.upsample(i, x)
                C, T = x.shape[1], x.shape[2]
                if C <= MAX_FUSED_CHANNELS:
                    w = mrf.mrf_weights_from_resblocks(vocoder.stage_blocks(i))
                    xc, x16 = x.contiguous(), x.to(bf16)
                    got = mrf.fused_mrf_stage(xc, w, ks, dils, compute_dtype=bf16)
                    want = mrf.fused_mrf_stage_reference(xc, w, ks, dils, compute_dtype=bf16)
                    f32 = mrf.fused_mrf_stage_reference(xc, w, ks, dils)
                    row = {"shape": label, "B": B, "T_mel": T_mel, "C": C, "T": T,
                           "t_tile": mrf.pick_t_tile(C, T, B=B), **k1_errors(got, want, f32),
                           "ms": cuda_ms(lambda: mrf.fused_mrf_stage(
                               xc, w, ks, dils, compute_dtype=bf16), reps),
                           "tf32x3_ms": cuda_ms(lambda: mrf.fused_mrf_stage(xc, w, ks, dils), reps),
                           "plain_ms": cuda_ms(lambda: mrf.fused_mrf_stage_reference(
                               xc, w, ks, dils, compute_dtype=bf16), reps),
                           "library_ms": cuda_ms(lambda i=i: gen16.mrf_stage(i, x16), reps),
                           **k1_bound_ms(B, C, T, ks, dils, peak=PEAK_BF16_FLOPS)}
                    rows.append(row)
                    del got, want, f32
                    if not within_k1_tol(row, bf16):
                        raise AssertionError(f"K1's bf16 instance disagrees at {row}")
                x = vocoder.mrf_stage(i, x)
    torch.cuda.synchronize()
    return rows


def precision_daemon(dev, model, vocoder, bias) -> dict:
    """The daemon in process on 127.0.0.1 with each of its precision flags
    (its pipeline built from ``serve.build_parser``'s parse of the flag, as
    ``serve.main`` builds it), ``max_batch`` 1, warmed at 128:256 (its
    graphs captured in that mode): one /synthesise request each must
    answer a 24-bit WAV of finite samples by replaying a warmed graph."""
    import json as _json
    import threading
    import urllib.request

    import numpy as np
    import torch

    from matcha_tpu_torch import serve
    from matcha_tpu_torch.pipeline import TTSPipeline

    set_tf32(False)
    rows = {}
    for flag in ("--bf16-vocoder", "--no-pallas-vocoder"):
        args = serve.build_parser().parse_args([flag])
        pipe = TTSPipeline(model, vocoder, bias, cleaner=CLEANER, device=dev,
                           vocoder_bf16=args.bf16_vocoder,
                           vocoder_pallas=not args.no_pallas_vocoder)
        server = serve.BatchingServer(pipe, max_batch=1, n_timesteps=10, seed=SEED)
        httpd = None
        try:
            t0 = time.perf_counter()
            server.warmup(serve._parse_warmup("128:256"))
            warm_s = time.perf_counter() - t0
            httpd = serve.make_http_server(server, "127.0.0.1", 0)
            threading.Thread(target=httpd.serve_forever, daemon=True).start()
            req = urllib.request.Request(
                f"http://127.0.0.1:{httpd.server_address[1]}/synthesise",
                data=_json.dumps({"text": SHORT_SENTENCE}).encode(),
                headers={"Content-Type": "application/json"})
            t1 = time.perf_counter()
            with urllib.request.urlopen(req, timeout=300) as resp:
                status, body = resp.status, resp.read()
            ms = (time.perf_counter() - t1) * 1e3
            samples, fields = _wav_samples(body)
            row = rows[flag] = {
                "status": status, "samples": int(samples.size), "client_ms": ms,
                "warmup_s": warm_s, "fast_path_replays": server.n_fast,
                "vocoder_dtype": str(pipe.vocoder.conv_pre.weight.dtype),
                "fused_stages": sorted(pipe.vocoder_weights)}
            if not (status == 200 and fields == (1, 3, SR) and samples.size > 0
                    and bool(np.isfinite(samples).all()) and server.n_fast == 1):
                raise AssertionError(f"precision, daemon {flag}: {row}")
        finally:
            if httpd is not None:
                httpd.shutdown()
                httpd.server_close()
            server.shutdown()
        del pipe, server
        torch.cuda.empty_cache()
    return rows


def precision_cli(model, vocoder) -> dict:
    """``python -m matcha_tpu_torch.cli``'s precision flags on the card:
    the seed model and vocoder written as reference-format checkpoints
    into a temporary ``$MATCHA_HOME``, then ``cli.cli`` in process with
    each of PRECISION_CLI's flag sets, starting from torch's TF32 default.
    Each must write a wav of its mel's frames x hop; ``--full-precision``
    must leave TF32 off and its absence leave it on."""
    import wave

    import numpy as np
    import torch

    from matcha_tpu_torch import cli

    rows, home = {}, os.environ.get("MATCHA_HOME")
    with tempfile.TemporaryDirectory() as root:
        ckpts = os.path.join(root, "matcha_tpu")
        os.makedirs(ckpts)
        torch.save({"state_dict": {k: v.cpu() for k, v in model.state_dict().items()},
                    "hyper_parameters": {}}, os.path.join(ckpts, "matcha_ljspeech.ckpt"))
        torch.save({"generator": {k: v.cpu() for k, v in vocoder.state_dict().items()}},
                   os.path.join(ckpts, "hifigan_T2_v1"))
        os.environ["MATCHA_HOME"] = root
        try:
            for name, flags in PRECISION_CLI.items():
                set_tf32(True)
                out = os.path.join(root, name)
                t0 = time.perf_counter()
                cli.cli(["--text", SHORT_SENTENCE, "--cleaner", CLEANER, "--output_folder", out,
                         *flags])
                seconds = time.perf_counter() - t0
                with wave.open(os.path.join(out, "utterance_001.wav")) as f:
                    frames = f.getnframes()
                mel = np.load(os.path.join(out, "utterance_001.npy"))
                row = rows[name] = {"flags": flags, "seconds": seconds, "wav_frames": frames,
                                    "mel_frames": int(mel.shape[1]),
                                    "tf32_after": torch.backends.cudnn.allow_tf32}
                if not (frames == mel.shape[1] * HOP > 0 and bool(np.isfinite(mel).all())
                        and row["tf32_after"] is ("--full-precision" not in flags)):
                    raise AssertionError(f"precision, CLI {flags}: {row}")
        finally:
            if home is None:
                os.environ.pop("MATCHA_HOME", None)
            else:
                os.environ["MATCHA_HOME"] = home
    return rows


def precision_phase(dev, model, vocoder, bias, tp, bucket, shapes_run) -> dict:
    """Serving precision on the card: the fixed-bucket path in five modes,
    the generator in five precisions, K1's bf16-product instance at the
    vocoder's narrow stages, the daemon with each precision flag, the CLI
    with its four; then K1 against its plain version at every (B, C, T,
    instance) the phase ran it at. The TF32 flags are set here per part
    and restored at the end."""
    import torch

    saved = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    try:
        with K1Shapes() as shapes:
            fixed = precision_fixed_bucket(dev, model, vocoder, bias, tp, bucket, shapes)
            voc, bf16_launches = precision_vocoder(dev, vocoder, shapes_run, shapes)
        set_tf32(False)
        k1_shapes = shapes.check(dev, torch.Generator().manual_seed(SEED),
                                 {e for v in shapes.seen.values() for e in v["tags"]})
        k1_bf16 = precision_k1_bf16(dev, vocoder, shapes_run)
        daemon = precision_daemon(dev, model, vocoder, bias)
        cli_runs = precision_cli(model, vocoder)
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved
    return {"bucket": bucket, "fixed_bucket": fixed, "vocoder": voc,
            "k1_bf16_launches": bf16_launches, "k1_bf16": k1_bf16, "k1_shapes": k1_shapes,
            "daemon": daemon, "cli": cli_runs, "k1_bf16_tolerance": K1_BF16_TOL,
            "note": f"fixed_bucket: host clock around synthesise_batch at the bucket, "
                    f"synchronised, median of {PRECISION_REPS} replays after 1; busy ms and "
                    f"K1 per replay from torch.profiler; deviations against full_precision on "
                    f"the same noise. vocoder and k1_bf16: CUDA events, TF32 off; library_ms: "
                    f"the bf16 generator's cuDNN conv chain; bound: bf16 FLOPs / 989 TFLOP/s"}


def replay_and_eager_p50(graph_pipe, eager_pipe, tp, **kw) -> dict:
    """p50 ms of MS_REPS fixed-bucket calls at MS_BUCKET after one warm-up,
    the graph's replay and its body run eagerly in turns, each on a
    generator of its own (host clock, synchronised)."""
    import torch

    runs = {"graph": [], "eager": []}
    gens = {m: torch.Generator(graph_pipe.device).manual_seed(SEED) for m in runs}
    for _ in range(MS_REPS + 1):
        for m, p, mode in (("graph", graph_pipe, None), ("eager", eager_pipe, False)):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            p.synthesise_batch(tp["x"], tp["x_lengths"], fixed_y_bucket=MS_BUCKET,
                               generator=gens[m], cuda_graph=mode, **kw)
            torch.cuda.synchronize()
            runs[m].append((time.perf_counter() - t0) * 1e3)
    return {f"{m}_p50_ms": statistics.median(v[1:]) for m, v in runs.items()}


def multispeaker_serving(dev, vocoder, bias, texts) -> dict:
    """The VCTK Matcha (109 speakers, ``spk_emb_dim`` 64, VCTK's mel
    statistics; weights from the seed) through ``TTSPipeline`` at two
    speakers: the dynamic path on the three serving sentences; the
    fixed-bucket path at MS_BUCKET, each replay against the same body run
    eagerly on the same noise (bit-equal), one capture per x bucket
    serving both speakers, and the two speakers' mels differing; replay
    and eager latency in turns and the card's busy time over one replay;
    ``--fused-stage`` over MS_CORPUS_UTTS of bench.py's utterances at one
    speaker against the split stages; the daemon warmed at MS_WARMUP with
    a default speaker, one request without ``"spk"`` and one with another
    speaker, each against the eager body on its call's generator, and an
    id out of range answered 400. K1's wrapper count is set to 0 before
    the path and read after; K1 against its plain version at every shape
    the path gave it."""
    import threading
    import urllib.error
    import urllib.request

    import numpy as np
    import torch

    from matcha_tpu_torch.pipeline import X_BUCKETS, TTSPipeline, pick_bucket
    from matcha_tpu_torch.models.matcha import MatchaTTS
    from matcha_tpu_torch.ops import mrf
    from matcha_tpu_torch.scripts.trace_settle import corpus_utterances
    from matcha_tpu_torch.serve import BatchingServer, make_http_server
    from matcha_tpu_torch.text import intersperse, text_to_sequence

    torch.manual_seed(SEED)
    model = MatchaTTS(**VCTK)
    pipe = TTSPipeline(model, vocoder, bias, cleaner=CLEANER, device=dev)
    eager = TTSPipeline(model, vocoder, bias, cleaner=CLEANER, device=dev)
    a, b = MS_SPEAKERS

    def noise(seed, B, T_y):
        return torch.randn(B, T_y, model.n_feats,
                           generator=torch.Generator().manual_seed(seed)).to(dev)

    with K1Shapes() as shapes:
        shapes.tag = "multispeaker"
        mrf.LAUNCHES["mrf_stage"] = 0
        dynamic = []
        for i, tp in enumerate(texts):
            for spk in MS_SPEAKERS:
                out = pipe.synthesise_batch(tp["x"], tp["x_lengths"], spks=[spk],
                                            generator=torch.Generator(dev).manual_seed(SEED + i))
                wav, ml = out["waveform"], int(out["mel_lengths"][0])
                if not (bool(torch.isfinite(wav).all()) and ml * HOP <= wav.shape[-1]):
                    raise AssertionError(f"multispeaker: dynamic path, sentence {i} speaker {spk}")
                dynamic.append({"sentence": i, "spk": spk, "mel_frames": ml,
                                "samples": int(wav.shape[-1])})
        k1_dynamic = mrf.LAUNCHES["mrf_stage"]
        if k1_dynamic != len(pipe.vocoder_weights) * len(dynamic):
            raise AssertionError(f"multispeaker: K1 launched {k1_dynamic} times for "
                                 f"{len(dynamic)} requests")

        fixed = []
        for i, tp in enumerate(texts):
            z, mels = noise(SEED + i, 1, MS_BUCKET), {}
            for spk in MS_SPEAKERS:
                g = pipe.synthesise_batch(tp["x"], tp["x_lengths"], fixed_y_bucket=MS_BUCKET,
                                          z=z, spks=[spk])
                e = eager.synthesise_batch(tp["x"], tp["x_lengths"], fixed_y_bucket=MS_BUCKET,
                                           z=z, spks=[spk], cuda_graph=False)
                torch.cuda.synchronize()
                row = {"sentence": i, "spk": spk, "mel_frames": int(g["mel_lengths"][0]),
                       "bit_equal": all(torch.equal(g[k], e[k]) for k in
                                        ("mel", "mel_lengths", "waveform", "wav_pcm24")),
                       "max_abs_err": (g["waveform"] - e["waveform"]).abs().max().item()}
                row["saturated"] = row["mel_frames"] >= MS_BUCKET
                fixed.append(row)
                if not (row["bit_equal"] and bool(torch.isfinite(g["waveform"]).all())):
                    raise AssertionError(f"multispeaker: replay against eager {row}")
                mels[spk] = g["mel"]
            fixed[-1]["speakers_differ"] = not torch.equal(mels[a], mels[b])
            if not fixed[-1]["speakers_differ"]:
                raise AssertionError(f"multispeaker: speakers {a} and {b} gave one mel")
        bodies = [g for k, g in pipe._graphs.items() if k[0] != "stage"]
        graphs = [g for g in bodies if g.graph is not None]
        x_buckets = {pick_bucket(int(tp["x_lengths"][0]), X_BUCKETS) for tp in texts}
        if not (len(bodies) == len(x_buckets) and all(g.spks is not None for g in bodies)
                and all(g.graph is not None and g.replays == len(MS_SPEAKERS)
                        for g in bodies if g.cuda_graph)):
            raise AssertionError(f"multispeaker: {len(graphs)} captures for {len(x_buckets)} x "
                                 "buckets, each to serve both speakers")
        tp = texts[1]
        latency = replay_and_eager_p50(pipe, eager, tp, spks=[a])
        gen = torch.Generator(dev).manual_seed(SEED + 1)
        busy = device_busy(lambda: pipe.synthesise_batch(
            tp["x"], tp["x_lengths"], fixed_y_bucket=MS_BUCKET, generator=gen, spks=[a]),
            latency["graph_p50_ms"])

        utts = corpus_utterances(MS_CORPUS_UTTS, SEED)
        corpus = {}
        for fuse in (False, True):
            t0 = time.perf_counter()
            corpus[fuse] = list(pipe.synthesise_corpus(
                utts, length_scale=CORPUS_RATE, batch_size=CORPUS_BATCH, fuse_stages=fuse,
                z=lambda bi, B, T_y: noise(SEED + 100 + bi, B, T_y), spk=a))
            torch.cuda.synchronize()
            corpus[f"{'fused' if fuse else 'split'}_s"] = time.perf_counter() - t0
        err, bit_equal = 0.0, True
        for (ca, oa), (cb, ob) in zip(corpus[False], corpus[True]):
            if ca != cb or not np.array_equal(oa["mel_lengths_host"], ob["mel_lengths_host"]):
                raise AssertionError("multispeaker: fused stage ran other batches than split")
            err = max(err, (oa["waveform"] - ob["waveform"]).abs().max().item())
            bit_equal &= torch.equal(oa["waveform"], ob["waveform"])
        stage_graphs = [g for k, g in pipe._graphs.items() if k[0] == "stage" and g.graph]
        if err > GRAPH_TOL or not all(g.spks is not None for g in stage_graphs):
            raise AssertionError(f"multispeaker: fused stage against split {err}")
        audio_s = sum(int(o["mel_lengths_host"].sum()) for _, o in corpus[False]) * HOP / SR

        dpipe = TTSPipeline(model, vocoder, bias, cleaner=CLEANER, device=dev)
        server = BatchingServer(dpipe, max_batch=1, n_timesteps=10, temperature=0.667, seed=SEED,
                                default_spk=a)
        httpd = None
        try:
            shapes.tag = "warmup"
            server.warmup([MS_WARMUP])
            shapes.tag = "multispeaker"
            captured = [g for g in dpipe._graphs.values() if g.graph is not None]
            replays0 = sum(g.replays for g in captured)
            httpd = make_http_server(server, "127.0.0.1", 0)
            threading.Thread(target=httpd.serve_forever, daemon=True).start()
            url = f"http://127.0.0.1:{httpd.server_address[1]}"

            def post(payload):
                req = urllib.request.Request(url + "/synthesise", data=json.dumps(payload).encode(),
                                             headers={"Content-Type": "application/json"})
                with urllib.request.urlopen(req, timeout=300) as resp:
                    return resp.read()

            seq = np.asarray(intersperse(text_to_sequence(SHORT_SENTENCE, [CLEANER]), 0), np.int32)
            T_x = server._route_x(len(seq))
            x1 = np.zeros((1, T_x), np.int32)
            x1[0, :len(seq)] = seq
            daemon, wavs = [], {}
            for spk in (None, b):
                T_y = server._pick_fused_bucket(T_x, server.default_rate, True, len(seq))
                n_call = server._n_calls + 1
                got, fields = _wav_samples(post({"text": SHORT_SENTENCE, **(
                    {} if spk is None else {"spk": spk})}))
                want = dpipe.synthesise_batch(
                    x1, np.asarray([len(seq)], np.int32), fixed_y_bucket=T_y, cuda_graph=False,
                    generator=server.call_generator(n_call), spks=[a if spk is None else spk])
                n = int(want["mel_lengths"][0])
                ref = want["waveform"][0, :n * HOP].clamp(-1, 1).cpu().numpy()
                row = {"spk": spk, "served_as": a if spk is None else spk, "T_y": T_y,
                       "frames": n, "max_abs_err": (float(np.abs(got - ref).max())
                                                    if got.size == ref.size else None)}
                daemon.append(row)
                wavs[row["served_as"]] = got
                if not (fields == (1, 3, SR) and row["max_abs_err"] is not None
                        and row["max_abs_err"] <= GRAPH_TOL + 2.0 / (2**23 - 1)):
                    raise AssertionError(f"multispeaker: daemon request against eager {row}")
            try:
                post({"text": SHORT_SENTENCE, "spk": VCTK["n_spks"]})
                refused = None
            except urllib.error.HTTPError as e:
                refused = e.code
            replays = sum(g.replays for g in captured) - replays0
            after = [g for g in dpipe._graphs.values() if g.graph is not None]
            if dev.type == "cuda" and not captured:
                raise AssertionError("multispeaker: the daemon's warmup captured no graph")
            if refused != 400 or replays != 2 * bool(captured) or len(after) != len(captured) or (
                    wavs[a].shape == wavs[b].shape and np.array_equal(wavs[a], wavs[b])):
                raise AssertionError(f"multispeaker: daemon refused {refused}, {replays} "
                                     f"replays, {len(after) - len(captured)} new captures")
        finally:
            if httpd is not None:
                httpd.shutdown()
                httpd.server_close()
            server.shutdown()
        k1_launches = mrf.LAUNCHES["mrf_stage"]
    if not k1_launches:
        raise AssertionError("multispeaker: K1 never launched")
    torch.cuda.empty_cache()
    k1_rows = shapes.check(dev, torch.Generator().manual_seed(SEED), ("multispeaker", "graph"))
    return {"model": "VCTK Matcha: LJSpeech widths, 109 speakers, spk_emb_dim 64, encoder "
                     "stack 256 wide, decoder in_channels 224, seed weights",
            "speakers": list(MS_SPEAKERS), "dynamic": dynamic, "k1_dynamic_launches": k1_dynamic,
            "fixed_bucket": MS_BUCKET, "fixed": fixed, "captures": len(graphs),
            "capture_seconds": [capture_seconds(g) for g in graphs], "latency": latency,
            "device_busy_replay": busy,
            "corpus": {"utterances": MS_CORPUS_UTTS, "batches": len(corpus[False]),
                       "audio_s": audio_s, "split_s": corpus["split_s"],
                       "fused_s": corpus["fused_s"], "fused_max_abs_err": err,
                       "fused_bit_equal": bit_equal, "stage_captures": len(stage_graphs)},
            "daemon": {"warmup": list(MS_WARMUP), "default_spk": a, "requests": daemon,
                       "out_of_range_status": refused, "replays": replays},
            "k1_launches": k1_launches, "k1_shapes": k1_rows,
            "note": f"latency: host clock around synthesise_batch at the fixed bucket, "
                    f"synchronised, median of {MS_REPS} after 1 warm-up, graph and eager in "
                    f"turns, sentence 1 at speaker {a}; corpus wall includes the fused mode's "
                    f"captures; k1_launches: the wrapper's count over the phase (captures and "
                    f"eager runs)"}


def conformer_model(bn: bool):
    """The LJSpeech Matcha with every U-Net stage a conformer block, weights
    from the seed; in BatchNorm mode with random running statistics (fresh
    ones are the identity)."""
    import torch

    from matcha_tpu_torch.models.matcha import MatchaTTS

    torch.manual_seed(SEED)
    model = MatchaTTS(dec_down_block_type="conformer", dec_mid_block_type="conformer",
                      dec_up_block_type="conformer", dec_conformer_batch_norm=bn)
    with torch.no_grad():
        for name, b in model.named_buffers():
            if name.endswith("running_mean"):
                b.copy_(0.5 * torch.randn(b.shape))
            elif name.endswith("running_var"):
                b.copy_(0.5 + 1.5 * torch.rand(b.shape))
    return model


def conformer_serving(dev, vocoder, bias, tp) -> dict:
    """The LJSpeech Matcha with every U-Net stage a conformer block, in both
    norm modes, at the fixed bucket MS_BUCKET on serving sentence 1: a
    replay against its eager body on the same noise (bit-equal), replay
    and eager latency in turns; and one estimator call at B = 1, T = 2,048
    (the top fixed bucket) against the all-transformer decoder's peak
    memory. K1's count set to 0 before and read after each mode."""
    import torch

    from matcha_tpu_torch.pipeline import TTSPipeline
    from matcha_tpu_torch.models.matcha import MatchaTTS
    from matcha_tpu_torch.ops import mrf

    rows = {}
    z = torch.randn(1, MS_BUCKET, 80, generator=torch.Generator().manual_seed(SEED)).to(dev)
    with K1Shapes() as shapes:
        shapes.tag = "conformer"
        for mode, bn in CONFORMER_MODES.items():
            model = conformer_model(bn)
            pipe = TTSPipeline(model, vocoder, bias, cleaner=CLEANER, device=dev)
            mrf.LAUNCHES["mrf_stage"] = 0
            g = pipe.synthesise_batch(tp["x"], tp["x_lengths"], fixed_y_bucket=MS_BUCKET, z=z)
            e = pipe.synthesise_batch(tp["x"], tp["x_lengths"], fixed_y_bucket=MS_BUCKET, z=z,
                                      cuda_graph=False)
            torch.cuda.synchronize()
            launches = mrf.LAUNCHES["mrf_stage"]
            row = {"mel_frames": int(g["mel_lengths"][0]),
                   "bit_equal": all(torch.equal(g[k], e[k]) for k in
                                    ("mel", "mel_lengths", "waveform", "wav_pcm24")),
                   "max_abs_err": (g["waveform"] - e["waveform"]).abs().max().item(),
                   "k1_launches": launches}
            if not (row["bit_equal"] and launches and bool(torch.isfinite(g["waveform"]).all())):
                raise AssertionError(f"conformer ({mode}): replay against eager {row}")
            row.update(replay_and_eager_p50(pipe, pipe, tp))
            rows[mode] = row
            del pipe, model
            torch.cuda.empty_cache()
    peaks = {}
    T = 2048
    for name, model in (("transformer", MatchaTTS()), ("conformer", conformer_model(False))):
        est = model.to(dev).eval().decoder.estimator
        x = torch.randn(1, T, 80, device=dev)
        mask, t = torch.ones(1, T, 1, device=dev), torch.full((1,), 0.5, device=dev)
        with torch.inference_mode():
            est(x, mask, x, t)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            ms = cuda_ms(lambda: est(x, mask, x, t), 3)
            peaks[name] = {"peak_above_MiB": (torch.cuda.max_memory_allocated() - base) / 2**20,
                           "estimator_ms": ms}
        del est, model
        torch.cuda.empty_cache()
    extra = peaks["conformer"]["peak_above_MiB"] - peaks["transformer"]["peak_above_MiB"]
    if not extra < 256:
        raise AssertionError(f"conformer: decode at T = {T} peaks {extra} MiB above the "
                             "transformer's")
    k1_rows = shapes.check(dev, torch.Generator().manual_seed(SEED), ("conformer", "graph"))
    return {"bucket": MS_BUCKET, "modes": rows, "decode_2048": peaks,
            "decode_2048_extra_MiB": extra, "k1_shapes": k1_rows,
            "note": f"latency: host clock, synchronised, median of {MS_REPS} after 1 warm-up, "
                    "graph and eager in turns; decode_2048: one estimator call at B = 1, "
                    "T = 2048, max_memory_allocated above the allocation before it, and its "
                    "CUDA-event ms (mean of 3)"}


def train_bf16(dev, cfg, corpus: dict, root: str) -> dict:
    """``trainer.precision=bf16-mixed`` on the LJSpeech config through
    ``train.main`` (EXTRA_STEPS steps, K2's launches against the MAS
    calls); then on one batch and one noise draw, dropout off, the f32 and
    the bf16 losses (within 2 %, JAX's bound), K2 on the bf16 step's own
    log-prior (EQUAL to its plain version; its ties counted; timed); then
    preloaded steps in f32 and bf16 in turns (step time, peak memory),
    with f32 masters and Adam moments after them."""
    import torch

    from matcha_tpu_torch import train
    from matcha_tpu_torch.models import matcha as matcha_module
    from matcha_tpu_torch.ops import mas
    from matcha_tpu_torch.training.trainer import (batch_losses, make_optimizer, to_device,
                                                   train_step)

    out_dir = os.path.join(root, "bf16")
    run = run_train(train_overrides(corpus, out_dir) + [
        f"trainer.max_steps={EXTRA_STEPS}", "trainer.precision=bf16-mixed"])
    rows = [r for r in read_metrics(out_dir) if "loss/train" in r]
    if (len(rows) != EXTRA_STEPS or not all(math.isfinite(r["loss/train"]) for r in rows)
            or run["k2_launches"] != run["mas_calls"] or not run["k2_launches"]):
        raise AssertionError(f"train_bf16: {rows} {run}")

    torch.manual_seed(SEED)
    dm = train.build_datamodule_from_cfg(cfg)
    model = train.build_model_from_cfg(cfg).to(dev)
    loaded = list(dm.train_batches(0))[:2]
    batch = to_device(loaded[0], dev)
    g = torch.Generator().manual_seed(SEED)
    B = batch["y"].shape[0]
    noise = {"t": torch.rand(B, generator=g).to(dev),
             "z": torch.randn(batch["y"].shape, generator=g).to(dev)}
    seen = []
    search = matcha_module.maximum_path
    matcha_module.maximum_path = lambda v, m: (seen.append((v, m)), search(v, m))[1]
    try:
        with torch.no_grad():
            model.eval()
            losses = {p: [float(v) for v in batch_losses(model, batch, noise=noise, precision=p)]
                      for p in ("f32", "bf16-mixed")}
    finally:
        matcha_module.maximum_path = search
    f32, bf16 = sum(losses["f32"]), sum(losses["bf16-mixed"])
    rel = abs(bf16 - f32) / abs(f32)
    if not rel < 0.02:
        raise AssertionError(f"train_bf16: bf16 loss {bf16} against f32 {f32}")
    value, mask = seen[1]
    valid = (mask[:, 1:] > 0) & (mask[:, :-1] > 0)
    ties = int(((value[:, 1:] == value[:, :-1]) & valid).sum())
    got = mas.maximum_path(value, mask)
    equal = torch.equal(got, mas.maximum_path_reference(value, mask))
    if not equal:
        raise AssertionError("train_bf16: K2 differs from its plain version on the bf16 log-prior")
    t_xs = [int(v) for v in mask[:, :, 0].sum(1)]
    t_ys = [int(v) for v in mask[:, 0, :].sum(1)]
    bound_ms, bound_by = k2_bound_ms(B, value.shape[1], value.shape[2], t_xs, t_ys)
    k2 = {"shape": list(value.shape), "log_prior_dtype": str(value.dtype).split(".")[-1],
          "adjacent_ties": ties, "equal": equal,
          "ms": cuda_ms(lambda: mas.maximum_path(value, mask), 20),
          "plain_ms": cuda_ms(lambda: mas.maximum_path_reference(value, mask), 2),
          "bound_ms": bound_ms, "bound_by": bound_by}
    del seen, value, mask, got

    model.train()
    opt, sched = make_optimizer(model, lr=float(cfg.model.optimizer.lr))
    step_ms, peaks = {"f32": [], "bf16-mixed": []}, {}
    for i in range(TRAIN_STEPS):
        for p in step_ms:
            b = to_device(loaded[i % len(loaded)], dev)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            train_step(model, opt, sched, b, 100 + i, SEED, precision=p)
            torch.cuda.synchronize()
            step_ms[p].append((time.perf_counter() - t0) * 1e3)
            peaks[p] = max(peaks.get(p, 0.0), torch.cuda.max_memory_allocated() / 2**30)
    moments = [v for s in opt.state.values() for k, v in s.items() if k.startswith("exp_avg")]
    f32_state = (all(p.dtype == torch.float32 for p in model.parameters())
                 and all(v.dtype == torch.float32 for v in moments))
    if not f32_state:
        raise AssertionError("train_bf16: masters or Adam moments left f32")
    return {"config": "experiment=ljspeech, batch 32, out_size null, trainer.precision=bf16-mixed",
            "run": run, "train_losses": rows, "losses_same_batch_and_noise": losses,
            "loss_f32": f32, "loss_bf16": bf16, "rel_diff": rel, "k2": k2,
            "step_ms": step_ms,
            "step_ms_p50_steps_2_5": {p: statistics.median(v[1:]) for p, v in step_ms.items()},
            "max_memory_allocated_GiB": peaks, "f32_masters_and_moments": f32_state,
            "note": "losses: one batch, dropout off, t and z from the seed; step_ms: preloaded "
                    "batches, host clock synchronised, f32 and bf16 in turns; K2 ms: CUDA "
                    "events, mean of 20 (plain: 2), on the log-prior the bf16 losses handed it"}


def multispeaker_train(root: str) -> dict:
    """``experiment=multispeaker`` (batch 32, out_size null) on a synthetic
    corpus with a ``path|spk|text`` filelist over speaker ids 0-108:
    EXTRA_STEPS steps in f32 and in bf16-mixed through ``train.main``,
    K2's launches against the MAS calls."""
    corpus = write_corpus(os.path.join(root, "vctk"), speakers=VCTK["n_spks"])
    out = {"speakers_in_corpus": corpus["speakers"]}
    for precision in ("f32", "bf16-mixed"):
        out_dir = os.path.join(root, f"vctk_{precision}")
        run = run_train(train_overrides(corpus, out_dir, "multispeaker") + [
            f"trainer.max_steps={EXTRA_STEPS}", f"trainer.precision={precision}"])
        rows = [r for r in read_metrics(out_dir) if "loss/train" in r]
        if (len(rows) != EXTRA_STEPS or not all(math.isfinite(r["loss/train"]) for r in rows)
                or run["k2_launches"] != run["mas_calls"] or not run["k2_launches"]):
            raise AssertionError(f"multispeaker training ({precision}): {rows} {run}")
        out[precision] = {"run": run, "train_losses": rows}
    return out


def conformer_train(dev, raw) -> dict:
    """One training step at batch 32 (the LJSpeech step's batch) of the
    all-conformer model in each norm mode: finite losses, one K2 launch,
    the BatchNorm's running statistics unchanged."""
    import torch

    from matcha_tpu_torch.ops import mas
    from matcha_tpu_torch.training.trainer import make_optimizer, to_device, train_step

    out = {}
    for mode, bn in CONFORMER_MODES.items():
        model = conformer_model(bn).to(dev)
        stats = [b.clone() for n, b in model.named_buffers() if "running" in n]
        opt, sched = make_optimizer(model)
        mas.LAUNCHES["maximum_path"] = 0
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        m = train_step(model, opt, sched, to_device(raw, dev), 0, SEED)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        launches = mas.LAUNCHES["maximum_path"]
        losses = {k: float(v) for k, v in m.items()}
        kept = all(torch.equal(a, b) for a, b in
                   zip(stats, [b for n, b in model.named_buffers() if "running" in n]))
        if not (all(map(math.isfinite, losses.values())) and launches == 1 and kept):
            raise AssertionError(f"conformer training ({mode}): {losses}, K2 {launches}, "
                                 f"stats kept {kept}")
        out[mode] = {"losses": losses, "k2_launches": launches, "step_ms": ms,
                     "max_memory_allocated_GiB": torch.cuda.max_memory_allocated() / 2**30,
                     "batch_norm_stats_kept": kept}
        del model, opt
        torch.cuda.empty_cache()
    return out


# vocoder GAN training: the v1 generator with the MPD and MSD at batch 16 x
# 8,192 samples (HiFiGANConfig's protocol) for VOC_EPOCHS epochs of the
# corpus, then one more resumed from `last`
VOC_EPOCHS = 2
# the tiny vocoder of the CPU tests (tests/test_deploy_and_vocoder.py's
# TINY_HIFI) for one step on the card and on the CPU: the losses to rtol
# VOC_LOSS_RTOL; every weight within VOC_WEIGHT_ATOL but at most a share
# VOC_WEIGHT_SHARE of them, which Adam's first update, about +-lr wherever
# a gradient is near zero, may move by up to 2 lr (f32 sums in another
# order, TF32 off)
VOC_TINY = {"upsample_rates": (4, 2), "upsample_kernel_sizes": (8, 4),
            "upsample_initial_channel": 16, "resblock_kernel_sizes": (3,),
            "resblock_dilation_sizes": ((1, 2),), "hop_size": 8, "n_fft": 32, "win_size": 32,
            "fmax": 4000.0, "segment_size": 128}
VOC_LOSS_RTOL, VOC_WEIGHT_ATOL, VOC_WEIGHT_SHARE = 1e-4, 1e-5, 1e-4
# the native mel frontend against the numpy one (tests/test_native_audio.py)
NATIVE_MEL_TOL = 5e-4
EXTRAS_STEPS, EXTRAS_BATCH = 4, 16
REMAT_REPS = 8


def vocoder_states_equal(a, b) -> bool:
    """Every tensor of two training states' state dicts (models, the MSD's
    u, both optimisers) equal, and the step."""
    import torch

    def leaves(x):
        if isinstance(x, dict):
            return [v for k in sorted(x, key=str) for v in leaves(x[k])]
        if isinstance(x, (list, tuple)):
            return [v for item in x for v in leaves(item)]
        return [x]

    la, lb = leaves(a.state_dict()), leaves(b.state_dict())
    return len(la) == len(lb) and all(
        torch.equal(x, y.to(x.device)) if isinstance(x, torch.Tensor) else x == y
        for x, y in zip(la, lb))


def vocoder_gpu_vs_cpu(dev, train_list: str) -> dict:
    """One GAN step of the tiny vocoder on the card and on the CPU: the
    same weights, optimiser state and segments."""
    import torch

    from matcha_tpu_torch.models.hifigan import HiFiGANConfig
    from matcha_tpu_torch.training import vocoder_trainer as vt
    from matcha_tpu_torch.training.vocoder_data import MelDataset

    h = HiFiGANConfig(**VOC_TINY)
    states = {"cpu": vt.init_vocoder_state(h, "cpu", steps_per_epoch=1)}
    states["gpu"] = vt.init_vocoder_state(h, dev, steps_per_epoch=1)
    for name in ("gen", "mpd", "msd"):
        getattr(states["gpu"], name).load_state_dict(getattr(states["cpu"], name).state_dict())
    ds = MelDataset(train_list, segment_size=h.segment_size, n_fft=h.n_fft, hop_size=h.hop_size,
                    win_size=h.win_size, fmax=h.fmax, seed=SEED)
    batch = next(ds.batches(2))
    metrics = {}
    for name, st in states.items():
        device = "cpu" if name == "cpu" else dev
        metrics[name] = {k: float(v) for k, v in vt.vocoder_train_step(
            st, {k: v.to(device) for k, v in batch.items()}).items()}
    loss_rel = max(abs(metrics["gpu"][k] - metrics["cpu"][k]) / abs(metrics["cpu"][k])
                   for k in metrics["cpu"])
    worst, beyond, total = 0.0, 0, 0
    for name in ("gen", "mpd", "msd"):
        want = getattr(states["cpu"], name).state_dict()
        for k, v in getattr(states["gpu"], name).state_dict().items():
            d = (v.cpu() - want[k]).abs()
            worst = max(worst, float(d.max()))
            beyond += int((d > VOC_WEIGHT_ATOL).sum())
            total += d.numel()
    lr = h.learning_rate
    if not (loss_rel < VOC_LOSS_RTOL and beyond <= VOC_WEIGHT_SHARE * total
            and worst <= 2 * lr + 1e-6):
        raise AssertionError(f"vocoder step: card against CPU: losses {metrics}, weights "
                             f"max {worst}, {beyond} of {total} beyond {VOC_WEIGHT_ATOL}")
    return {"config": "TINY_HIFI (tests/test_deploy_and_vocoder.py), batch 2 x 128 samples",
            "metrics": metrics, "max_loss_rel_diff": loss_rel, "max_weight_abs_diff": worst,
            "weights_beyond_atol": beyond, "weights": total, "weight_atol": VOC_WEIGHT_ATOL}


def vocoder_train_phase(dev, corpus: dict, root: str) -> dict:
    """``python -m matcha_tpu_torch.training.vocoder_train`` (through its
    ``main``) at the v1 width, batch 16 x 8,192 samples, on the corpus's
    train clips: VOC_EPOCHS epochs with checkpoints, then one more epoch
    resumed from ``last``. Each step timed (synchronised), its losses,
    rate and scale 0's u recorded; K1 never launched (the training
    generator runs plain convs under autograd); the restored state
    against the live one; the step's FLOPs counted on one more step."""
    import torch
    from torch.utils.flop_counter import FlopCounterMode

    from matcha_tpu_torch.models.hifigan import HiFiGANConfig
    from matcha_tpu_torch.ops import mrf, mrf_phase
    from matcha_tpu_torch.training import vocoder_train
    from matcha_tpu_torch.training import vocoder_trainer as vt
    from matcha_tpu_torch.training.vocoder_data import MelDataset

    h = HiFiGANConfig()
    out_dir = os.path.join(root, "vocoder")
    records, live = [], {}
    step_fn = vocoder_train.vocoder_train_step

    def timed(state, batch):
        u0 = state.msd.discriminators[0].convs[0].weight_u.clone()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        m = step_fn(state, batch)
        torch.cuda.synchronize()
        records.append({"step": state.step, "ms": (time.perf_counter() - t0) * 1e3,
                        "lr": state.gen_opt.param_groups[0]["lr"],
                        "u_moved": not torch.equal(u0, state.msd.discriminators[0].convs[0].weight_u),
                        **{k: float(v) for k, v in m.items()}})
        live["state"] = state
        return m

    argv = ["--train-filelist", corpus["train"], "--output-dir", out_dir,
            "--batch-size", str(h.batch_size), "--log-every-n-steps", "1",
            "--save-every-n-epochs", str(VOC_EPOCHS)]
    vocoder_train.vocoder_train_step = timed
    mrf.LAUNCHES["mrf_stage"] = mrf_phase.LAUNCHES["mrf_stage_phase"] = 0
    try:
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        vocoder_train.main(argv + ["--epochs", str(VOC_EPOCHS)])
        run_s = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() / 2**30
        first = live.pop("state")
        last = os.path.join(out_dir, "checkpoints", "last")
        restored = vt.init_vocoder_state(h, dev, steps_per_epoch=first.steps_per_epoch)
        epoch = vocoder_train.load_vocoder_checkpoint(last, restored)
        exact = vocoder_states_equal(first, restored)
        del first, restored
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        vocoder_train.main(argv + ["--epochs", str(VOC_EPOCHS + 1), "--restore-from", last])
        resumed_s = time.perf_counter() - t0
    finally:
        vocoder_train.vocoder_train_step = step_fn
    k1 = mrf.LAUNCHES["mrf_stage"] + mrf_phase.LAUNCHES["mrf_stage_phase"]
    spe = N_TRAIN // h.batch_size
    with open(last + ".meta.json", encoding="utf-8") as f:
        meta = json.load(f)
    losses = [r[k] for r in records for k in ("disc_loss", "gen_loss", "mel_l1")]
    lr4 = records[spe]["lr"]
    ok = (len(records) == (VOC_EPOCHS + 1) * spe and all(map(math.isfinite, losses))
          and records[0]["u_moved"] and lr4 == h.learning_rate * h.lr_decay
          and records[0]["lr"] == h.learning_rate and exact and epoch == VOC_EPOCHS
          and meta == {"step": (VOC_EPOCHS + 1) * spe, "epoch": VOC_EPOCHS + 1} and k1 == 0
          and os.path.exists(os.path.join(out_dir, "checkpoints",
                                          f"g_{VOC_EPOCHS * spe:08d}")))
    if not ok:
        raise AssertionError(f"vocoder_train: records {records}, restored exact {exact}, "
                             f"epoch {epoch}, meta {meta}, K1 launches {k1}")

    # the step's FLOPs, counted on one more step of a fresh state
    state = vt.init_vocoder_state(h, dev, steps_per_epoch=spe)
    ds_batch = next(MelDataset(corpus["train"], seed=SEED).batches(h.batch_size))
    with FlopCounterMode(display=False) as counter:
        vt.vocoder_train_step(state, {k: v.to(dev) for k, v in ds_batch.items()})
    flops = counter.get_total_flops()
    del state
    torch.cuda.empty_cache()
    p50 = statistics.median(r["ms"] for r in records[1:VOC_EPOCHS * spe])
    return {"config": "HiFi-GAN v1 (512 wide, upsampling 8, 8, 2, 2) + MPD + MSD, weight "
                      f"norm, batch {h.batch_size} x {h.segment_size} samples, seed weights",
            "corpus": f"{N_TRAIN} train clips of the synthetic corpus, {spe} steps an epoch",
            "steps": records, "step_ms_p50_steps_2_8": p50,
            "segments_per_s": h.batch_size / (p50 / 1e3),
            "audio_s_per_s": h.batch_size * h.segment_size / SR / (p50 / 1e3),
            "max_memory_allocated_GiB": peak, "run_s": run_s, "resumed_s": resumed_s,
            "lr_update_4": lr4, "lr_expected": h.learning_rate * h.lr_decay,
            "restored_equals_saved": exact, "resumed_meta": meta, "k1_launches": k1,
            "step_flops": flops,
            "achieved_tflops": flops / (p50 / 1e3) / 1e12,
            "share_of_f32_peak": flops / (p50 / 1e3) / PEAK_F32_FLOPS,
            "note": "step ms: host clock around vocoder_train_step, synchronised; FLOPs: "
                    "torch.utils.flop_counter over one step (convs, forward and backward)"}


def train_extras(dev, corpus: dict, root: str, cfg) -> dict:
    """The Matcha trainer's options on the LJSpeech config: a short run
    through ``train.main`` with the native mel frontend,
    ``trainer.profiler=jax`` and tensorboard + CSV loggers (K2's launches
    against the MAS calls; the trace; the image tags written after the
    validation); the native frontend against numpy over the corpus; one
    step's gradients with ``remat`` on and off."""
    import copy

    import torch

    from matcha_tpu_torch import train
    from matcha_tpu_torch.audio.mel import mel_spectrogram_np
    from matcha_tpu_torch.audio.native import library_path, mel_spectrogram_native
    from matcha_tpu_torch.training.trainer import batch_losses, to_device
    from matcha_tpu_torch.utils.utils import read_wav

    out_dir = os.path.join(root, "extras")
    overrides = [o for o in train_overrides(corpus, out_dir)
                 if not o.startswith(("data.frontend=", "logger="))]
    run = run_train(overrides + [
        "data.frontend=native", "logger=many_loggers", "trainer.profiler=jax",
        f"trainer.max_steps={EXTRAS_STEPS}", f"data.batch_size={EXTRAS_BATCH}"])
    rows = [r for r in read_metrics(out_dir) if "loss/train" in r]
    traces = sorted(os.listdir(os.path.join(out_dir, "profile")))
    trace_path = os.path.join(out_dir, "profile", traces[0]) if traces else None
    trace_bytes = os.path.getsize(trace_path) if trace_path else 0
    with open(trace_path, encoding="utf-8") as f:
        kernels = sum(1 for e in json.load(f)["traceEvents"] if e.get("cat") == "kernel")
    from tensorboard.backend.event_processing.event_accumulator import EventAccumulator

    events = EventAccumulator(os.path.join(out_dir, "tensorboard"), size_guidance={"images": 0})
    events.Reload()
    tags = sorted(events.Tags()["images"])
    want_tags = sorted(f"{kind}/{i}" for i in (0, 1)
                       for kind in ("original", "generated_enc", "generated_dec", "alignment"))
    try:
        import matplotlib  # noqa: F401
        renderer = "matplotlib"
    except ImportError:
        renderer = "numpy (matplotlib is not installed)"
    if (len(rows) != EXTRAS_STEPS or not all(math.isfinite(r["loss/train"]) for r in rows)
            or run["k2_launches"] != run["mas_calls"] or not run["k2_launches"]
            or trace_bytes == 0 or not kernels or tags != want_tags):
        raise AssertionError(f"train_extras: rows {rows}, run {run}, traces {traces} "
                             f"({trace_bytes} bytes, {kernels} kernels), tags {tags}")

    # the native frontend against numpy, clip by clip over the corpus
    paths = []
    for name in ("train", "val"):
        with open(corpus[name], encoding="utf-8") as f:
            paths += [line.split("|")[0] for line in f if line.strip()]
    worst, times = 0.0, {"native": 0.0, "numpy": 0.0}
    for path in paths:
        audio, _ = read_wav(path)
        mels = {}
        for name, fn in (("native", mel_spectrogram_native), ("numpy", mel_spectrogram_np)):
            t0 = time.perf_counter()
            mels[name] = fn(audio, 1024, 80, SR, HOP, 1024, 0.0, 8000.0)
            times[name] += time.perf_counter() - t0
        worst = max(worst, float(abs(mels["native"] - mels["numpy"]).max()))
    if not worst < NATIVE_MEL_TOL:
        raise AssertionError(f"train_extras: native mel {worst} from numpy's")

    # remat: one step's gradients with the estimator rematerialised and without
    torch.manual_seed(SEED)
    model = train.build_model_from_cfg(cfg).to(dev)
    remat = copy.deepcopy(model)
    remat.decoder.remat = True
    batch = to_device(next(train.build_datamodule_from_cfg(cfg).train_batches(0)), dev)

    def forward_backward(m) -> float:
        """Losses + backward from zeroed gradients, the same noise and
        dropout draws every time; host clock, synchronised, in ms."""
        m.zero_grad(set_to_none=True)
        m.train()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        torch.manual_seed(SEED + 1)  # dropout
        loss = sum(batch_losses(m, batch, generator=torch.Generator(dev).manual_seed(SEED)))
        loss.backward()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3

    grads, peaks = [], {}
    for name, m in (("warm-up", model), ("off", model), ("on", remat)):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        forward_backward(m)
        peaks[name] = torch.cuda.max_memory_allocated() / 2**30
        if name != "warm-up":
            grads.append({n: p.grad for n, p in m.named_parameters() if p.grad is not None})
    del peaks["warm-up"]
    diff = max(float((grads[0][n] - grads[1][n]).abs().max()) for n in grads[0])
    equal = grads[0].keys() == grads[1].keys() and all(
        torch.equal(grads[0][n], grads[1][n]) for n in grads[0])
    if not diff <= 1e-6:
        raise AssertionError(f"train_extras: remat gradients {diff} from those without")
    # remat's time: REMAT_REPS pairs, the order alternating (off-on, on-off)
    samples = {"off": [], "on": []}
    for rep in range(REMAT_REPS):
        for name in (("off", "on") if rep % 2 == 0 else ("on", "off")):
            samples[name].append(forward_backward(model if name == "off" else remat))
    step_ms = {name: {"median": statistics.median(v), "min": min(v), "max": max(v),
                      "samples": v} for name, v in samples.items()}
    del model, remat, grads
    torch.cuda.empty_cache()
    return {"config": f"experiment=ljspeech, batch {EXTRAS_BATCH}, data.frontend=native, "
                      "trainer.profiler=jax, logger=many_loggers (tensorboard + csv)",
            "run": run, "train_losses": rows,
            "trace": {"file": traces[0], "bytes": trace_bytes, "kernel_events": kernels},
            "image_tags": tags, "image_renderer": renderer,
            "native_library": library_path().name,
            "native_vs_numpy": {"clips": len(paths), "max_abs_diff": worst,
                                "tol": NATIVE_MEL_TOL,
                                "ms_per_clip": {k: v / len(paths) * 1e3 for k, v in times.items()}},
            "remat": {"max_abs_grad_diff": diff, "bit_equal": equal, "forward_backward_ms": step_ms,
                      "max_memory_allocated_GiB": peaks},
            "note": "remat: losses + backward of the LJSpeech model on the corpus's first "
                    f"batch (32), the same noise and dropout draws; {REMAT_REPS} alternating "
                    "pairs after a warm-up; host clock, synchronised"}


# deploy_eval: the exported artifact's buckets (B, T_x, T_y) and ODE steps
# (deploy/export.py's defaults), the infer batch and its lines, timed calls
# per side, the artifact against its eager wrapper (the same kernels; cuDNN
# may pick other algorithms in the exported graph), the sweep's trials,
# steps and batch, and the CLI's two sentences
DEPLOY_B, DEPLOY_TX, DEPLOY_TY, DEPLOY_STEPS = 1, 256, 1024, 5
INFER_B, INFER_LINES, ARTIFACT_REPS = 4, 6, 5
ARTIFACT_TOL = 1e-5
SWEEP_TRIALS, SWEEP_STEPS, SWEEP_BATCH = 2, 2, 8
CLI_SENTENCES = ("The birch canoe slid on the smooth planks.",
                 "Glue the sheet to the dark blue background.")


def counted_k1(fn):
    """(fn(), K1's launches over it, from 0)."""
    import torch

    from matcha_tpu_torch.ops import mrf

    mrf.LAUNCHES["mrf_stage"] = 0
    out = fn()
    torch.cuda.synchronize()
    return out, mrf.LAUNCHES["mrf_stage"]


def deploy_cli(root: str, native: str) -> dict:
    """The CLI through the model registry (``--model matcha_ljspeech
    --vocoder hifigan_T2_v1``, files under ``$MATCHA_HOME``) on two
    sentences, then on the training run's native checkpoint and on the
    same weights as a ``.ckpt``. Every run writes .wav, .npy and .png per
    sentence; K1 launches 2 for the denoiser's bias at load and 2 per
    sentence; the native and ``.ckpt`` routes give equal mel lengths."""
    import numpy as np
    import torch

    from matcha_tpu_torch import cli

    lines = os.path.join(root, "cli_lines.txt")
    with open(lines, "w", encoding="utf-8") as f:
        f.write("\n".join(CLI_SENTENCES) + "\n")
    common = ["--file", lines, "--cleaner", CLEANER, "--seed", str(SEED)]
    payload = torch.load(native, map_location="cpu", weights_only=True)
    as_ckpt = os.path.join(root, "native_as.ckpt")
    torch.save({"state_dict": payload["model"], "hyper_parameters": {}}, as_ckpt)
    runs = {"registry": ["--model", "matcha_ljspeech", "--vocoder", "hifigan_T2_v1"],
            "native": ["--checkpoint_path", native, "--vocoder", "hifigan_T2_v1"],
            "native_as_ckpt": ["--checkpoint_path", as_ckpt, "--vocoder", "hifigan_T2_v1"]}
    rows = {}
    for name, flags in runs.items():
        out = os.path.join(root, f"cli_{name}")
        t0 = time.perf_counter()
        _, launches = counted_k1(lambda: cli.cli([*flags, *common, "--output_folder", out]))
        files = sorted(os.listdir(out))
        want = sorted(f"utterance_{i:03d}.{e}" for i in (1, 2) for e in ("npy", "png", "wav"))
        mels = [np.load(os.path.join(out, f"utterance_{i:03d}.npy")) for i in (1, 2)]
        rows[name] = {"seconds": time.perf_counter() - t0, "k1_launches": launches,
                      "files": len(files), "mel_frames": [int(m.shape[1]) for m in mels]}
        if files != want or launches != 2 + 2 * len(CLI_SENTENCES) or not all(
                np.isfinite(m).all() for m in mels):
            raise AssertionError(f"deploy_eval, CLI {name}: {files}, {rows[name]}")
    if rows["native"]["mel_frames"] != rows["native_as_ckpt"]["mel_frames"]:
        raise AssertionError(f"native and .ckpt mel lengths differ: {rows}")
    rows["native_equals_ckpt_mels"] = all(
        np.array_equal(np.load(os.path.join(root, "cli_native", f"utterance_{i:03d}.npy")),
                       np.load(os.path.join(root, "cli_native_as_ckpt",
                                            f"utterance_{i:03d}.npy"))) for i in (1, 2))
    return rows


def deploy_export(dev, root: str, model, vocoder, ids) -> dict:
    """``deploy/export.py`` at B = 1 x 256 ids x 1,024 frames, 5 steps,
    without and with the vocoder: export seconds and artifact MB; the
    reloaded artifact on the card against the un-exported wrapper on the
    same z (lengths equal, within ARTIFACT_TOL, and whether bit-equal);
    then their times, 5 calls each in turns (synchronised host clock)."""
    import numpy as np
    import torch

    from matcha_tpu_torch.deploy.export import export_graph, get_exportable_fn

    x = torch.zeros((DEPLOY_B, DEPLOY_TX), dtype=torch.long, device=dev)
    x[0, :len(ids)] = torch.from_numpy(np.asarray(ids[:DEPLOY_TX])).to(dev)
    xl = torch.tensor([min(len(ids), DEPLOY_TX)], device=dev)
    scales = torch.tensor([0.667, 1.0], device=dev)
    z = torch.randn((DEPLOY_B, DEPLOY_TY, model.n_feats), device=dev,
                    generator=torch.Generator(dev).manual_seed(SEED))
    rows = {}
    for name, voc in (("mel", None), ("wav", vocoder)):
        path = os.path.join(root, f"artifact_{name}.pt2")
        t0 = time.perf_counter()
        export_graph(model, path, DEPLOY_B, DEPLOY_TX, DEPLOY_TY, DEPLOY_STEPS, voc)
        export_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        artifact = torch.export.load(path).module()
        load_s = time.perf_counter() - t0
        eager = get_exportable_fn(model, voc, DEPLOY_STEPS, DEPLOY_TY)
        with torch.no_grad():
            got, got_len = artifact(x, xl, scales, z)
            want, want_len = eager(x, xl, scales, z)
        err = (got - want).abs().max().item()
        times = {"artifact": [], "eager": []}
        for _ in range(ARTIFACT_REPS):
            for side, fn in (("artifact", artifact), ("eager", eager)):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                with torch.no_grad():
                    fn(x, xl, scales, z)
                torch.cuda.synchronize()
                times[side].append((time.perf_counter() - t0) * 1e3)
        rows[name] = {"export_s": export_s, "load_s": load_s,
                      "artifact_mb": os.path.getsize(path) / 1e6,
                      "shape": list(got.shape), "lengths": got_len.tolist(),
                      "max_abs_err": err, "bit_equal": bool(torch.equal(got, want)),
                      "artifact_p50_ms": statistics.median(times["artifact"]),
                      "eager_p50_ms": statistics.median(times["eager"]),
                      "artifact_ms": times["artifact"], "eager_ms": times["eager"]}
        if not (torch.equal(got_len, want_len) and err <= ARTIFACT_TOL
                and bool(torch.isfinite(got).all())):
            raise AssertionError(f"deploy_eval, artifact {name} against eager: {rows[name]}")
        del artifact, eager, got, want
    return rows


def deploy_infer(root: str) -> dict:
    """``deploy/infer.py`` on INFER_LINES lines through B = 4 artifacts
    (``deploy.export.main`` on the registry's checkpoint, with and without
    the vocoder) in its three output modes: output_1..6 as .npy + .png,
    as .wav embedded, as .wav from the external vocoder; the RTF of each
    batch."""
    from matcha_tpu_torch import cli
    from matcha_tpu_torch.deploy import export, infer

    home = cli.get_user_data_dir()
    ckpt = str(home / "matcha_ljspeech.ckpt")
    lines = os.path.join(root, "infer_lines.txt")
    with open(lines, "w", encoding="utf-8") as f:
        f.write("\n".join([*CLI_SENTENCES, *CORPUS_TEXT.split(". ")[2:2 + INFER_LINES - 2]]) + "\n")
    shape = ["--batch", str(INFER_B), "--t-x", str(DEPLOY_TX), "--t-y", str(DEPLOY_TY)]
    arts, export_s = {"mel": os.path.join(root, "infer_mel.pt2"),
                      "wav": os.path.join(root, "infer_wav.pt2")}, {}
    for name, extra in (("mel", []), ("wav", ["--vocoder-name", "hifigan_T2_v1"])):
        t0 = time.perf_counter()
        export.main([ckpt, arts[name], *shape, *extra])
        export_s[name] = time.perf_counter() - t0
    modes = {"mel": (arts["mel"], [], ("npy", "png")),
             "embedded_vocoder": (arts["wav"], [], ("wav",)),
             "external_vocoder": (arts["mel"], ["--vocoder-name", "hifigan_T2_v1"], ("wav",))}
    rows = {}
    for name, (art, extra, exts) in modes.items():
        out = os.path.join(root, f"infer_{name}")
        t0 = time.perf_counter()
        rtfs = infer.main([art, ckpt, "--file", lines, "--cleaner", CLEANER, "--output-dir", out,
                           *extra])
        files = sorted(os.listdir(out))
        want = sorted(f"output_{i + 1}.{e}" for i in range(INFER_LINES) for e in exts)
        rows[name] = {"seconds": time.perf_counter() - t0, "rtf_per_batch": rtfs,
                      "files": len(files)}
        if files != want or len(rtfs) != -(-INFER_LINES // INFER_B):
            raise AssertionError(f"deploy_eval, infer {name}: {files}")
    return {"export_s_b4": export_s, "modes": rows}


def deploy_eval_run(dev, corpus: dict, native: str) -> dict:
    """``eval.main`` on the training run's native checkpoint and corpus:
    finite means and MCD, K2 launched once per MAS call (one per
    validation batch), and K2 EQUAL to its plain version on the first
    batch's log-prior."""
    import torch

    from matcha_tpu_torch import eval as eval_module
    from matcha_tpu_torch.ops import mas

    argv = [f"ckpt_path={native}", "experiment=ljspeech",
            f"data.train_filelist_path={corpus['train']}",
            f"data.valid_filelist_path={corpus['val']}", f"data.cleaners=[{CLEANER}]",
            "data.frontend=numpy"]
    t0 = time.perf_counter()
    with CountMas() as counted:
        means = eval_module.main(argv)
    seconds = time.perf_counter() - t0
    value, mask = counted.first
    with torch.inference_mode():
        equal = torch.equal(mas.maximum_path(value, mask), mas.maximum_path_reference(value, mask))
    row = {"seconds": seconds, "means": means, "mas_calls": counted.calls,
           "k2_launches": counted.launches, "k2_shape": list(value.shape), "k2_equal": equal}
    if not (all(math.isfinite(v) for v in means.values()) and "mcd_vs_target" in means
            and counted.launches == counted.calls >= 1 and equal):
        raise AssertionError(f"deploy_eval, eval: {row}")
    return row


def deploy_app(dev) -> dict:
    """The app's backend: ``load_model`` + ``synthesise_mel`` on one
    sentence (K1 2 launches for the denoiser's bias at load, 2 for the
    request; the wav is mel_length x 256 samples); ``main()`` raises its
    message where gradio is absent."""
    import importlib.util

    import torch

    from matcha_tpu_torch import app, cli

    app._pipelines.clear()
    pipe, load_launches = counted_k1(lambda: app.load_model("matcha_ljspeech", "hifigan_T2_v1"))
    tp = cli.process_text(1, CLI_SENTENCES[0], CLEANER)
    t0 = time.perf_counter()
    (plot, (sr, wav)), launches = counted_k1(
        lambda: app.synthesise_mel(tp["x"], tp["x_lengths"], 10, 0.667, 0.95))
    seconds = time.perf_counter() - t0
    ml = int(pipe.synthesise_batch(tp["x"], tp["x_lengths"], n_timesteps=1, length_scale=0.95,
                                   generator=torch.Generator(dev).manual_seed(0))["mel_lengths"][0])
    row = {"load_k1_launches": load_launches, "k1_launches": launches, "seconds": seconds,
           "mel_frames": ml, "samples": int(wav.size), "png": os.path.getsize(plot) > 0}
    os.remove(plot)
    if importlib.util.find_spec("gradio") is None:
        try:
            app.main()
            raise AssertionError("app.main() ran without gradio")
        except RuntimeError as e:
            row["main_without_gradio"] = str(e)[:60]
    if not (launches == 2 and load_launches == 2 and wav.size == ml * HOP and sr == SR):
        raise AssertionError(f"deploy_eval, app: {row}")
    app._pipelines.clear()
    return row


def deploy_sweep(corpus: dict, root: str) -> dict:
    """``training/sweep.py::run_sweep`` with its default objective (the
    port's ``train.train`` on the card): SWEEP_TRIALS trials of
    SWEEP_STEPS steps at batch SWEEP_BATCH, sweeping the learning rate and
    the encoder's dropout; a finite best value, K2 launched once per MAS
    call."""
    from matcha_tpu_torch.training.sweep import run_sweep

    space = {"model.optimizer.lr": "loguniform(1e-5, 1e-3)",
             "model.encoder.encoder_params.p_dropout": "uniform(0.0, 0.3)"}
    overrides = train_overrides(corpus, os.path.join(root, "sweep")) + [
        "hparams_search=matcha_optuna", f"hparams_search.sweeper.n_trials={SWEEP_TRIALS}",
        f"hparams_search.sweeper.params={space!r}", f"trainer.max_steps={SWEEP_STEPS}",
        f"data.batch_size={SWEEP_BATCH}"]
    t0 = time.perf_counter()
    with CountMas() as counted:
        best = run_sweep(overrides)
    row = {"seconds": time.perf_counter() - t0, "best": best["metric"],
           "best_params": best["params"], "history": best["history"],
           "mas_calls": counted.calls, "k2_launches": counted.launches}
    if not (math.isfinite(best["metric"]) and len(best["history"]) == SWEEP_TRIALS
            and counted.launches == counted.calls >= SWEEP_TRIALS * SWEEP_STEPS):
        raise AssertionError(f"deploy_eval, sweep: {row}")
    return row


def deploy_eval_phase(dev, corpus: dict, root: str, native: str) -> dict:
    """Deployment and evaluation at full width (LJSpeech Matcha + HiFi-GAN
    v1 from the seed, f32, TF32 off): the CLI through the registry and on
    a native checkpoint, export + load, infer, eval, the app's backend,
    the sweep; then K1 against its plain version at every shape these ran
    it at."""
    import torch

    from matcha_tpu_torch import cli
    from matcha_tpu_torch.models.hifigan import Generator, HiFiGANConfig
    from matcha_tpu_torch.models.matcha import MatchaTTS

    set_tf32(False)
    torch.manual_seed(SEED)
    model = MatchaTTS().to(dev).eval()
    vocoder = Generator(HiFiGANConfig()).to(dev).eval()
    home, saved = os.path.join(root, "deploy_home"), os.environ.get("MATCHA_HOME")
    os.makedirs(os.path.join(home, "matcha_tpu"))
    torch.save({"state_dict": {k: v.cpu() for k, v in model.state_dict().items()},
                "hyper_parameters": {}}, os.path.join(home, "matcha_tpu", "matcha_ljspeech.ckpt"))
    torch.save({"generator": {k: v.cpu() for k, v in vocoder.state_dict().items()}},
               os.path.join(home, "matcha_tpu", "hifigan_T2_v1"))
    os.environ["MATCHA_HOME"] = home
    out = {}
    try:
        with K1Shapes() as shapes:
            shapes.tag = "deploy"
            t0 = time.perf_counter()
            out["cli"] = deploy_cli(root, native)
            out["cli"]["seconds_all"] = time.perf_counter() - t0
            ids = cli.process_text(0, CLI_SENTENCES[0], CLEANER)["x"][0]
            out["export"] = deploy_export(dev, root, model, vocoder, ids)
            t0 = time.perf_counter()
            out["infer"] = deploy_infer(root)
            out["infer"]["seconds"] = time.perf_counter() - t0
            out["eval"] = deploy_eval_run(dev, corpus, native)
            out["app"] = deploy_app(dev)
            out["sweep"] = deploy_sweep(corpus, root)
        gen = torch.Generator().manual_seed(SEED)
        out["k1_shapes"] = shapes.check(dev, gen, ("deploy",))
    finally:
        if saved is None:
            os.environ.pop("MATCHA_HOME", None)
        else:
            os.environ["MATCHA_HOME"] = saved
    return out


def _pad_ids(utts) -> tuple:
    import numpy as np

    x = np.zeros((len(utts), max(len(u) for u in utts)), np.int32)
    for i, u in enumerate(utts):
        x[i, :len(u)] = u
    return x, np.asarray([len(u) for u in utts], np.int32)


def _dp_compare(label: str, got: dict, want: dict, keys=("mel", "waveform")) -> dict:
    """A replica run against the one-device run: mel lengths equal (a
    duration flipped by the other batch split would show here, and is
    reported, not hidden), each output within DP_TOL; the largest
    difference and bit-equality of each."""
    import torch

    row = {"mel_lengths_equal": torch.equal(got["mel_lengths"].cpu(), want["mel_lengths"].cpu())}
    for k in keys:
        row[f"{k}_max_abs_err"] = (got[k].float() - want[k].float()).abs().max().item()
        row[f"{k}_bit_equal"] = torch.equal(got[k], want[k])
    if not row["mel_lengths_equal"] or any(row[f"{k}_max_abs_err"] > DP_TOL for k in keys):
        raise AssertionError(f"data_parallel, {label}: replicas against one device {row}")
    return row


def _k1_events(run) -> int:
    """K1's device events (by kernel name) over one ``run()`` under
    ``torch.profiler``: its launches inside graph replays too."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from matcha_tpu_torch.scripts.trace_settle import TRACE_SETTLE_S

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
        time.sleep(TRACE_SETTLE_S)
    return device_counts(prof)["k1"]


def dp_serving(dev, model, vocoder, bias) -> dict:
    """Data-parallel serving with two replicas on the one card
    (``TTSPipeline(devices=[cuda:0, cuda:0])``, the serving model and
    HiFi-GAN v1 from the seed, f32, TF32 off) against the one-device
    pipeline on the same generator seed: ``synthesise_batch`` at B =
    DP_BATCH of bench.py's utterances on the dynamic path and at mel
    bucket DP_BUCKET (one CUDA graph per replica), ``synthesise_corpus``
    with the fused stage over DP_CORPUS_UTTS of them; K1's launches (2
    per replica chunk: the wrapper's count on the dynamic path, the
    profiler's kernel events in the graph replays); p50 of DP_REPS in
    turns against one device (one card runs both halves: an overhead
    figure, not a speed-up); the daemon as ``--data-parallel`` builds it
    on one card (a no-op) and a daemon over the two replicas (no fast
    path), DP_REQUESTS concurrent requests each."""
    import threading
    import urllib.request

    import numpy as np
    import torch

    from matcha_tpu_torch import serve
    from matcha_tpu_torch.cli import data_parallel_devices
    from matcha_tpu_torch.pipeline import TTSPipeline
    from matcha_tpu_torch.ops import mrf
    from matcha_tpu_torch.scripts.trace_settle import corpus_utterances

    set_tf32(False)
    d0 = torch.device("cuda", 0)
    one = TTSPipeline(model, vocoder, bias, cleaner=CLEANER, device=d0)
    two = TTSPipeline(model, vocoder, bias, cleaner=CLEANER, devices=[d0, d0])
    utts = corpus_utterances(DP_CORPUS_UTTS, SEED)
    x, xl = _pad_ids(utts[:DP_BATCH])

    def gen():
        return torch.Generator(d0).manual_seed(SEED)

    out = {}
    with K1Shapes() as shapes:
        shapes.tag = "data_parallel"
        mrf.LAUNCHES["mrf_stage"] = 0
        got = two.synthesise_batch(x, xl, generator=gen())
        torch.cuda.synchronize()
        launches = mrf.LAUNCHES["mrf_stage"]
        want = one.synthesise_batch(x, xl, generator=gen())
        out["dynamic"] = {"B": DP_BATCH, "T_y": got["mel"].shape[-1],
                          "k1_launches": launches, "chunks": 2,
                          **_dp_compare("dynamic", got, want)}
        if launches != 2 * 2:
            raise AssertionError(f"data_parallel: K1 launched {launches} times for 2 chunks")
        fixed = {}
        for name, p in (("two", two), ("one", one)):
            p.synthesise_batch(x, xl, fixed_y_bucket=DP_BUCKET, generator=gen())  # captures
            fixed[name] = p.synthesise_batch(x, xl, fixed_y_bucket=DP_BUCKET, generator=gen())
        replay_k1 = _k1_events(lambda: two.synthesise_batch(x, xl, fixed_y_bucket=DP_BUCKET,
                                                            generator=gen()))
        out["fixed_bucket"] = {"bucket": DP_BUCKET, "k1_launches_in_replays": replay_k1,
                               "captures": [len(r._graphs) for r in two.replicas],
                               **_dp_compare("fixed bucket", fixed["two"], fixed["one"])}
        if replay_k1 != 2 * 2:
            raise AssertionError(f"data_parallel: K1 ran {replay_k1} times in 2 replays")

        def corpus(p):
            return list(p.synthesise_corpus(utts, batch_size=DP_BATCH, fuse_stages=True,
                                            generator=gen(), length_scale=CORPUS_RATE))

        corpus(two)  # captures every replica's stage graphs
        pairs = list(zip(corpus(two), corpus(one)))
        rows = []
        for (ca, a), (cb, b) in pairs:
            if ca != cb or not np.array_equal(a["mel_lengths_host"], b["mel_lengths_host"]):
                raise AssertionError("data_parallel: the corpus batches differ")
            rows.append(_dp_compare("corpus", a, b))
        corpus_k1 = _k1_events(lambda: corpus(two))
        out["corpus_fused_stage"] = {
            "utterances": DP_CORPUS_UTTS, "batches": len(pairs), "k1_launches_in_replays": corpus_k1,
            "mel_max_abs_err": max(r["mel_max_abs_err"] for r in rows),
            "waveform_max_abs_err": max(r["waveform_max_abs_err"] for r in rows),
            "bit_equal": all(r["mel_bit_equal"] and r["waveform_bit_equal"] for r in rows)}
        if corpus_k1 != 2 * 2 * len(pairs):
            raise AssertionError(f"data_parallel: K1 ran {corpus_k1} times in the corpus")

        runs = {"one": [], "two": []}
        for _ in range(DP_REPS + 1):
            for name, p in (("one", one), ("two", two)):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                p.synthesise_batch(x, xl, generator=gen())
                torch.cuda.synchronize()
                runs[name].append((time.perf_counter() - t0) * 1e3)
        out["latency_dynamic_B8"] = {f"{n}_p50_ms": statistics.median(r[1:])
                                     for n, r in runs.items()}

        daemons = {}
        args = serve.build_parser().parse_args(["--data-parallel"])
        devices = data_parallel_devices(args.data_parallel, dev)
        flag_pipe = TTSPipeline(model, vocoder, bias, cleaner=CLEANER,
                                device=devices[0] if devices else dev, devices=devices)
        for name, p in (("flag_one_card", flag_pipe), ("two_replicas", two)):
            server = serve.BatchingServer(p, max_batch=DP_REQUESTS, n_timesteps=10, seed=SEED)
            httpd = None
            try:
                server.warmup(serve._parse_warmup("128:256"))
                httpd = serve.make_http_server(server, "127.0.0.1", 0)
                threading.Thread(target=httpd.serve_forever, daemon=True).start()
                url = f"http://127.0.0.1:{httpd.server_address[1]}/synthesise"
                bodies = [None] * DP_REQUESTS

                def post(i):
                    req = urllib.request.Request(
                        url, data=json.dumps({"text": SHORT_SENTENCE}).encode(),
                        headers={"Content-Type": "application/json"})
                    with urllib.request.urlopen(req, timeout=300) as resp:
                        bodies[i] = (resp.status, resp.read())

                threads = [threading.Thread(target=post, args=(i,)) for i in range(DP_REQUESTS)]
                for t in threads:
                    t.start()
                for t in threads:
                    t.join(300)
                ok = [b is not None and b[0] == 200 and np.isfinite(_wav_samples(b[1])[0]).all()
                      and _wav_samples(b[1])[0].size > 0 for b in bodies]
                daemons[name] = {"replicas": len(p.replicas), "requests": DP_REQUESTS,
                                 "answered": sum(ok), "batches": server.n_batches,
                                 "fast_path": server.n_fast}
                if not all(ok) or (len(p.replicas) > 1 and server.n_fast):
                    raise AssertionError(f"data_parallel, daemon {name}: {daemons[name]}")
            finally:
                if httpd is not None:
                    httpd.shutdown()
                    httpd.server_close()
                server.shutdown()
        if devices is not None and torch.cuda.device_count() == 1:
            raise AssertionError("--data-parallel made replicas on one card")
        out["daemon"] = daemons
        out["k1_launches"] = launches
    torch.cuda.empty_cache()
    out["k1_shapes"] = shapes.check(dev, torch.Generator().manual_seed(SEED),
                                    ("data_parallel", "graph"))
    out["note"] = (f"two replicas on one card; latency: host clock around synthesise_batch, "
                   f"synchronised, median of {DP_REPS} after 1 warm-up, one device and two "
                   f"replicas in turns: an overhead figure, not a speed-up; K1 in replays from "
                   f"torch.profiler kernel events")
    return out


def _dp_overrides(corpus: dict, out_dir: str, dropout: bool) -> list:
    extra = [] if dropout else ["model.encoder.encoder_params.p_dropout=0.0",
                                "model.encoder.encoder_params.prenet=false",
                                "model.decoder.dropout=0.0"]
    return train_overrides(corpus, out_dir) + extra


def dp_worker(local_rank: int, workdir: str) -> None:
    """One of DP_RANKS gloo ranks on ``cuda:0`` (``dp_training``): one
    data-parallel step on the first batch of 32 (16 rows each, dropout
    and the prenet off) with its all-reduced gradients, 2 more timed
    steps; then a 2-step ``Trainer.fit`` with one validation (the real
    config), a resume from its checkpoint to step 3, and an uninterrupted
    3-step fit that also saves its step-2 state. Writes
    ``<workdir>/rank<i>.pt``."""
    import torch

    from matcha_tpu_torch import train
    from matcha_tpu_torch.ops import mas
    from matcha_tpu_torch.parallel import dist
    from matcha_tpu_torch.training import trainer as T
    from matcha_tpu_torch.utils.config import compose

    deterministic()
    torch.cuda.set_device(0)
    dev = torch.device("cuda", 0)
    spec = torch.load(os.path.join(workdir, "in.pt"), weights_only=False)
    out = {"rank": dist.rank(), "world": dist.world_size()}
    cfg = compose("train", _dp_overrides(spec["corpus"], os.path.join(workdir, "x"), False))
    raw = next(iter(train.build_datamodule_from_cfg(cfg).train_batches(0)))
    torch.manual_seed(SEED)
    model = train.build_model_from_cfg(cfg).to(dev)
    wrapped = T.make_ddp(model, dev, cfg.model.get("out_size"))
    opt, sched = T.make_optimizer(model, lr=float(cfg.model.optimizer.lr))
    grads = {}

    def keep(phase):
        if phase == "backward" and not grads:
            grads.update({k: p.grad.detach().cpu() for k, p in model.named_parameters()})

    with CountMas() as counted:
        host, share = T.share_batch(raw, cfg.model.get("out_size"))
        batch = T.to_device(host, dev)
        m = T.train_step(model, opt, sched, batch, 0, SEED, cfg.model.get("out_size"),
                         on_phase=keep, ddp=wrapped, share=share)
        out["step"] = {k: float(v) for k, v in m.items()}
        out["rows"] = [share.lo, share.n_rows, share.n_global]
        ms = []
        for step in (1, 2):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            T.train_step(model, opt, sched, batch, step, SEED, cfg.model.get("out_size"),
                         ddp=wrapped, share=share)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
    out["grads"], out["step_ms"] = grads, ms
    out["params"] = {k: v.detach().cpu() for k, v in model.state_dict().items()}
    out["k2"] = {"mas_calls": counted.calls, "launches": counted.launches}
    del model, wrapped, opt, grads
    torch.cuda.empty_cache()

    cfg = compose("train", _dp_overrides(spec["corpus"], os.path.join(workdir, "x"), True))

    def fit(name, max_steps, restore=None, every=0):
        torch.manual_seed(SEED)
        trainer = T.Trainer(train.build_model_from_cfg(cfg), train.build_datamodule_from_cfg(cfg),
                            dev, out_size=cfg.model.get("out_size"),
                            lr=float(cfg.model.optimizer.lr), max_steps=max_steps,
                            log_every_n_steps=1, output_dir=os.path.join(workdir, name),
                            seed=SEED, save_every_n_epochs=every, loggers={"csv": {}})
        val, validate = {}, trainer.validate

        def record(epoch):
            val[trainer.step] = validate(epoch)
            return val[trainer.step]

        trainer.validate = record
        with CountMas() as c:
            result = trainer.fit(restore_from=restore)
        return {"result": result, "val": val, "step": trainer.step,
                "k2": {"mas_calls": c.calls, "launches": c.launches},
                "params": {k: v.detach().cpu() for k, v in trainer.model.state_dict().items()}}

    out["fit"] = fit("fit", 2)
    out["resumed"] = fit("resumed", 3, os.path.join(workdir, "fit", "checkpoints", "last"))
    out["straight"] = fit("straight", 3, every=1)  # also keeps its step-2 state
    torch.save(out, os.path.join(workdir, f"rank{local_rank}.pt"))


def _max_diff(a: dict, b: dict) -> float:
    return max((a[k].float() - b[k].float()).abs().max().item() for k in a)


def dp_world1_worker(local_rank: int, workdir: str) -> None:
    """The one-process half of ``dp_training``, spawned in deterministic
    mode: NCCL at world size 1 (``cuda:0``), DP_STEPS steps through
    ``DistributedDataParallel`` against the plain step on the same batches
    and seed (dropout on), in turns, timed; then the plain step on the
    first batch of 32 with dropout and the prenet off, the one the gloo
    ranks split, with its gradients. Writes ``<workdir>/world1.pt``."""
    import copy

    import torch

    from matcha_tpu_torch import train
    from matcha_tpu_torch.training import trainer as T
    from matcha_tpu_torch.utils.config import compose

    deterministic()
    dev = torch.device("cuda", 0)
    spec = torch.load(os.path.join(workdir, "in.pt"), weights_only=False)
    cfg = compose("train", _dp_overrides(spec["corpus"], os.path.join(workdir, "x"), True))
    out_size = cfg.model.get("out_size")
    dm = train.build_datamodule_from_cfg(cfg)
    batches = [b for epoch in range(2) for b in dm.train_batches(epoch)][:DP_STEPS]
    torch.manual_seed(SEED)
    plain = train.build_model_from_cfg(cfg).to(dev)
    ddp_model = copy.deepcopy(plain)
    wrapped = T.make_ddp(ddp_model, dev, out_size)
    lr = float(cfg.model.optimizer.lr)
    opts = [T.make_optimizer(m, lr=lr) for m in (plain, ddp_model)]
    steps, ms, calls, launches = [], {"plain": [], "ddp": []}, 0, 0
    for i, raw in enumerate(batches):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        a = T.train_step(plain, *opts[0], T.to_device(
            {k: v for k, v in raw.items() if k != "rows"}, dev), i, SEED, out_size)
        torch.cuda.synchronize()
        ms["plain"].append((time.perf_counter() - t0) * 1e3)
        with CountMas() as counted:
            t0 = time.perf_counter()
            host, share = T.share_batch(raw, out_size)
            b = T.train_step(ddp_model, *opts[1], T.to_device(host, dev), i, SEED, out_size,
                             ddp=wrapped, share=share)
            torch.cuda.synchronize()
            ms["ddp"].append((time.perf_counter() - t0) * 1e3)
        calls, launches = calls + counted.calls, launches + counted.launches
        la, lb = ({k: float(v) for k, v in m.items()} for m in (a, b))
        steps.append({"losses_plain": la, "losses_ddp": lb,
                      "losses_bit_equal": la == lb,
                      "losses_max_rel_diff": max(abs(la[k] - lb[k]) / abs(la[k]) for k in la),
                      "weights_bit_equal": all(torch.equal(p, q) for p, q in zip(
                          plain.parameters(), ddp_model.parameters())),
                      "weights_max_abs_diff": max((p - q).abs().max().item() for p, q in zip(
                          plain.parameters(), ddp_model.parameters()))})
    out = {"batch": int(batches[0]["x"].shape[0]), "steps": steps, "step_ms": ms,
           "calls": calls, "launches": launches}
    del plain, ddp_model, wrapped, opts
    torch.cuda.empty_cache()

    cfg = compose("train", _dp_overrides(spec["corpus"], os.path.join(workdir, "y"), False))
    raw = next(iter(train.build_datamodule_from_cfg(cfg).train_batches(0)))
    torch.manual_seed(SEED)
    model = train.build_model_from_cfg(cfg).to(dev)
    opt, sched = T.make_optimizer(model, lr=float(cfg.model.optimizer.lr))
    grads = {}

    def keep(phase):
        if phase == "backward":
            grads.update({k: p.grad.detach().cpu() for k, p in model.named_parameters()})

    out["one"] = {k: float(v) for k, v in T.train_step(
        model, opt, sched, T.to_device({k: v for k, v in raw.items() if k != "rows"}, dev), 0,
        SEED, out_size, on_phase=keep).items()}
    out["one_grads"] = grads
    torch.save(out, os.path.join(workdir, "world1.pt"))


def dp_training(corpus: dict, root: str) -> dict:
    """Data-parallel training at the LJSpeech config's full width, batch
    32, on the synthetic corpus, every process spawned in deterministic
    mode (``launch_deterministic``):

    * NCCL at world size 1 (``dp_world1_worker``): DP_STEPS steps through
      ``DistributedDataParallel`` against the plain step on the same
      batches and seed: losses and weights bit-equal after each step;
      step ms of each (median of steps 2-3, preloaded), K2's launches
      against the MAS calls;
    * DP_RANKS gloo ranks sharing ``cuda:0`` (NCCL refuses two ranks on
      one GPU), the batch of 32 split 16 + 16 (``dp_worker``): one step's
      global losses and gradient norm within DP_RTOL of the one-process
      step on the 32 rows with the same noise (dropout and the prenet
      off), the all-reduced gradients within DP_GRAD_TOL of each
      tensor's largest, the ranks' weights and gradients bit-equal; a
      2-step fit with one validation (the same means on both ranks, one
      checkpoint, rank 0's), its resume to step 3 against an
      uninterrupted 3-step fit: losses, validation means and weights
      bit-equal, beside the step-2 weights of the two runs (their
      run-to-run spread); K2 per rank. gloo moves the gradients through
      the host: its step ms is not a multi-card figure."""
    import torch

    out = {"mode": DETERMINISTIC_MODE}
    workdir = os.path.join(root, "dp_nccl")
    os.makedirs(workdir)
    torch.save({"corpus": corpus}, os.path.join(workdir, "in.pt"))
    launch_deterministic(dp_world1_worker, (workdir,), 1, "nccl", workdir, DP_TIMEOUT_S)
    w1 = torch.load(os.path.join(workdir, "world1.pt"), weights_only=False)
    steps = w1["steps"]
    if not all(s["losses_bit_equal"] and s["weights_bit_equal"] for s in steps):
        raise AssertionError(f"data_parallel: NCCL world 1 against plain {steps}")
    if w1["launches"] != w1["calls"] or w1["calls"] != DP_STEPS:
        raise AssertionError(f"data_parallel: K2 {w1['launches']} launches for "
                             f"{w1['calls']} MAS calls")
    ms = w1["step_ms"]
    out["nccl_world1"] = {"batch": w1["batch"], "steps": steps, "step_ms": ms,
                          "plain_step_ms_p50_steps_2_3": statistics.median(ms["plain"][1:]),
                          "ddp_step_ms_p50_steps_2_3": statistics.median(ms["ddp"][1:]),
                          "k2_launches": w1["launches"], "mas_calls": w1["calls"]}
    want, want_grads = w1["one"], w1["one_grads"]

    workdir = os.path.join(root, "dp_gloo")
    os.makedirs(workdir)
    torch.save({"corpus": corpus}, os.path.join(workdir, "in.pt"))
    t0 = time.perf_counter()
    launch_deterministic(dp_worker, (workdir,), DP_RANKS, "gloo", workdir, DP_TIMEOUT_S)
    launch_s = time.perf_counter() - t0
    ranks = [torch.load(os.path.join(workdir, f"rank{i}.pt"), weights_only=False)
             for i in range(DP_RANKS)]
    r0, r1 = ranks
    rel = {k: max(abs(r["step"][k] - want[k]) / abs(want[k]) for r in ranks) for k in want}
    grad_err = max(((r0["grads"][k] - g).abs().max() / (g.abs().max() + 1e-12)).item()
                   for k, g in want_grads.items())
    ckpts = sorted(os.listdir(os.path.join(workdir, "fit", "checkpoints")))
    gloo = {
        "ranks": DP_RANKS, "rows": [r["rows"] for r in ranks], "losses_one_process": want,
        "losses_ranks": [r["step"] for r in ranks], "max_rel_diff": rel, "rtol": DP_RTOL,
        "grads_max_err_of_tensor_max": grad_err, "grad_tol": DP_GRAD_TOL,
        "grads_ranks_bit_equal": all(torch.equal(r0["grads"][k], r1["grads"][k])
                                     for k in r0["grads"]),
        "weights_ranks_bit_equal": all(torch.equal(r0["params"][k], r1["params"][k])
                                       for k in r0["params"]),
        "step_ms": [r["step_ms"] for r in ranks],
        "fit_val": [r["fit"]["val"] for r in ranks], "fit_checkpoints": ckpts,
        "resumed_step3": [r["resumed"]["result"] for r in ranks],
        "straight_step3": [r["straight"]["result"] for r in ranks],
        "resumed_val_step3": [r["resumed"]["val"][3] for r in ranks],
        "straight_val_step3": [r["straight"]["val"][3] for r in ranks],
        "resume_bit_equal": all(
            r["resumed"]["result"] == r["straight"]["result"]
            and r["resumed"]["val"][3] == r["straight"]["val"][3]
            and all(torch.equal(r["resumed"]["params"][k], r["straight"]["params"][k])
                    for k in r["straight"]["params"]) for r in ranks),
        "resume_weights_max_abs_diff": max(_max_diff(r["resumed"]["params"],
                                                     r["straight"]["params"]) for r in ranks),
        "two_runs_step2_weights_max_abs_diff": _max_diff(*(torch.load(
            os.path.join(workdir, run, "checkpoints", name), map_location="cpu",
            weights_only=True)["model"] for run, name in (("fit", "last"),
                                                          ("straight", "checkpoint_000002")))),
        "k2_per_rank": [{"step": r["k2"], **{n: r[n]["k2"] for n in ("fit", "resumed",
                                                                      "straight")}}
                        for r in ranks],
        "seconds": launch_s}
    if not (all(v <= DP_RTOL for v in rel.values()) and grad_err <= DP_GRAD_TOL
            and gloo["grads_ranks_bit_equal"] and gloo["weights_ranks_bit_equal"]):
        raise AssertionError(f"data_parallel: 2 gloo ranks against one process {gloo}")
    if not (r0["fit"]["val"] and r0["fit"]["val"] == r1["fit"]["val"]
            and ckpts == ["last", "last.hparams.json"] and gloo["resume_bit_equal"]):
        raise AssertionError(f"data_parallel: fit, checkpoint or resume on 2 ranks {gloo}")
    for r in ranks:
        for k2 in (r["k2"], *(r[n]["k2"] for n in ("fit", "resumed", "straight"))):
            if k2["launches"] != k2["mas_calls"] or not k2["launches"]:
                raise AssertionError(f"data_parallel: K2 on rank {r['rank']}: {k2}")
    out["gloo_two_ranks_cuda0"] = gloo
    out["k2_launches"] = out["nccl_world1"]["k2_launches"] + sum(
        k["step"]["launches"] + k["fit"]["launches"] + k["resumed"]["launches"]
        + k["straight"]["launches"] for k in gloo["k2_per_rank"])
    out["note"] = ("host clock, synchronised; NCCL world 1: step ms of the plain and the DDP "
                   "step on preloaded batches in turns, median of steps 2-3 (the DDP step "
                   "includes share_batch's host exchange); gloo: 2 ranks share cuda:0 and "
                   "move every gradient through the host, so its step ms is not a multi-card "
                   "figure; every process in deterministic mode")
    return out


def tp_worker(local_rank: int, workdir: str) -> None:
    """One of the gloo ranks sharing ``cuda:0`` of a ``tensor_parallel``
    job, in deterministic mode, on the LJSpeech config (dropout on): the
    model split over ``n_model`` ranks (all of them: the data axis has
    one index, so every rank holds all 32 rows) for ``steps`` steps with
    their losses, the gathered gradients of the first and the gathered
    weights after the last, each rank's replicated gradients and weights,
    step ms and K2's launches; before it, with ``plain``, the plain
    one-process steps on the same batches (every rank runs them: two runs
    give their run-to-run spread); with ``fit``, a 2-step
    ``Trainer(n_model_axis=)`` fit with one validation, a resume from its
    checkpoint to step 3 and an uninterrupted 3-step fit. Writes
    ``<workdir>/tp<i>.pt``."""
    import torch

    from matcha_tpu_torch import train
    from matcha_tpu_torch.parallel import dist, tensor
    from matcha_tpu_torch.training import trainer as T
    from matcha_tpu_torch.utils.config import compose

    deterministic()
    torch.cuda.set_device(0)
    dev = torch.device("cuda", 0)
    spec = torch.load(os.path.join(workdir, "in.pt"), weights_only=False)
    dist.set_model_axis(spec["n_model"])
    cfg = compose("train", train_overrides(spec["corpus"], os.path.join(workdir, "x")))
    out_size, lr = cfg.model.get("out_size"), float(cfg.model.optimizer.lr)
    dm = train.build_datamodule_from_cfg(cfg)
    raws = [b for epoch in range(2) for b in dm.train_batches(epoch)][:spec["steps"]]
    out = {"rank": dist.rank(), "rows": [int(v) for v in raws[0]["rows"]]}

    def run(split: bool, n_steps: int = len(raws)) -> dict:
        torch.cuda.reset_peak_memory_stats(dev)
        torch.manual_seed(SEED)
        model = train.build_model_from_cfg(cfg).to(dev)
        if split:
            tensor.shard_model(model)
        opt, sched = T.make_optimizer(model, lr=lr)
        loss = T.BatchLoss(model, out_size) if split else None
        grads, own, steps, ms, before = {}, {}, [], [], []
        plan = tensor.plan_of(model)

        def keep(phase):
            if phase == "backward" and not grads:
                for k, p in model.named_parameters():
                    grads[k] = tensor.full_tensor(model, k, p.grad).cpu()
                    if plan is not None and k not in plan.dims:
                        own[k] = p.grad.detach().cpu()

        with CountMas() as counted:
            for i, raw in enumerate(raws[:n_steps]):
                if split:  # the weights each step starts from, gathered (rank 0 keeps them)
                    state = tensor.full_state_dict(model)
                    before.append({k: v.clone() for k, v in state.items()}
                                  if dist.rank() == 0 else None)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                if split:
                    host, share = T.share_batch(raw, out_size)
                    m = T.train_step(model, opt, sched, T.to_device(host, dev), i, SEED, out_size,
                                     on_phase=keep, ddp=loss, share=share)
                else:
                    m = T.train_step(model, opt, sched, T.to_device(
                        {k: v for k, v in raw.items() if k != "rows"}, dev), i, SEED, out_size,
                        on_phase=keep)
                steps.append({k: float(v) for k, v in m.items()})
                torch.cuda.synchronize()
                ms.append((time.perf_counter() - t0) * 1e3)
        res = {"steps": steps, "grads": grads, "step_ms": ms,
               "params": {k: v.cpu() for k, v in tensor.full_state_dict(model).items()},
               "k2": {"mas_calls": counted.calls, "launches": counted.launches}}
        if split:
            res["before"] = before
            res["replicated_grads"] = own
            res["replicated_params"] = {k: v.cpu() for k, v in model.state_dict().items()
                                        if k not in plan.dims}
            res["n_split"] = len(plan.dims)
            res["memory_mb"] = torch.cuda.max_memory_allocated(dev) / 2**20
        del model, opt, loss
        torch.cuda.empty_cache()
        return res

    def plain_from(states) -> dict:
        """The plain step i from the split run's weights before its step
        i (same batch, noise and dropout draws): its metrics, and its
        gradients at step 0."""
        model = train.build_model_from_cfg(cfg).to(dev)
        steps, grads = [], {}

        def keep(phase):
            if phase == "backward" and not grads:
                grads.update({k: p.grad.cpu() for k, p in model.named_parameters()})

        for i, (raw, state) in enumerate(zip(raws, states)):
            model.load_state_dict(state)
            opt, sched = T.make_optimizer(model, lr=lr)
            m = T.train_step(model, opt, sched, T.to_device(
                {k: v for k, v in raw.items() if k != "rows"}, dev), i, SEED, out_size,
                on_phase=keep)
            steps.append({k: float(v) for k, v in m.items()})
        del model
        torch.cuda.empty_cache()
        return {"steps": steps, "grads": grads}

    if spec["plain"]:
        out["plain"] = run(False)
        # the first step in torch's default mode (cuDNN may pick algorithms
        # that sum in another order from run to run) and, on rank 0, with
        # torch's own convolutions in place of cuDNN's: the spreads of
        # plain runs
        torch.use_deterministic_algorithms(False)
        torch.backends.cudnn.deterministic = False
        out["plain_default_mode"] = run(False, 1)
        if dist.rank() == 0:
            torch.backends.cudnn.enabled = False
            out["plain_without_cudnn"] = run(False, 1)
            torch.backends.cudnn.enabled = True
        deterministic()
    out["split"] = run(True)
    states = out["split"].pop("before")
    if dist.rank() == 0:
        out["plain_from_split"] = plain_from(states)
    del states

    def fit(name, max_steps, restore=None):
        torch.manual_seed(SEED)
        trainer = T.Trainer(train.build_model_from_cfg(cfg), train.build_datamodule_from_cfg(cfg),
                            dev, out_size=out_size, lr=lr, max_steps=max_steps,
                            log_every_n_steps=1, output_dir=os.path.join(workdir, name),
                            seed=SEED, save_every_n_epochs=0, loggers={"csv": {}},
                            n_model_axis=spec["n_model"])
        val, validate = {}, trainer.validate

        def record(epoch):
            val[trainer.step] = validate(epoch)
            return val[trainer.step]

        trainer.validate = record
        with CountMas() as c:
            result = trainer.fit(restore_from=restore)
        return {"result": result, "val": val, "step": trainer.step,
                "k2": {"mas_calls": c.calls, "launches": c.launches},
                "params": {k: v.cpu() for k, v in tensor.full_state_dict(trainer.model).items()}}

    if spec["fit"]:
        out["fit"] = fit("fit", 2)
        out["resumed"] = fit("resumed", 3, os.path.join(workdir, "fit", "checkpoints", "last"))
        out["straight"] = fit("straight", 3)
    torch.save(out, os.path.join(workdir, f"tp{local_rank}.pt"))


def _rel(a: dict, b: dict) -> float:
    return max(abs(a[k] - b[k]) / abs(b[k]) for k in b)


def _grad_errs(got: dict, want: dict) -> dict:
    """Each gradient tensor's largest difference over its largest value,
    and that value."""
    return {k: (((got[k] - g).abs().max() / (g.abs().max() + 1e-12)).item(),
                g.abs().max().item()) for k, g in want.items()}


def _grad_err(got: dict, want: dict) -> float:
    return max(e for e, _ in _grad_errs(got, want).values())


def _grads_within(got: dict, want: dict, of_max: float) -> bool:
    """Every gradient tensor within ``of_max`` of its largest value plus
    TP_GRAD_ATOL (the CPU tests' bound)."""
    return all(e * m <= of_max * m + TP_GRAD_ATOL for e, m in _grad_errs(got, want).values())


def _worst(errs: dict, n: int = 5) -> list:
    return sorted(([k, e, m] for k, (e, m) in errs.items()), key=lambda v: -v[1])[:n]


def tensor_parallel(corpus: dict, root: str, smi: str) -> dict:
    """Tensor parallelism at the LJSpeech config's full width, batch 32
    (dropout on), on the synthetic corpus: gloo ranks sharing ``cuda:0``
    (``tp_worker``, spawned in deterministic mode), each step against the
    plain one-process step from the same weights (the split run's,
    gathered before the step) on the same batch and noise:

    * ``n_model = 2`` (2 ranks; the encoder's and the decoder's 2 heads one
      per rank): TP_STEPS steps, their losses and gradient norm within
      TP_RTOL, the first step's gathered gradients within TP_GRAD_OF_MAX
      of each tensor's largest plus TP_GRAD_ATOL, the ranks' replicated
      weights and gradients bit-equal; a 2-step fit with one validation
      (one full-width checkpoint, which the CLI loads), its losses
      against the plain run's, and its resume to step 3 against the
      uninterrupted run, bit for bit;
    * ``n_model = 4`` (4 ranks; half a head per rank, q, k and v
      gathered): one step, likewise.

    A plain run of the same steps from the seed's weights runs on both
    ranks of the first job, in deterministic and in torch's default mode:
    their differences are the run-to-run spreads printed beside the
    bounds (which may be loosened to them, no further). K2 once per step
    and validation batch on every rank. gloo moves every activation sum
    through the host: the step ms is not a multi-card figure."""
    import torch

    from matcha_tpu_torch.cli import load_matcha

    jobs = {}
    t0 = time.perf_counter()
    for n_model, steps, plain, fit in ((2, TP_STEPS, True, True), (4, 1, False, False)):
        workdir = os.path.join(root, f"tp{n_model}")
        os.makedirs(workdir)
        torch.save({"corpus": corpus, "n_model": n_model, "steps": steps, "plain": plain,
                    "fit": fit}, os.path.join(workdir, "in.pt"))
        t1 = time.perf_counter()
        launch_deterministic(tp_worker, (workdir,), n_model, "gloo", workdir, TP_TIMEOUT_S)
        jobs[n_model] = {"seconds": time.perf_counter() - t1, "workdir": workdir, "ranks": [
            torch.load(os.path.join(workdir, f"tp{i}.pt"), weights_only=False)
            for i in range(n_model)]}
    plain = jobs[2]["ranks"][0]["plain"]

    def spread(a, b):
        """Two plain runs' first steps (and their weights after the same
        steps)."""
        errs = _grad_errs(b["grads"], a["grads"])
        out = {"losses_rel_diff_per_step": [_rel(x, y) for x, y in zip(b["steps"], a["steps"])],
               "grads_max_err_of_tensor_max": max(e for e, _ in errs.values()),
               "worst_grads": _worst(errs)}
        if len(a["steps"]) == len(b["steps"]):
            out["weights_max_abs_diff"] = _max_diff(b["params"], a["params"])
        return out

    r0, r1 = jobs[2]["ranks"]
    spreads = {"deterministic": spread(r0["plain"], r1["plain"]),
               "default": spread(r0["plain_default_mode"], r1["plain_default_mode"]),
               "deterministic_vs_default": spread(r0["plain"], r0["plain_default_mode"]),
               "cudnn_vs_without": spread(r0["plain"], r0["plain_without_cudnn"])}
    # the runs start from the same weights: their first steps' difference
    # is the spread the split steps (each from the same weights as its
    # plain step) may be held to
    rtol = max([TP_RTOL] + [v["losses_rel_diff_per_step"][0] for v in spreads.values()])
    grad_tol = max([TP_GRAD_OF_MAX] + [v["grads_max_err_of_tensor_max"]
                                       for v in spreads.values()])
    out = {"mode": DETERMINISTIC_MODE, "nvidia_smi": smi, "rtol": rtol, "grad_of_max": grad_tol,
           "plain_run_to_run_spread": spreads,
           "plain_step_ms": plain["step_ms"], "k2_launches": 0}
    for n_model, job in jobs.items():
        ranks = job["ranks"]
        r0, ref = ranks[0]["split"], ranks[0]["plain_from_split"]
        n = len(r0["steps"])
        row = {"ranks": n_model, "rows": [r["rows"] for r in ranks], "steps": n,
               "split_tensors": r0["n_split"],
               "losses_plain": ref["steps"], "losses_split": r0["steps"],
               "losses_max_rel_diff": max(_rel(r["split"]["steps"][i], ref["steps"][i])
                                          for r in ranks for i in range(n)),
               "losses_rel_diff_per_step": [_rel(r0["steps"][i], ref["steps"][i])
                                            for i in range(n)],
               "losses_rel_diff_to_plain_run_per_step": [_rel(r0["steps"][i], plain["steps"][i])
                                                         for i in range(n)],
               "grads_max_err_of_tensor_max": max(_grad_err(r["split"]["grads"], ref["grads"])
                                                  for r in ranks),
               "grads_within_bound": all(_grads_within(r["split"]["grads"], ref["grads"],
                                                       grad_tol) for r in ranks),
               "worst_grads": _worst(_grad_errs(r0["grads"], ref["grads"])),
               "replicas_bit_equal": all(
                   torch.equal(r["split"][kind][k], r0[kind][k])
                   for r in ranks[1:] for kind in ("replicated_grads", "replicated_params")
                   for k in r0[kind]),
               "gathered_weights_ranks_bit_equal": all(
                   torch.equal(r["split"]["params"][k], r0["params"][k])
                   for r in ranks[1:] for k in r0["params"]),
               "step_ms": [r["split"]["step_ms"] for r in ranks],
               "peak_memory_mb_rank0": r0["memory_mb"],
               "k2_per_rank": [r["split"]["k2"] for r in ranks], "seconds": job["seconds"]}
        if n > 1:
            row["step_ms_p50_steps_2_on_rank0"] = statistics.median(r0["step_ms"][1:])
            row["weights_max_abs_diff_to_plain_run_after"] = _max_diff(r0["params"],
                                                                       plain["params"])
        if not (row["losses_max_rel_diff"] <= rtol and row["grads_within_bound"]
                and row["replicas_bit_equal"]
                and row["gathered_weights_ranks_bit_equal"]):
            raise AssertionError(f"tensor_parallel: n_model={n_model} against the plain step "
                                 f"{ {k: v for k, v in row.items() if k[:7] != 'losses_'} } "
                                 f"losses {row['losses_max_rel_diff']}, bounds {rtol} and "
                                 f"{grad_tol}, spreads {spreads}")
        for r in ranks:
            k2 = r["split"]["k2"]
            if k2["launches"] != k2["mas_calls"] or k2["launches"] != n:
                raise AssertionError(f"tensor_parallel: K2 on rank {r['rank']}: {k2}")
            out["k2_launches"] += k2["launches"]
        out[f"model{n_model}"] = row

    ranks = jobs[2]["ranks"]
    ckpt_dir = os.path.join(jobs[2]["workdir"], "fit", "checkpoints")
    ckpts = sorted(os.listdir(ckpt_dir))
    served = load_matcha(os.path.join(ckpt_dir, "last"), device="cpu")
    fit_rows = read_metrics(os.path.join(jobs[2]["workdir"], "fit"))
    train_rows = [r for r in fit_rows if "loss/train" in r]
    fit = {"checkpoints": ckpts, "val": [r["fit"]["val"] for r in ranks],
           "checkpoint_full_width": all(
               torch.equal(v, ranks[0]["fit"]["params"][k])
               for k, v in served.state_dict().items()),
           "train_losses": [r["loss/train"] for r in train_rows],
           "train_losses_max_rel_diff_to_plain": max(
               abs(r["loss/train"] - plain["steps"][i]["loss"]) / abs(plain["steps"][i]["loss"])
               for i, r in enumerate(train_rows)),
           "resume_bit_equal": all(
               r["resumed"]["result"] == r["straight"]["result"]
               and r["resumed"]["val"][3] == r["straight"]["val"][3]
               and all(torch.equal(r["resumed"]["params"][k], r["straight"]["params"][k])
                       for k in r["straight"]["params"]) for r in ranks),
           "resume_weights_max_abs_diff": max(_max_diff(r["resumed"]["params"],
                                                        r["straight"]["params"]) for r in ranks),
           "k2_per_rank": [{n: r[n]["k2"] for n in ("fit", "resumed", "straight")}
                           for r in ranks]}
    if not (ckpts == ["last", "last.hparams.json"] and fit["checkpoint_full_width"]
            and len(train_rows) == 2 and fit["train_losses_max_rel_diff_to_plain"] <= rtol
            and ranks[0]["fit"]["val"] and ranks[0]["fit"]["val"] == ranks[1]["fit"]["val"]
            and fit["resume_bit_equal"]):
        raise AssertionError(f"tensor_parallel: fit, checkpoint or resume {fit}")
    for r in ranks:
        for name, steps_run in (("fit", 2), ("resumed", 1), ("straight", 3)):
            # one launch per step and per validation batch (one each)
            k2 = r[name]["k2"]
            if (k2["launches"] != k2["mas_calls"]
                    or k2["launches"] != steps_run + len(r[name]["val"])):
                raise AssertionError(f"tensor_parallel: K2 in {name} on rank {r['rank']}: {k2}")
            out["k2_launches"] += k2["launches"]
    out["fit_model2"] = fit
    out["seconds"] = time.perf_counter() - t0
    out["note"] = ("host clock, synchronised, per step on each rank; the ranks are gloo "
                   "processes sharing one card, every activation sum goes through the host: "
                   "not a multi-card figure")
    return out



class K4Shapes:
    """While active, records every (B, C, L) at which the BigVGAN generator
    calls K4's wrapper (``models/bigvgan.py``'s ``aa_snake``)."""

    def __enter__(self):
        from matcha_tpu_torch.models import bigvgan

        self.seen, self._orig = set(), bigvgan.aa_snake

        def recording(x, *args, **kw):
            self.seen.add(tuple(x.shape))
            return self._orig(x, *args, **kw)

        bigvgan.aa_snake = recording
        return self

    def __exit__(self, *exc):
        from matcha_tpu_torch.models import bigvgan

        bigvgan.aa_snake = self._orig

    def check(self, dev, gen) -> list:
        """K4 against its plain version on random input and snake
        parameters at each recorded shape; raises past K4_TOL."""
        import torch

        from matcha_tpu_torch.ops import aa_snake

        rows = []
        h = aa_snake.kaiser_sinc_filter().to(dev)
        for B, C, L in sorted(self.seen):
            x = torch.randn(B, C, L, generator=gen).to(dev)
            freq, inv_mag = aa_snake.snake_terms((0.5 * torch.randn(C, generator=gen)).to(dev),
                                                 (0.5 * torch.randn(C, generator=gen)).to(dev))
            got = aa_snake.aa_snake(x, freq, inv_mag, h)
            want = aa_snake.aa_snake(x, freq, inv_mag, h, fused=False)
            rows.append({"B": B, "C": C, "L": L, "rel_err": (got - want).abs().max().item()
                         / want.abs().max().item()})
            del x, got, want
            if not rows[-1]["rel_err"] <= K4_TOL:
                raise AssertionError(f"K4 disagrees with its plain version at {rows[-1]}")
        return rows


def bigvgan_phase(dev, model) -> dict:
    """BigVGAN-v2 (``models/bigvgan.py``) at its published widths (PyTorch's
    default conv init, snake parameters N(0, 0.5)) as the vocoder of the
    LJSpeech Matcha, no denoiser. The daemon in process (no HTTP): warmed
    at BIGVGAN_WARMUP, a lone request replays a fast-path graph, K4_PER_CALL
    K4 events in its trace; the lone request's waveform against the
    plain generator (``vocoder_pallas=False``) on the same ids and noise.
    The corpus (``synthesise_corpus``, B = 8) split (K4's wrapper
    K4_PER_CALL a batch) and ``--fused-stage`` (K4_PER_CALL events in each
    replay's trace), the two within GRAPH_TOL x 10 of each other. Last, K4
    against its plain version at every (B, C, L) these runs gave it."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile as trace

    from matcha_tpu_torch.pipeline import TTSPipeline
    from matcha_tpu_torch.models.bigvgan import Generator as BigVGAN
    from matcha_tpu_torch.ops import aa_snake
    from matcha_tpu_torch.scripts.trace_settle import TRACE_SETTLE_S, corpus_utterances
    from matcha_tpu_torch.serve import BatchingServer, _parse_warmup

    def k4_events(prof):
        return sum("aa_snake_kernel" in e.name for e in prof.events())

    torch.manual_seed(SEED)
    gen = BigVGAN()
    with torch.no_grad():
        for a in gen.activations():
            a.act.alpha.normal_(0.0, 0.5)
            a.act.beta.normal_(0.0, 0.5)
    gen = gen.to(dev).eval()
    out = {"parameters": sum(p.numel() for p in gen.parameters())}
    with K4Shapes() as shapes:
        pipe = TTSPipeline(model, gen, None, cleaner=CLEANER, device=dev)
        server = BatchingServer(pipe, max_batch=8, n_timesteps=10, temperature=0.667, seed=SEED)
        try:
            t0 = time.perf_counter()
            server.warmup(_parse_warmup(BIGVGAN_WARMUP))
            out["daemon_warmup_s"] = time.perf_counter() - t0
            fast0 = server.n_fast
            with trace(activities=[ProfilerActivity.CUDA]) as prof:
                req = server.submit(SHORT_SENTENCE)
                torch.cuda.synchronize()
                time.sleep(TRACE_SETTLE_S)
            if req.error is not None or server.n_fast != fast0 + 1:
                raise AssertionError(f"bigvgan daemon: {req.error}, fast {server.n_fast - fast0}")
            out["daemon"] = {"fast_path_requests": server.n_fast - fast0,
                             "k4_events": k4_events(prof), "frames": req.n_frames}
        finally:
            server.shutdown()
            pipe.capture_allowed = True
        if out["daemon"]["k4_events"] != K4_PER_CALL:
            raise AssertionError(f"bigvgan daemon: {out['daemon']}")

        utts = corpus_utterances(32, SEED)
        kw = dict(n_timesteps=10, temperature=0.667, length_scale=CORPUS_RATE, batch_size=8)

        def corpus(p, fuse, prof=False):
            g = torch.Generator(dev).manual_seed(SEED)
            if not prof:
                return list(p.synthesise_corpus(utts, fuse_stages=fuse, generator=g, **kw)), None
            with trace(activities=[ProfilerActivity.CUDA]) as t:
                res = list(p.synthesise_corpus(utts, fuse_stages=fuse, generator=g, **kw))
                torch.cuda.synchronize()
                time.sleep(TRACE_SETTLE_S)
            return res, t

        corpus(pipe, True)  # captures every triple's stage graph
        k0 = aa_snake.LAUNCHES["aa_snake"]
        split, _ = corpus(pipe, False)
        k4_split = aa_snake.LAUNCHES["aa_snake"] - k0
        fused, prof = corpus(pipe, True, prof=True)
        plain = TTSPipeline(model, gen, None, cleaner=CLEANER, device=dev, vocoder_pallas=False)
        want, _ = corpus(plain, False)
        err = {"fused": 0.0, "plain": 0.0}
        for (ca, a), (cb, b), (cw, w) in zip(split, fused, want):
            if not (ca == cb == cw and np.array_equal(a["mel_lengths_host"], b["mel_lengths_host"])):
                raise AssertionError("bigvgan corpus: the modes ran other batches")
            err["fused"] = max(err["fused"], (a["waveform"] - b["waveform"]).abs().max().item())
            err["plain"] = max(err["plain"], (a["waveform"] - w["waveform"]).abs().max().item())
        n = len(split)
        out["corpus"] = {"batches": n, "k4_wrapper_split": k4_split,
                         "k4_events_fused": k4_events(prof), "max_abs_err": err}
        if not (k4_split == K4_PER_CALL * n and out["corpus"]["k4_events_fused"] == K4_PER_CALL * n
                and err["fused"] <= 10 * GRAPH_TOL and err["plain"] <= 10 * GRAPH_TOL):
            raise AssertionError(f"bigvgan corpus: {out['corpus']}")
        del split, fused, want
    torch.cuda.empty_cache()
    rows = shapes.check(dev, torch.Generator().manual_seed(SEED))
    out["k4_shapes"] = {"tolerance": K4_TOL, "n": len(rows),
                        "worst_rel_err": max(r["rel_err"] for r in rows), "rows": rows}
    return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from matcha_tpu_torch.cli import process_text
    from matcha_tpu_torch.pipeline import VOC_BUCKETS, Y_BUCKETS, TTSPipeline, pick_bucket
    from matcha_tpu_torch.models.denoiser import compute_bias_spec
    from matcha_tpu_torch.models.hifigan import Generator, HiFiGANConfig
    from matcha_tpu_torch.models.hifigan_fused import MAX_FUSED_CHANNELS, generator_apply_fused
    from matcha_tpu_torch.models.matcha import MatchaTTS
    from matcha_tpu_torch.ops import cuda_build, mrf, mrf_phase
    from matcha_tpu_torch.scripts.profile_latency import SENTENCES, request_latency, stage_split

    time_captures()
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
    names = ("mrf_stage", "mas", "mrf_phase", "aa_snake")
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
    emit({"phase": "k2_check", "rule": "torch.equal to the plain version, and to "
          "maximum_path_numpy (the host search) where every row has 1 <= t_x <= t_y "
          "(equal_host null elsewhere)", "host_checked": sum(
              c["equal_host"] is True for c in k2_cases), "cases": k2_cases})

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
    t0 = time.perf_counter()
    corpus = staged_corpus(dev, model, vocoder, bias)
    emit({"phase": "staged_corpus", **corpus, "seconds": time.perf_counter() - t0})
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    served = serve_phase(dev, model, vocoder, bias)
    emit({"phase": "serve", **served, "seconds": time.perf_counter() - t0})
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    precision = precision_phase(dev, model, vocoder, bias, texts[1], fused["integer_bucket"],
                                shapes)
    emit({"phase": "precision", **precision, "seconds": time.perf_counter() - t0})
    torch.cuda.empty_cache()
    # the multi-speaker and conformer models' serving paths (their training
    # steps run with the training phases; each emits one line there)
    t0 = time.perf_counter()
    ms_serving = multispeaker_serving(dev, vocoder, bias, texts)
    ms_serving_s = time.perf_counter() - t0
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    conf_serving = conformer_serving(dev, vocoder, bias, texts[1])
    conf_serving_s = time.perf_counter() - t0
    torch.cuda.empty_cache()
    # data-parallel serving (its training half runs with the training phases)
    t0 = time.perf_counter()
    dp_serve = dp_serving(dev, model, vocoder, bias)
    dp_serve_s = time.perf_counter() - t0
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    emit({"phase": "bigvgan", **bigvgan_phase(dev, model), "seconds": time.perf_counter() - t0})
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
        t0 = time.perf_counter()
        bf16 = train_bf16(dev, cfg, trained["corpus"], root)
        emit({"phase": "train_bf16", **bf16, "seconds": time.perf_counter() - t0})
        t0 = time.perf_counter()
        ms_train = multispeaker_train(root)
        emit({"phase": "multispeaker", **ms_serving, "train": ms_train,
              "seconds": ms_serving_s + time.perf_counter() - t0})
        t0 = time.perf_counter()
        conf_train = conformer_train(dev, raw)
        emit({"phase": "conformer", **conf_serving, "train": conf_train,
              "seconds": conf_serving_s + time.perf_counter() - t0})
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        extras = train_extras(dev, trained["corpus"], root, cfg)
        emit({"phase": "train_extras", "nvidia_smi": smi, **extras,
              "seconds": time.perf_counter() - t0})
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        voc_train = vocoder_train_phase(dev, trained["corpus"], root)
        voc_train["gpu_vs_cpu"] = vocoder_gpu_vs_cpu(dev, trained["corpus"]["train"])
        emit({"phase": "vocoder_train", "nvidia_smi": smi, **voc_train,
              "seconds": time.perf_counter() - t0})
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        deploy = deploy_eval_phase(dev, trained["corpus"], root,
                                   os.path.join(trained["out_dir"], "checkpoints", "last"))
        emit({"phase": "deploy_eval", "nvidia_smi": smi, **deploy,
              "seconds": time.perf_counter() - t0})
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        dp_train = dp_training(trained["corpus"], root)
        emit({"phase": "data_parallel", "nvidia_smi": smi, "serving": dp_serve,
              "training": dp_train, "seconds": dp_serve_s + time.perf_counter() - t0})
        torch.cuda.empty_cache()
        tp = tensor_parallel(trained["corpus"], root, smi)
        emit({"phase": "tensor_parallel", **tp})

    # 7. kernels: K1's and K3's ms, plain_ms, bound_ms, library_ms summed
    # over the two narrow stages of one vocoder call at the serving path's
    # shape; K2's at the training step's shape
    path = [s for s in stages if s["shape"] == "main_path"]
    k3_path = [s for s in k3_rows if s["shape"] == "main_path"]
    bf16_path = [r for r in precision["k1_bf16"] if r["shape"] == "main_path"]
    emit({"kernels": [
        {"name": "mrf_stage", "route": "cuda", "status": "ported",
         "engine": "tensor cores: 3xTF32 wgmma m64nCk8 (A from registers, B from a shared "
                   "weight ring), f32 sums",
         "source": "matcha_tpu_torch/csrc/mrf_stage.cu",
         "replaces": "matcha_tpu/ops/mrf_pallas.py:121",
         "launches": launches,
         "fused_path_launches_per_replay": fused["k1_launches_per_replay"],
         "staged_corpus_launches": {m: r["k1_launches"] for m, r in corpus["modes"].items()},
         "serve_launches": served["k1_launches"],
         "multispeaker_launches": ms_serving["k1_launches"],
         "conformer_launches": {m: r["k1_launches"] for m, r in conf_serving["modes"].items()},
         "deploy_eval_launches": {
             **{f"cli_{m}": deploy["cli"][m]["k1_launches"]
                for m in ("registry", "native", "native_as_ckpt")},
             "app_request": deploy["app"]["k1_launches"],
             "app_load": deploy["app"]["load_k1_launches"]},
         "data_parallel_launches": {
             "dynamic_two_replicas": dp_serve["dynamic"]["k1_launches"],
             "fixed_bucket_replays": dp_serve["fixed_bucket"]["k1_launches_in_replays"],
             "corpus_fused_stage_replays":
                 dp_serve["corpus_fused_stage"]["k1_launches_in_replays"]},
         "max_abs_err": max([worst] + [s["max_abs_err"] for s in stages]
                            + [r["max_abs_err"]
                               for r in corpus["k1_shapes"] + served["k1_shapes"]
                               + precision["k1_shapes"] + ms_serving["k1_shapes"]
                               + conf_serving["k1_shapes"] + deploy["k1_shapes"]
                               + dp_serve["k1_shapes"]
                               if r["compute_dtype"] == "float32"]),
         "ms": sum(s["ms"] for s in path),
         "plain_ms": sum(s["plain_ms"] for s in path),
         "bound_ms": sum(s["bound_ms"] for s in path),
         "bound_by": ("operations" if all(s["bound_by"] == "operations" for s in path)
                      else "bytes"),
         "bound_tc_ms": sum(s["bound_tc_ms"] for s in path),
         "library_ms": sum(s["library_ms"] for s in path)},
        {"name": "mrf_stage_bf16", "route": "cuda", "status": "ported",
         "path": "generator_apply_fused(compute_dtype=bfloat16): the stage profiler's "
                 "--mrf-dtype bfloat16 (the Pallas kernel's compute_dtype)",
         "engine": "tensor cores: bf16 wgmma m64nCk16, f32 sums",
         "source": "matcha_tpu_torch/csrc/mrf_stage.cu",
         "replaces": "matcha_tpu/ops/mrf_pallas.py:121",
         "launches": precision["k1_bf16_launches"],
         "max_abs_err": max(r["max_abs_err"] for r in precision["k1_bf16"]
                            + [r for r in precision["k1_shapes"]
                               if r["compute_dtype"] == "bfloat16"]),
         "mean_abs_err": max(r["mean_abs_err"] for r in precision["k1_bf16"]),
         "ms": sum(r["ms"] for r in bf16_path),
         "tf32x3_ms": sum(r["tf32x3_ms"] for r in bf16_path),
         "plain_ms": sum(r["plain_ms"] for r in bf16_path),
         "bound_ms": sum(r["bound_ms"] for r in bf16_path),
         "bound_by": ("operations" if all(r["bound_by"] == "operations" for r in bf16_path)
                      else "bytes"),
         "library_ms": sum(r["library_ms"] for r in bf16_path)},
        {"name": "maximum_path", "route": "cuda", "status": "ported", "path": "training",
         "source": "matcha_tpu_torch/csrc/mas.cu",
         "replaces": "matcha_tpu/ops/mas_pallas.py:69",
         "engine": "one chain warp per batch row, cp.async log-prior tiles, per-lane bit words",
         "launches": trained["run"]["k2_launches"],
         "train_bf16_launches": bf16["run"]["k2_launches"],
         "multispeaker_launches": {p: ms_train[p]["run"]["k2_launches"]
                                   for p in ("f32", "bf16-mixed")},
         "conformer_launches": {m: r["k2_launches"] for m, r in conf_train.items()},
         "train_extras_launches": extras["run"]["k2_launches"],
         "eval_launches": deploy["eval"]["k2_launches"],
         "sweep_launches": deploy["sweep"]["k2_launches"],
         "ddp_launches": {
             "nccl_world1": dp_train["nccl_world1"]["k2_launches"],
             "gloo_per_rank": dp_train["gloo_two_ranks_cuda0"]["k2_per_rank"]},
         "tensor_parallel_launches": tp["k2_launches"],
         "bf16_log_prior": {k: bf16["k2"][k] for k in ("shape", "adjacent_ties", "equal", "ms")},
         "max_abs_err": 0.0, "ms": k2["ms"],
         "kernel_ms": k2["kernel_ms"], "wrapper_ms": k2["wrapper_ms"], "layout": k2["layout"],
         "plain_ms": k2["plain_ms"], "bound_ms": k2["bound_ms"], "bound_by": k2["bound_by"],
         "library_ms": None},
        {"name": "mrf_stage_phase", "route": "cuda", "status": "ported",
         "path": "vocoder variants, narrow_impl='phase'",
         "engine": "tensor cores: K1's 3xTF32 wgmma pass, f32 sums",
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
