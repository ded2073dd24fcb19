"""Anti-aliased SnakeBeta (BigVGAN's ``Activation1d``): the CUDA kernel's
wrapper and its plain version.

On x (B, C, L) f32, per channel c:

- Up: x replicate-padded by ``PAD`` = 5 samples a side, ``2 *
  conv_transpose1d`` with the 12-tap filter h at stride 2, depthwise, and
  ``UP_CROP`` = 15 samples cut from each end: u, 2L samples;
- SnakeBeta: v = u + inv_mag[c] * sin(u * freq[c])^2, with freq = e^alpha
  and inv_mag = 1 / (e^beta + 1e-9) for the log-scale parameters
  (``snake_terms``, computed once per loaded module);
- Down: v replicate-padded by 5 samples on the left and 6 on the right,
  ``conv1d`` with h at stride 2, depthwise: y, L samples.

h is one Kaiser-windowed sinc (``kaiser_sinc_filter``: cutoff 0.25,
half-width 0.3, 12 taps), as BigVGAN's ``alias_free_activation/torch/``
builds it for both resamplers.

``aa_snake`` takes x in either layout and returns y channels-last: (B, C,
L) seen through (B, L, C) storage, strides (L C, 1, C), the layout cuDNN's
NHWC convs read and write, in which BigVGAN's generator keeps every
activation. On a CUDA tensor it launches K4 (``csrc/aa_snake.cu``): one
launch computes the whole activation, reading x once and writing y once;
a thread slides a window over a run of time steps of 2 channels in
registers (``plan`` picks the run). A channels-first x is first copied to
channels-last, which ``LAUNCHES["aa_snake_relayout"]`` counts: 0 over any
BigVGAN call. K4 replaces no TPU kernel: the JAX package has no BigVGAN.
On a CPU tensor, or with ``fused=False``, it runs the plain sequence
(``aa_snake_reference``), which is what BigVGAN's own torch code runs and
gives the same values on either layout.
"""

import ctypes
import functools
import math

import torch
import torch.nn.functional as F

from matcha_tpu_torch.ops import cuda_build

#: launches of K4 in this process (the plain path does not count), and the
#: channels-first inputs it copied to channels-last first
LAUNCHES = {"aa_snake": 0, "aa_snake_relayout": 0}
TAPS = 12
RATIO = 2
PAD = TAPS // RATIO - 1  # Up's replicate padding of x, each side
UP_CROP = PAD * RATIO + (TAPS - RATIO) // 2  # samples cut from each end after Up
DOWN_PAD = (TAPS // 2 - 1, TAPS // 2)  # Down's replicate padding of v, left and right
#: added to e^beta before the division, as BigVGAN's SnakeBeta does
NO_DIV_BY_ZERO = 1e-9
#: outputs a K4 thread computes per step of its run (csrc/aa_snake.cu ``R``)
STEP = 4
#: K4's threads per block (csrc/aa_snake.cu ``THREADS``)
THREADS = 128
#: the run lengths ``plan`` chooses from, longest first (multiples of STEP;
#: on an H100 runs of 256 and of 8 were slower at every published stage)
RUNS = (128, 64, 32, 16)
#: the threads per SM ``plan`` asks for before it takes a shorter run (512
#: beat 256, 1024 and 2048 over the published stages on an H100)
TASKS_PER_SM = 512


def kaiser_sinc_filter(cutoff: float = 0.5 / RATIO, half_width: float = 0.6 / RATIO,
                       kernel_size: int = TAPS) -> torch.Tensor:
    """BigVGAN's ``kaiser_sinc_filter1d`` for an even ``kernel_size``: a
    Kaiser-windowed sinc normalised to sum 1, (1, 1, kernel_size) f32,
    computed on the CPU whatever the default device."""
    half = kernel_size // 2
    A = 2.285 * (half - 1) * math.pi * (4 * half_width) + 7.95
    if A > 50.0:
        beta = 0.1102 * (A - 8.7)
    elif A >= 21.0:
        beta = 0.5842 * (A - 21) ** 0.4 + 0.07886 * (A - 21.0)
    else:
        beta = 0.0
    window = torch.kaiser_window(kernel_size, beta=beta, periodic=False, device="cpu")
    time = torch.arange(-half, half, device="cpu") + 0.5
    h = 2 * cutoff * window * torch.sinc(2 * cutoff * time)
    h /= h.sum()
    return h.view(1, 1, kernel_size)


def snake_terms(alpha: torch.Tensor, beta: torch.Tensor):
    """(freq, inv_mag), each (C,) f32 contiguous: e^alpha and 1 / (e^beta +
    1e-9) for the log-scale parameters."""
    freq = torch.exp(alpha.detach().float()).contiguous()
    inv_mag = (1.0 / (torch.exp(beta.detach().float()) + NO_DIV_BY_ZERO)).contiguous()
    return freq, inv_mag


def aa_snake_reference(x: torch.Tensor, freq: torch.Tensor, inv_mag: torch.Tensor,
                       h_up: torch.Tensor, h_down: torch.Tensor) -> torch.Tensor:
    """The plain sequence, in BigVGAN's own order of operations."""
    C = x.shape[1]
    u = F.pad(x, (PAD, PAD), mode="replicate")
    u = RATIO * F.conv_transpose1d(u, h_up.expand(C, -1, -1), stride=RATIO, groups=C)
    u = u[..., UP_CROP:-UP_CROP]
    v = u + inv_mag[None, :, None] * torch.pow(torch.sin(u * freq[None, :, None]), 2)
    v = F.pad(v, DOWN_PAD, mode="replicate")
    return F.conv1d(v, h_down.expand(C, -1, -1), stride=RATIO, groups=C)


def is_channels_last(t: torch.Tensor) -> bool:
    """Whether (N, C, L) ``t`` lies as (N, L, C) contiguous: strides (L C,
    1, C), up to the strides of dimensions of size 1."""
    return t.transpose(1, 2).is_contiguous()


def channels_last(t: torch.Tensor) -> torch.Tensor:
    """(N, C, L) ``t`` with the same values, channels-last: a view of ``t``
    when it already is, else a copy."""
    return t.transpose(1, 2).contiguous().transpose(1, 2)


def needs_relayout(x: torch.Tensor) -> bool:
    """K4's rule, from the strides alone: False for a channels-last x, True
    for a channels-first contiguous one (the wrapper copies it to
    channels-last first); raises on any other layout."""
    if is_channels_last(x):
        return False
    if x.is_contiguous():
        return True
    raise ValueError(f"aa_snake takes a (B, C, L) tensor channels-last or channels-first "
                     f"contiguous, not strides {x.stride()}")


def vector_width(C: int, address: int) -> int:
    """The channels a K4 thread owns: 2 (8-byte loads and stores) where C is
    even and x's address keeps every pair aligned, else 1."""
    return 2 if C % 2 == 0 and address % 8 == 0 else 1


def plan(B: int, C: int, L: int, V: int, sms: int) -> tuple:
    """K4's work split: (run, runs a row, threads). A thread owns V
    channels of one run of ``run`` outputs of one row; ``run`` is the
    longest of RUNS that still gives TASKS_PER_SM threads to each of the
    card's ``sms`` SMs (the shortest when none does)."""
    for run in RUNS:
        runs_per_row = -(-L // run)
        n_tasks = C // V * B * runs_per_row
        if n_tasks >= TASKS_PER_SM * sms:
            break
    return run, runs_per_row, n_tasks


@functools.cache
def _sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


@functools.cache
def _library():
    lib = cuda_build.load("aa_snake")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.aa_snake_launch.argtypes = [p, p, p, p, p, p, i, i, i, i, i, p]
    lib.aa_snake_launch.restype = ctypes.c_int
    lib.aa_snake_error_string.argtypes = [ctypes.c_int]
    lib.aa_snake_error_string.restype = ctypes.c_char_p
    return lib


def _check(x, freq, inv_mag, h_up, h_down) -> None:
    if x.dtype != torch.float32 or x.dim() != 3:
        raise ValueError("aa_snake takes a (B, C, L) float32 tensor")
    B, C, L = x.shape
    if L < 1:
        raise ValueError("aa_snake needs at least one sample")
    for name, t, n in (("freq", freq, C), ("inv_mag", inv_mag, C), ("h_up", h_up, TAPS),
                       ("h_down", h_down, TAPS)):
        if (t.numel() != n or t.dtype != torch.float32 or t.device != x.device
                or not t.is_contiguous()):
            raise ValueError(f"{name}: {tuple(t.shape)} {t.dtype} {t.device}, expected {n} "
                             f"contiguous float32 values on {x.device}")


def _launch(x, freq, inv_mag, h_up, h_down) -> torch.Tensor:
    _check(x, freq, inv_mag, h_up, h_down)
    if needs_relayout(x):
        x = channels_last(x)
        LAUNCHES["aa_snake_relayout"] += 1
    B, C, L = x.shape
    y = torch.empty((B, L, C), dtype=x.dtype, device=x.device).transpose(1, 2)
    V = vector_width(C, x.data_ptr())
    run, _, _ = plan(B, C, L, V, _sms(x.device.index))
    lib = _library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.aa_snake_launch(x.data_ptr(), y.data_ptr(), freq.data_ptr(),
                                  inv_mag.data_ptr(), h_up.data_ptr(), h_down.data_ptr(),
                                  B, C, L, V, run, stream)
    if err != 0:
        raise RuntimeError(f"aa_snake launch failed: {lib.aa_snake_error_string(err).decode()}")
    LAUNCHES["aa_snake"] += 1
    return y


def aa_snake(x: torch.Tensor, freq: torch.Tensor, inv_mag: torch.Tensor, h_up: torch.Tensor,
             h_down: torch.Tensor = None, fused: bool = True) -> torch.Tensor:
    """One anti-aliased SnakeBeta, (B, C, L) f32 in either layout -> (B, C,
    L) f32 channels-last. ``freq``, ``inv_mag``: the snake's per-channel
    terms (``snake_terms``); ``h_up``, ``h_down``: the 12-tap filters (Up's
    and Down's buffers; Down takes Up's when None). A CUDA tensor runs K4,
    unless ``fused`` is False; a CPU tensor runs the plain sequence."""
    h_down = h_up if h_down is None else h_down
    if x.device.type == "cpu" or not fused:
        return channels_last(aa_snake_reference(x, freq, inv_mag, h_up, h_down))
    if x.device.type != "cuda":
        raise ValueError(f"aa_snake runs on CUDA or CPU tensors, not {x.device}")
    return _launch(x, freq, inv_mag, h_up, h_down)
