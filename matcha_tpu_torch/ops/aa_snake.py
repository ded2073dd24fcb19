"""Anti-aliased SnakeBeta (BigVGAN's ``Activation1d``): the CUDA kernel's
wrapper and its plain version.

On x (B, C, L) f32, channels first, per channel c:

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

``aa_snake`` on a CUDA tensor launches K4 (``csrc/aa_snake.cu``): one
launch computes the whole activation, reading x once and writing y once;
the 2x-rate signal stays in shared memory. It replaces no TPU kernel: the
JAX package has no BigVGAN. On a CPU tensor, or with ``fused=False``, it
runs the plain sequence (``aa_snake_reference``), which is what BigVGAN's
own torch code runs.
"""

import ctypes
import functools
import math

import torch
import torch.nn.functional as F

from matcha_tpu_torch.ops import cuda_build

#: launches of K4 in this process (the plain path does not count)
LAUNCHES = {"aa_snake": 0}
TAPS = 12
RATIO = 2
PAD = TAPS // RATIO - 1  # Up's replicate padding of x, each side
UP_CROP = PAD * RATIO + (TAPS - RATIO) // 2  # samples cut from each end after Up
DOWN_PAD = (TAPS // 2 - 1, TAPS // 2)  # Down's replicate padding of v, left and right
#: added to e^beta before the division, as BigVGAN's SnakeBeta does
NO_DIV_BY_ZERO = 1e-9
#: the kernel's output samples per block (csrc/aa_snake.cu ``TQ``)
TILE = 1024


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


@functools.cache
def _library():
    lib = cuda_build.load("aa_snake")
    p = ctypes.c_void_p
    lib.aa_snake_launch.argtypes = [p, p, p, p, p, p, ctypes.c_longlong, ctypes.c_int,
                                    ctypes.c_int, p]
    lib.aa_snake_launch.restype = ctypes.c_int
    lib.aa_snake_error_string.argtypes = [ctypes.c_int]
    lib.aa_snake_error_string.restype = ctypes.c_char_p
    return lib


def _check(x, freq, inv_mag, h_up, h_down) -> None:
    if x.dtype != torch.float32 or x.dim() != 3 or not x.is_contiguous():
        raise ValueError("aa_snake takes a contiguous (B, C, L) float32 tensor")
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
    B, C, L = x.shape
    y = torch.empty_like(x)
    lib = _library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.aa_snake_launch(x.data_ptr(), y.data_ptr(), freq.data_ptr(),
                                  inv_mag.data_ptr(), h_up.data_ptr(), h_down.data_ptr(),
                                  B * C, C, L, stream)
    if err != 0:
        raise RuntimeError(f"aa_snake launch failed: {lib.aa_snake_error_string(err).decode()}")
    LAUNCHES["aa_snake"] += 1
    return y


def aa_snake(x: torch.Tensor, freq: torch.Tensor, inv_mag: torch.Tensor, h_up: torch.Tensor,
             h_down: torch.Tensor = None, fused: bool = True) -> torch.Tensor:
    """One anti-aliased SnakeBeta, (B, C, L) f32 -> (B, C, L) f32.
    ``freq``, ``inv_mag``: the snake's per-channel terms (``snake_terms``);
    ``h_up``, ``h_down``: the 12-tap filters (Up's and Down's buffers; Down
    takes Up's when None). A CUDA tensor runs K4, unless ``fused`` is
    False; a CPU tensor runs the plain sequence."""
    h_down = h_up if h_down is None else h_down
    if x.device.type == "cpu" or not fused:
        return aa_snake_reference(x, freq, inv_mag, h_up, h_down)
    if x.device.type != "cuda":
        raise ValueError(f"aa_snake runs on CUDA or CPU tensors, not {x.device}")
    return _launch(x, freq, inv_mag, h_up, h_down)
