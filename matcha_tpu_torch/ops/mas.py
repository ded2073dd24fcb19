"""Monotonic Alignment Search: the CUDA kernel's wrapper and its plain version.

``maximum_path(value, mask)`` is the port of ``matcha_tpu/ops/mas.py``
(and of the Pallas kernel ``matcha_tpu/ops/mas_pallas.py``) with the same
contract: value and mask (B, T_x, T_y), the per-row lengths read off the
mask, a 0/1 path (B, T_x, T_y) in the mask's dtype. A CUDA tensor
launches the kernel in ``csrc/mas.cu`` (or raises); a CPU tensor takes
``maximum_path_reference``. Both are bit-identical to the JAX package's
``scan`` and Pallas paths, ties included: they add, max and compare the
same f32 values in the same order.

No gradient flows through the search; its inputs are detached.

``maximum_path_numpy(value, mask)`` is the port of
``matcha_tpu/ops/mas_cpp.py``: numpy in and out, through the repo's
C++/OpenMP ``native/mas/mas.cpp`` (``maximum_path_c``), which is built
with ``g++`` at first use into ``build/matcha_tpu_torch/``
(``cuda_build.build_host_library``; never next to its source) and bound
with ``ctypes``. It is the host path of offline tools and a third oracle
for the kernel.
"""

import ctypes
import functools
import threading
from pathlib import Path

import numpy as np
import torch

from matcha_tpu_torch.ops import cuda_build

#: launches of the CUDA kernel in this process (the CPU path does not count)
LAUNCHES = {"maximum_path": 0}

MAX_NEG_VAL = -1e9
# The kernel's geometry (csrc/mas.cu); mas_layout must agree with it.
CPL_INSTANCES = (1, 2, 3, 4, 6, 8, 10, 12, 16, 24, 32, 48, 64, 96, 128)  # cells per lane
MAX_T_X = 32 * CPL_INSTANCES[-1]
MAX_TILE_ROWS = 64
MAX_SMEM = 232448  # bytes, the most one block may take
BT_ROWS = 32  # bit rows per backtrack run


def mas_layout(T_x: int, T_y: int) -> tuple:
    """The kernel's instance for (T_x, T_y): ``(cpl, chain_warps,
    tile_rows, smem_bytes)``. One chain warp whose lanes hold ``cpl``
    cells each (the smallest instance with 32 * cpl >= T_x); tiles of
    ``tile_rows`` mel frames, two of which (rows padded by 4 floats for
    the float4 reads up to cpl = 16, else by 1) fit the block's shared
    memory, as do the backtrack's two runs of bit rows."""
    if T_x > MAX_T_X:
        raise ValueError(f"T_x={T_x}: the MAS kernel takes at most {MAX_T_X} text positions")
    cpl = next(c for c in CPL_INSTANCES if 32 * c >= T_x)
    pad, step = (4, 8) if cpl <= 16 else (1, 2)
    fit = (MAX_SMEM // (2 * 32 * cpl * 4) - pad) // step * step
    rows = min(fit, MAX_TILE_ROWS, -(-T_y // 8) * 8)
    smem = max(2 * 32 * cpl * (rows + pad) * 4, 2 * BT_ROWS * 32 * _words_per_lane(cpl) * 4)
    return cpl, 1, rows, smem


def _words_per_lane(cpl: int) -> int:
    return -(-cpl // 32)


def _lengths(mask_f: torch.Tensor):
    t_xs = mask_f[:, :, 0].sum(dim=1).to(torch.int32)
    t_ys = mask_f[:, 0, :].sum(dim=1).to(torch.int32)
    return t_xs, t_ys


def maximum_path_reference(value: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Plain version: the banded Viterbi forward, one row of y at a time
    over all B and x at once, keeping every row, then the backtrack from
    ``index = t_x - 1``. The port of ``matcha_tpu/ops/mas_ref.py``."""
    value, mask = value.detach(), mask.detach()
    B, T_x, T_y = value.shape
    dev = value.device
    mask_f = mask.to(torch.float32)
    lp = value.to(torch.float32) * mask_f
    t_xs, t_ys = _lengths(mask_f)
    xs = torch.arange(T_x, dtype=torch.int32, device=dev)[None, :]
    t_x, t_y = t_xs[:, None], t_ys[:, None]

    neg = torch.full((B, 1), MAX_NEG_VAL, dtype=torch.float32, device=dev)
    first = torch.zeros((B, 1), dtype=torch.float32, device=dev)
    prev = torch.full((B, T_x), MAX_NEG_VAL, dtype=torch.float32, device=dev)
    rows = []
    for y in range(T_y):
        shifted = torch.cat([first if y == 0 else neg, prev[:, :-1]], dim=1)
        new = torch.maximum(prev, shifted) + lp[:, :, y]
        in_band = (xs <= y) & (xs >= t_x + y - t_y) & (xs < t_x) & (y < t_y)
        prev = torch.where(in_band, new, neg)
        rows.append(prev)

    path = torch.zeros((B, T_x, T_y), dtype=torch.float32, device=dev)
    batch = torch.arange(B, device=dev)
    index = (t_xs - 1).long()
    for y in range(T_y - 1, -1, -1):
        active = y < t_ys
        hit = active & (index >= 0)
        path[batch[hit], index[hit], y] = 1.0
        if y == 0:
            break
        row = rows[y - 1]
        v_idx = row.gather(1, index.clamp(min=0)[:, None])[:, 0]
        v_im1 = row.gather(1, (index - 1).clamp(min=0)[:, None])[:, 0]
        move = (index != 0) & ((index == y) | (v_idx < v_im1)) & active
        index = index - move.long()
    return (path * mask_f).to(mask.dtype)


@functools.cache
def _library():
    lib = cuda_build.load("mas")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.mas_launch.argtypes = [p, p, p, p, p, i, i, i, i, i, p]
    lib.mas_launch.restype = ctypes.c_int
    lib.mas_smem_bytes.argtypes = [i, i]
    lib.mas_smem_bytes.restype = ctypes.c_int
    lib.mas_error_string.argtypes = [ctypes.c_int]
    lib.mas_error_string.restype = ctypes.c_char_p
    return lib


def _launch(value: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    if value.dim() != 3 or value.shape != mask.shape:
        raise ValueError(f"maximum_path takes value and mask of one (B, T_x, T_y) shape, "
                         f"got {tuple(value.shape)} and {tuple(mask.shape)}")
    if value.device != mask.device:
        raise ValueError(f"value on {value.device}, mask on {mask.device}")
    B, T_x, T_y = value.shape
    cpl, _, tile_rows, _ = mas_layout(T_x, T_y)
    if B == 0 or T_x == 0 or T_y == 0:
        return torch.zeros_like(mask)
    mask_f = mask.detach().to(torch.float32)
    lp = (value.detach().to(torch.float32) * mask_f).contiguous()
    t_xs, t_ys = _lengths(mask_f)
    bits = torch.empty((B, T_y, 32 * _words_per_lane(cpl)), dtype=torch.int32,
                       device=value.device)
    path = torch.zeros((B, T_x, T_y), dtype=torch.float32, device=value.device)
    lib = _library()
    with torch.cuda.device(value.device):
        stream = torch.cuda.current_stream(value.device).cuda_stream
        err = lib.mas_launch(lp.data_ptr(), t_xs.data_ptr(), t_ys.data_ptr(), bits.data_ptr(),
                             path.data_ptr(), B, T_x, T_y, cpl, tile_rows, stream)
    if err != 0:
        raise RuntimeError(f"maximum_path launch failed: {lib.mas_error_string(err).decode()} "
                           f"(B={B}, T_x={T_x}, T_y={T_y}, {cpl} cells per lane, "
                           f"tiles of {tile_rows} rows)")
    LAUNCHES["maximum_path"] += 1
    return (path * mask_f).to(mask.dtype)


def maximum_path(value: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """The most likely monotonic alignment, (B, T_x, T_y) 0/1 in the
    mask's dtype. CUDA tensors run the hand-written kernel; CPU tensors
    the plain version."""
    if value.device.type == "cpu":
        return maximum_path_reference(value, mask)
    if value.device.type != "cuda":
        raise ValueError(f"maximum_path runs on CUDA or CPU tensors, not {value.device}")
    return _launch(value, mask)


HOST_SOURCE = Path(__file__).resolve().parents[2] / "native" / "mas" / "mas.cpp"
_host_lock = threading.Lock()
_host_lib = None


def host_library_path() -> Path:
    return cuda_build.host_library_path(HOST_SOURCE, "libmas", cuda_build.BUILD_DIR)


def _host_library() -> ctypes.CDLL:
    """``native/mas/mas.cpp``'s library, compiled first if it is not built
    yet (raises when ``g++`` is missing or fails)."""
    global _host_lib
    with _host_lock:
        if _host_lib is None:
            lib = ctypes.CDLL(str(cuda_build.build_host_library(HOST_SOURCE, host_library_path())))
            i32, f32 = ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_float)
            lib.maximum_path_c.argtypes = [i32, f32, i32, i32, ctypes.c_int32, ctypes.c_int64,
                                           ctypes.c_int64]
            lib.maximum_path_c.restype = None
            _host_lib = lib
    return _host_lib


def maximum_path_numpy(value: np.ndarray, mask: np.ndarray) -> np.ndarray:
    """MAS on the host: value and mask (B, T_x, T_y) numpy arrays -> the
    0/1 path (B, T_x, T_y) float32. ``value * mask`` in f32, the lengths
    read off the mask's first column and first row, an int32 path from
    the C++ search, returned as f32 times the mask (JAX's
    ``maximum_path_cpp``)."""
    lib = _host_library()
    mask_f = np.asarray(mask, dtype=np.float32)
    value = np.ascontiguousarray(np.asarray(value, dtype=np.float32) * mask_f)
    B, T_x, T_y = value.shape
    paths = np.zeros((B, T_x, T_y), dtype=np.int32)
    t_xs = np.ascontiguousarray(mask_f[:, :, 0].sum(axis=1).astype(np.int32))
    t_ys = np.ascontiguousarray(mask_f[:, 0, :].sum(axis=1).astype(np.int32))
    i32, f32 = ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_float)
    lib.maximum_path_c(paths.ctypes.data_as(i32), value.ctypes.data_as(f32),
                       t_xs.ctypes.data_as(i32), t_ys.ctypes.data_as(i32), B, T_x, T_y)
    return paths.astype(np.float32) * mask_f
