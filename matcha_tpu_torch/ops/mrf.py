"""Fused HiFi-GAN MRF stage: the CUDA kernel's wrapper and its plain version.

``fused_mrf_stage`` is the port of
``matcha_tpu/ops/mrf_pallas.py::fused_mrf_stage`` with the same layouts:
x (B, C, T) f32 channels-first; ``weights`` a flat tuple with, per
ResBlock1 chain, W1 (n_dil, k, C_in, C_out), B1 (n_dil, C_out), W2, B2.
A CUDA tensor launches the kernel in ``csrc/mrf_stage.cu`` (or raises): the
18 convs of the stage as 3xTF32 tensor-core products with f32 accuracy. A
CPU tensor takes ``fused_mrf_stage_reference``.

The kernel reads all of a stage's weights from one buffer. ``pack_mrf_weights``
copies the tuple into it once, when a model is loaded, and returns the tuple
as views of that buffer; the kernel takes only weights packed so. It takes
every multiple of 16 channels up to 128; above C = 80 its conv-1 buffer
moves from shared memory to a global scratch the wrapper allocates.
"""

import ctypes
import functools
from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from matcha_tpu_torch.ops import cuda_build

#: launches of the CUDA kernel in this process (the CPU path does not count)
LAUNCHES = {"mrf_stage": 0}

HALO = 64  # halo per side in the kernel; >= the stage's receptive field
MARGIN = 32  # zero rows per buffer side; >= the widest tap reach c0 * d
MAX_BLOCKS = MAX_DIL = 4
KERNEL_SIZES = (3, 7, 11)  # the kernel's compiled tap counts (HiFi-GAN v1, v2)
MAX_THREADS = 384
MAX_CHANNELS = 128
SMEM_LIMIT = 232_448  # bytes of shared memory a Hopper block may use
# the geometry of K1 (csrc/mrf_stage.cu), which K3 (csrc/mrf_phase.cu) shares
TILE_STEP = 16  # t_tile granularity: one m16 tile of time rows
BAND = 32  # time rows of one warp's work item: two m16 tiles
TAIL = BAND - TILE_STEP  # rows after a buffer's last margin: the last band's reach
MIN_TILE = 64  # the smallest tile pick_t_tile chooses: below it K1 got no faster on an H100
SMS = 132  # streaming multiprocessors of an H100 SXM


def receptive_field(kernel_sizes, dilations) -> int:
    """Samples one side of the stage reaches: per chain, sum over its
    dilations of c0 * d (conv 1) + c0 (conv 2), c0 = (k - 1) // 2."""
    return max(sum((k - 1) // 2 * (int(d) + 1) for d in dils)
               for k, dils in zip(kernel_sizes, dilations))


def _most_tile(C: int, buffers: int) -> int:
    """The largest multiple of TILE_STEP whose shared rows of C + 4 floats
    fit the block's shared memory: with two buffers [MARGIN][xb][MARGIN]
    [hb][MARGIN][TAIL], with one [MARGIN][xb][MARGIN][TAIL]; a buffer holds
    t_tile + 2*HALO rows."""
    rows = SMEM_LIMIT // ((C + 4) * 4) - TAIL
    e_max = (rows - 3 * MARGIN) // 2 if buffers == 2 else rows - 2 * MARGIN
    return (e_max - 2 * HALO) // TILE_STEP * TILE_STEP


def hb_in_global(C: int) -> bool:
    """Whether the kernel keeps its conv-1 buffer in global scratch: when
    two shared buffers leave no room for a 128-sample tile (C > 80)."""
    return _most_tile(C, 2) < 128


def pick_t_tile(C: int, T: int, t_tile: Optional[int] = None, B: int = 1) -> int:
    """Central tile length: ``t_tile`` when given (a multiple of TILE_STEP;
    one above the largest that fits is clamped to it, as the JAX kernels
    clamp theirs, since the output does not depend on the tile), else the
    tile from MIN_TILE up to the largest that fits whose B * ceil(T /
    t_tile) blocks take the fewest waves of SMS blocks, each of t_tile +
    2*HALO rows of work (the larger tile on a tie); no longer than T
    rounded up to TILE_STEP."""
    if C > MAX_CHANNELS:
        raise ValueError(f"C={C} is too wide for the fused MRF kernel "
                         f"(at most {MAX_CHANNELS} channels)")
    most = _most_tile(C, 1 if hb_in_global(C) else 2)
    if t_tile is not None and (t_tile % TILE_STEP or t_tile < TILE_STEP):
        raise ValueError(f"t_tile={t_tile}: the kernel takes a multiple of {TILE_STEP}")
    whole = -(-T // TILE_STEP) * TILE_STEP
    if t_tile is not None:
        return min(t_tile, most, whole)
    top = min(most, whole)

    def cost(t):
        return -(-B * -(-T // t) // SMS) * (t + 2 * HALO), -t

    return min(range(min(MIN_TILE, top), top + 1, TILE_STEP), key=cost)


def fused_mrf_stage_reference(x: torch.Tensor, weights: Sequence[torch.Tensor],
                              kernel_sizes=(3, 7, 11),
                              dilations=((1, 3, 5),) * 3) -> torch.Tensor:
    """Plain torch version: 6 F.conv1d per chain. Each conv zero-pads at
    the true sequence edges, which is the kernel's re-zero after every
    conv."""
    xs = None
    for blk, (k, dils) in enumerate(zip(kernel_sizes, dilations)):
        W1, B1, W2, B2 = weights[4 * blk:4 * blk + 4]
        xb = x
        for j, d in enumerate(dils):
            xt = F.leaky_relu(xb, 0.1)
            xt = F.conv1d(xt, W1[j].permute(2, 1, 0), B1[j], padding=(k - 1) // 2 * d,
                          dilation=int(d))
            xt = F.leaky_relu(xt, 0.1)
            xt = F.conv1d(xt, W2[j].permute(2, 1, 0), B2[j], padding=(k - 1) // 2)
            xb = xt + xb
        xs = xb if xs is None else xs + xb
    return xs / len(kernel_sizes)


def _check(x, weights, kernel_sizes, dilations) -> Tuple[int, int]:
    if x.dtype != torch.float32 or x.dim() != 3 or not x.is_contiguous():
        raise ValueError("fused_mrf_stage takes a contiguous (B, C, T) float32 tensor")
    return check_stage(x.shape[1], x.device, weights, kernel_sizes, dilations)


def check_stage(C: int, device, weights, kernel_sizes, dilations) -> Tuple[int, int]:
    """What both MRF kernels need of a stage of C channels on ``device``:
    chain geometry within the halo and margin, compiled kernel sizes, and
    weights of the right shapes packed into one buffer. Returns (chains,
    dilations per chain)."""
    n_blocks, n_dil = len(kernel_sizes), len(dilations[0])
    if not (1 <= n_blocks <= MAX_BLOCKS and 1 <= n_dil <= MAX_DIL):
        raise ValueError(f"{n_blocks} chains x {n_dil} dilations: at most {MAX_BLOCKS} x {MAX_DIL}")
    if any(len(d) != n_dil for d in dilations) or len(dilations) != n_blocks:
        raise ValueError("every chain needs the same number of dilations")
    if C % 16:
        raise ValueError(f"C={C}: the kernel needs a multiple of 16 channels")
    if C > MAX_CHANNELS:
        raise ValueError(f"C={C} is too wide for the fused MRF kernel "
                         f"(at most {MAX_CHANNELS} channels)")
    if receptive_field(kernel_sizes, dilations) > HALO:
        raise ValueError(f"receptive field exceeds the kernel's halo of {HALO}")
    if max((k - 1) // 2 * int(d) for k, dils in zip(kernel_sizes, dilations) for d in dils) > MARGIN:
        raise ValueError(f"a tap reaches past the kernel's {MARGIN}-column margin")
    if any(k not in KERNEL_SIZES for k in kernel_sizes):
        raise ValueError(f"kernel sizes {kernel_sizes}: the kernel is built for {KERNEL_SIZES}")
    if len(weights) != 4 * n_blocks:
        raise ValueError(f"expected {4 * n_blocks} weight tensors, got {len(weights)}")
    for blk, k in enumerate(kernel_sizes):
        shapes = [(n_dil, k, C, C), (n_dil, C), (n_dil, k, C, C), (n_dil, C)]
        for w, shape in zip(weights[4 * blk:4 * blk + 4], shapes):
            if tuple(w.shape) != shape or w.dtype != torch.float32 or w.device != device:
                raise ValueError(f"chain {blk}: weight {tuple(w.shape)} {w.dtype} {w.device}, "
                                 f"expected {shape} float32 on {device}")
    offset = weights[0].data_ptr()
    for w in weights:
        if w.data_ptr() != offset or not w.is_contiguous():
            raise ValueError("the kernel takes weights packed into one buffer by pack_mrf_weights")
        offset += 4 * w.numel()
    return n_blocks, n_dil


@functools.cache
def _library():
    lib = cuda_build.load("mrf_stage")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.mrf_stage_launch.argtypes = [p, p, p, p, i, i, i, i, i, i,
                                     ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
                                     i, p]
    lib.mrf_stage_launch.restype = ctypes.c_int
    lib.mrf_error_string.argtypes = [ctypes.c_int]
    lib.mrf_error_string.restype = ctypes.c_char_p
    return lib


def _launch(x, weights, kernel_sizes, dilations, t_tile) -> torch.Tensor:
    n_blocks, n_dil = _check(x, weights, kernel_sizes, dilations)
    B, C, T = x.shape
    t_tile = pick_t_tile(C, T, t_tile, B)
    n_items = -(-(t_tile + 2 * HALO) // BAND) * (2 if C > 64 else 1)  # (band, C_out half)
    threads = 32 * min(n_items, MAX_THREADS // 32)
    y = torch.empty_like(x)
    scratch = None
    if hb_in_global(C):
        n_tiles = -(-T // t_tile)
        scratch = torch.empty(B * n_tiles * (t_tile + 2 * HALO + 2 * MARGIN + TAIL) * (C + 4),
                              dtype=torch.float32, device=x.device)
    ks = (ctypes.c_int * n_blocks)(*kernel_sizes)
    ds = (ctypes.c_int * (n_blocks * n_dil))(*(int(d) for dils in dilations for d in dils))
    lib = _library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.mrf_stage_launch(x.data_ptr(), weights[0].data_ptr(), y.data_ptr(),
                                   None if scratch is None else scratch.data_ptr(), B, C, T,
                                   t_tile, n_blocks, n_dil, ks, ds, threads, stream)
    if err != 0:
        raise RuntimeError(f"mrf_stage launch failed: {lib.mrf_error_string(err).decode()}")
    LAUNCHES["mrf_stage"] += 1
    return y


def fused_mrf_stage(x: torch.Tensor, weights: Sequence[torch.Tensor],
                    kernel_sizes=(3, 7, 11), dilations=((1, 3, 5),) * 3,
                    t_tile: Optional[int] = None) -> torch.Tensor:
    """One whole MRF stage (mean of the ResBlock1 chains), (B, C, T) f32.
    CUDA tensors run the hand-written kernel; CPU tensors the plain
    version. ``t_tile``: the kernel's central tile in samples (checked on
    both devices when given, and clamped to the largest that fits; None =
    ``pick_t_tile``'s choice for B)."""
    kernel_sizes = tuple(int(k) for k in kernel_sizes)
    dilations = tuple(tuple(int(d) for d in dils) for dils in dilations)
    if t_tile is not None:
        pick_t_tile(x.shape[1], x.shape[2], t_tile)
    if x.device.type == "cpu":
        return fused_mrf_stage_reference(x, weights, kernel_sizes, dilations)
    if x.device.type != "cuda":
        raise ValueError(f"fused_mrf_stage runs on CUDA or CPU tensors, not {x.device}")
    return _launch(x, weights, kernel_sizes, dilations, t_tile)


def pack_mrf_weights(weights: Sequence[torch.Tensor]) -> Tuple[torch.Tensor, ...]:
    """Copy the weight tuple into one flat buffer, in the order the kernel
    reads it, and return the tuple as views of that buffer."""
    flat = torch.cat([w.reshape(-1) for w in weights])
    parts = flat.split([w.numel() for w in weights])
    return tuple(part.view(w.shape) for part, w in zip(parts, weights))


def mrf_weights_from_resblocks(blocks) -> Tuple[torch.Tensor, ...]:
    """Torch ResBlock1 convs (weight (out, in, k)) -> the kernel's packed
    weights: per block W1 (n_dil, k, in, out), B1, W2, B2."""
    flat = []
    for blk in blocks:
        for convs in (blk.convs1, blk.convs2):
            flat.append(torch.stack([c.weight.permute(2, 1, 0) for c in convs]))
            flat.append(torch.stack([c.bias for c in convs]))
    return pack_mrf_weights(flat)
