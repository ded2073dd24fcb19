"""Fused HiFi-GAN MRF stage: the CUDA kernel's wrapper and its plain version.

``fused_mrf_stage`` is the port of
``matcha_tpu/ops/mrf_pallas.py::fused_mrf_stage`` with the same layouts:
x (B, C, T) f32 channels-first; ``weights`` a flat tuple with, per
ResBlock1 chain, W1 (n_dil, k, C_in, C_out), B1 (n_dil, C_out), W2, B2.
A CUDA tensor launches the kernel in ``csrc/mrf_stage.cu`` (or raises): the
18 convs of the stage as 3xTF32 tensor-core products with f32 accuracy, or
with ``compute_dtype=torch.bfloat16`` (the Pallas kernel's option of that
name) its second instance, whose products take both operands rounded to
bf16 and sum in f32. A CPU tensor takes ``fused_mrf_stage_reference``.

The kernel reads all of a stage's weights from one buffer. ``pack_mrf_weights``
copies the tuple into it once, when a model is loaded, appends the weights
as the kernel stages them (split into TF32 hi and lo, and rounded to bf16,
in the K-major tiles its products read), and returns the tuple as f32 views
of that buffer; the kernel takes only weights packed so. It takes every
multiple of 16 channels up to 128; above C = 80 its conv-1 buffer moves from
shared memory to a global scratch the wrapper allocates.
"""

import ctypes
import functools
from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from matcha_tpu_torch.ops import cuda_build

#: launches of the CUDA kernel in this process, per instance: 3xTF32 and
#: bf16 products (the CPU path does not count)
LAUNCHES = {"mrf_stage": 0, "mrf_stage_bf16": 0}
#: the products' operand types, each a compiled instance of the kernel
COMPUTE_DTYPES = (torch.float32, torch.bfloat16)

HALO = 64  # window rows per side of the tile in the kernel; >= the receptive field
MAX_BLOCKS = MAX_DIL = 4
KERNEL_SIZES = (3, 7, 11)  # the tap counts the kernel takes (HiFi-GAN v1, v2)
MAX_CHANNELS = 128
SMEM_LIMIT = 232_448  # bytes of shared memory a Hopper block may use
# the geometry of the conv pass K1 and K3 share (csrc/mrf_conv.cuh)
TILE_STEP = 16  # t_tile granularity
WG_ROWS = 64  # time rows of one warpgroup product
N_WG = 2  # consumer warpgroups
THREADS = 128 * N_WG + 128  # and the producer's warpgroup
RING = 4  # weight stages in shared memory
TF32_KC = 16  # input channels of one 3xTF32 weight stage
ROW_PAD = 8  # a buffer row holds C + ROW_PAD floats
MIN_TILE = 64  # the smallest tile pick_t_tile chooses: below it K1 got no faster on an H100
SMS = 132  # streaming multiprocessors of an H100 SXM
HIFIGAN_KS, HIFIGAN_DILS = (3, 7, 11), ((1, 3, 5),) * 3  # HiFi-GAN v1's and v2's MRF


def receptive_field(kernel_sizes, dilations) -> int:
    """Samples one side of the stage reaches: per chain, sum over its
    dilations of c0 * d (conv 1) + c0 (conv 2), c0 = (k - 1) // 2."""
    return max(sum((k - 1) // 2 * (int(d) + 1) for d in dils)
               for k, dils in zip(kernel_sizes, dilations))


def chain_reaches(k: int, dils) -> Tuple[int, ...]:
    """How far each conv of a ResBlock1 chain reaches, in order: c0 * d for
    a dilated conv, c0 for the d=1 conv after it."""
    c0 = (k - 1) // 2
    return tuple(r for d in dils for r in (c0 * int(d), c0))


def conv_rows(t_tile: int, k: int, dils) -> Tuple[Tuple[int, int], ...]:
    """The rows each conv of a chain computes, as (first, end) relative to
    the tile's first position, as the kernel schedules them: the central
    ``t_tile`` plus, each side, ``rem`` = what the chain's later convs
    still reach, rounded up to whole WG_ROWS tiles past the end (rows
    the kernel computes but never stores)."""
    reaches = chain_reaches(k, dils)
    rows = []
    for i in range(len(reaches)):
        rem = sum(reaches[i + 1:])
        rows.append((-rem, -rem + -(-(t_tile + 2 * rem) // WG_ROWS) * WG_ROWS))
    return tuple(rows)


def _most_tile(C: int, buffers: int) -> int:
    """The largest multiple of TILE_STEP whose window fits the block's
    shared memory beside the ring of RING 3xTF32 weight stages (and 256
    bytes for the mbarriers and alignment): ``buffers`` buffers of t_tile +
    2*HALO rows of C + ROW_PAD floats."""
    ring = RING * 2 * C * TF32_KC * 4
    rows = (SMEM_LIMIT - 256 - ring) // ((C + ROW_PAD) * 4)
    return (rows // buffers - 2 * HALO) // TILE_STEP * TILE_STEP


def hb_in_global(C: int) -> bool:
    """Whether the kernel keeps its conv-1 buffer in global scratch: when
    two shared buffers leave no room for a 128-sample tile (C > 80)."""
    return _most_tile(C, 2) < 128


def pick_t_tile(C: int, T: int, t_tile: Optional[int] = None, B: int = 1,
                kernel_sizes=HIFIGAN_KS, dilations=HIFIGAN_DILS) -> int:
    """Central tile length: ``t_tile`` when given (a multiple of TILE_STEP;
    one above the largest that fits is clamped to it, as the JAX kernels
    clamp theirs, since the output does not depend on the tile), else the
    tile from MIN_TILE up to the largest that fits whose B * ceil(T /
    t_tile) blocks take the fewest waves of SMS blocks times the rows a
    block computes, tap-weighted (``conv_rows``; the larger tile on a
    tie); no longer than T rounded up to TILE_STEP."""
    if C > MAX_CHANNELS:
        raise ValueError(f"C={C} is too wide for the fused MRF kernel "
                         f"(at most {MAX_CHANNELS} channels)")
    most = _most_tile(C, 1 if hb_in_global(C) else 2)
    if t_tile is not None and (t_tile % TILE_STEP or t_tile < TILE_STEP):
        raise ValueError(f"t_tile={t_tile}: the kernel takes a multiple of {TILE_STEP}")
    whole = -(-T // TILE_STEP) * TILE_STEP
    if t_tile is not None:
        return min(t_tile, most, whole)
    return _auto_tile(C, T, B, min(most, whole), tuple(map(int, kernel_sizes)),
                      tuple(tuple(map(int, d)) for d in dilations))


@functools.lru_cache(maxsize=4096)
def _auto_tile(C, T, B, top, kernel_sizes, dilations) -> int:
    """pick_t_tile's own choice, cached: it runs at every launch."""

    def cost(t):
        rows = sum(k * (end - first) for k, dils in zip(kernel_sizes, dilations)
                   for first, end in conv_rows(t, k, dils))
        return -(-B * -(-T // t) // SMS) * rows, -t

    return min(range(min(MIN_TILE, top), top + 1, TILE_STEP), key=cost)


def fused_mrf_stage_reference(x: torch.Tensor, weights: Sequence[torch.Tensor],
                              kernel_sizes=(3, 7, 11), dilations=((1, 3, 5),) * 3,
                              compute_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Plain torch version: 6 F.conv1d per chain. Each conv zero-pads at
    the true sequence edges, which is the kernel's re-zero after every
    conv. ``compute_dtype=torch.bfloat16`` rounds each conv's input and
    weights to bf16 (to nearest even) and convolves them in f32; the bias
    and everything between the convs stay f32."""
    _check_compute_dtype(compute_dtype)

    def conv(v, w, b, **kw):
        if compute_dtype != torch.float32:
            v, w = (t.to(compute_dtype).float() for t in (v, w))
        return F.conv1d(v, w.permute(2, 1, 0), b, **kw)

    xs = None
    for blk, (k, dils) in enumerate(zip(kernel_sizes, dilations)):
        W1, B1, W2, B2 = weights[4 * blk:4 * blk + 4]
        xb = x
        for j, d in enumerate(dils):
            xt = F.leaky_relu(xb, 0.1)
            xt = conv(xt, W1[j], B1[j], padding=(k - 1) // 2 * d, dilation=int(d))
            xt = F.leaky_relu(xt, 0.1)
            xt = conv(xt, W2[j], B2[j], padding=(k - 1) // 2)
            xb = xt + xb
        xs = xb if xs is None else xs + xb
    return xs / len(kernel_sizes)


def _check_compute_dtype(compute_dtype) -> None:
    if compute_dtype not in COMPUTE_DTYPES:
        raise ValueError(f"compute_dtype={compute_dtype}: the kernel is built for "
                         f"{COMPUTE_DTYPES}")


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
    storage = weights[0].untyped_storage()
    if (storage.data_ptr() + storage.nbytes() < offset + staged_bytes(weights)
            or weights[0].data_ptr() % 16):
        raise ValueError("the kernel takes weights packed into one buffer by pack_mrf_weights, "
                         "with their staged copies")
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


def _launch(x, weights, kernel_sizes, dilations, t_tile, compute_dtype) -> torch.Tensor:
    n_blocks, n_dil = _check(x, weights, kernel_sizes, dilations)
    B, C, T = x.shape
    t_tile = pick_t_tile(C, T, t_tile, B, kernel_sizes, dilations)
    y = torch.empty_like(x)
    scratch = None
    if hb_in_global(C):  # per block: the window and the rows a last tile's taps read past it
        n_tiles = -(-T // t_tile)
        scratch = torch.empty(B * n_tiles * (t_tile + 2 * HALO + WG_ROWS) * (C + ROW_PAD),
                              dtype=torch.float32, device=x.device)
    ks = (ctypes.c_int * n_blocks)(*kernel_sizes)
    ds = (ctypes.c_int * (n_blocks * n_dil))(*(int(d) for dils in dilations for d in dils))
    bf16 = compute_dtype == torch.bfloat16
    lib = _library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.mrf_stage_launch(x.data_ptr(), weights[0].data_ptr(), y.data_ptr(),
                                   None if scratch is None else scratch.data_ptr(), B, C, T,
                                   t_tile, n_blocks, n_dil, ks, ds, int(bf16), stream)
    if err != 0:
        raise RuntimeError(f"mrf_stage launch failed: {lib.mrf_error_string(err).decode()}")
    LAUNCHES["mrf_stage_bf16" if bf16 else "mrf_stage"] += 1
    return y


def fused_mrf_stage(x: torch.Tensor, weights: Sequence[torch.Tensor],
                    kernel_sizes=(3, 7, 11), dilations=((1, 3, 5),) * 3,
                    t_tile: Optional[int] = None,
                    compute_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """One whole MRF stage (mean of the ResBlock1 chains), (B, C, T) f32.
    CUDA tensors run the hand-written kernel; CPU tensors the plain
    version. ``t_tile``: the kernel's central tile in samples (checked on
    both devices when given, and clamped to the largest that fits; None =
    ``pick_t_tile``'s choice for B). ``compute_dtype``: the products'
    operand type, float32 (3xTF32, f32-accurate) or bfloat16 (operands
    rounded to bf16, f32 sums); activations are f32 either way."""
    _check_compute_dtype(compute_dtype)
    kernel_sizes = tuple(int(k) for k in kernel_sizes)
    dilations = tuple(tuple(int(d) for d in dils) for dils in dilations)
    if t_tile is not None:
        pick_t_tile(x.shape[1], x.shape[2], t_tile)
    if x.device.type == "cpu":
        return fused_mrf_stage_reference(x, weights, kernel_sizes, dilations, compute_dtype)
    if x.device.type != "cuda":
        raise ValueError(f"fused_mrf_stage runs on CUDA or CPU tensors, not {x.device}")
    return _launch(x, weights, kernel_sizes, dilations, t_tile, compute_dtype)


def split_tf32(w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """w = hi + lo, hi rounded to TF32 (to nearest, ties away from zero:
    the kernel's ``split``, on the bits), lo the exact remainder."""
    bits = w.float().contiguous().view(torch.int32)
    hi = ((bits + 0x1000) & -0x2000).view(torch.float32)
    return hi, w - hi


def bf16_stage_channels(C: int) -> int:
    """Input channels of one bf16 weight stage (two k16 steps where C
    allows)."""
    return 32 if C % 32 == 0 else 16


def staged_tf32(W: torch.Tensor) -> torch.Tensor:
    """A conv's weights (n_dil, k, C_in, C_out) as the 3xTF32 instance
    stages them: per (dilation, tap, TF32_KC input channels) a hi tile
    then a lo tile, each K-major in core matrices of 8 output channels x 4
    input channels, [c_out // 8][kk // 4][c_out % 8][kk % 4], where within
    each 8 channels position kk holds channel 2 kk (kk < 4) or 2 (kk - 4)
    + 1, the channels a lane's A fragment loads as one float2."""
    n_dil, k, C, _ = W.shape
    order = torch.tensor([2 * i for i in range(4)] + [2 * i + 1 for i in range(4)])
    order = torch.cat([order + 8 * s for s in range(TF32_KC // 8)]).to(W.device)
    t = W.reshape(n_dil, k, C // TF32_KC, TF32_KC, C)[:, :, :, order]
    t = t.transpose(3, 4).reshape(n_dil, k, C // TF32_KC, C // 8, 8, TF32_KC // 4, 4)
    t = t.permute(0, 1, 2, 3, 5, 4, 6).reshape(n_dil, k, C // TF32_KC, 1, -1)
    return torch.cat(split_tf32(t), dim=3).reshape(-1)


def staged_bf16(W: torch.Tensor) -> torch.Tensor:
    """A conv's weights as the bf16 instance stages them, rounded to bf16
    (to nearest even): per (dilation, tap, stage of input channels) one
    tile, K-major in core matrices of 8 output x 8 input channels,
    [c_out // 8][kk // 8][c_out % 8][kk % 8], in the channels' own order;
    returned as the f32 words that hold them."""
    n_dil, k, C, _ = W.shape
    kc = bf16_stage_channels(C)
    t = W.reshape(n_dil, k, C // kc, kc, C).transpose(3, 4)
    t = t.reshape(n_dil, k, C // kc, C // 8, 8, kc // 8, 8).permute(0, 1, 2, 3, 5, 4, 6)
    return t.to(torch.bfloat16).reshape(-1).view(torch.float32)


def _staged_convs(weights: Sequence[torch.Tensor]):
    """The conv weights the kernel stages: every 4-D one, at a width the
    kernel takes (a multiple of 16; it refuses any other stage)."""
    return [w for w in weights if w.dim() == 4 and w.shape[-1] % 16 == 0]


def staged_bytes(weights: Sequence[torch.Tensor]) -> int:
    """Bytes the staged copies take after the f32 tuple: each staged conv
    weight twice in TF32 (hi, lo) and once in bf16."""
    return sum(10 * w.numel() for w in _staged_convs(weights))


def pack_mrf_weights(weights: Sequence[torch.Tensor]) -> Tuple[torch.Tensor, ...]:
    """Copy the weight tuple into one flat buffer, in the order the kernel
    reads it, followed by its staged copies (every conv weight of a width
    the kernel takes, in order as ``staged_tf32``, then every one as
    ``staged_bf16``; the kernel finds them from the shapes), and return the
    tuple as f32 views of the buffer's start."""
    convs = _staged_convs(weights)
    flat = torch.cat([w.reshape(-1) for w in weights] + [staged_tf32(w) for w in convs]
                     + [staged_bf16(w) for w in convs])
    parts = flat[:sum(w.numel() for w in weights)].split([w.numel() for w in weights])
    return tuple(part.view(w.shape) for part, w in zip(parts, weights))


def mrf_weights_from_resblocks(blocks) -> Tuple[torch.Tensor, ...]:
    """Torch ResBlock1 convs (weight (out, in, k)) -> the kernel's packed
    weights: per block W1 (n_dil, k, in, out), B1, W2, B2, in f32 (the
    kernels' type; bf16 convs upcast exactly)."""
    flat = []
    for blk in blocks:
        for convs in (blk.convs1, blk.convs2):
            flat.append(torch.stack([c.weight.permute(2, 1, 0) for c in convs]).float())
            flat.append(torch.stack([c.bias for c in convs]).float())
    return pack_mrf_weights(flat)
