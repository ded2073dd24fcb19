"""The MRF stage on channels-last activations: kernel K3's wrapper, its
plain version and the phase-packing helpers.

``fused_mrf_stage_phase`` is the port of
``matcha_tpu/ops/mrf_pallas.py::fused_mrf_stage_phase`` with the same
contract: x (B, T, C) f32 channels-last in and out; ``weights`` in
``mrf_weights_from_resblocks``' layout (per ResBlock1 chain W1 (n_dil, k,
C_in, C_out), B1 (n_dil, C_out), W2, B2, packed into one buffer by
``pack_mrf_weights``). With P = 128 // C as in the JAX package, C <= 64
(P >= 2) goes to the kernel in ``csrc/mrf_phase.cu`` on a CUDA tensor and
to ``fused_mrf_stage_phase_reference`` on a CPU tensor; any wider C
(P = 1) is transposed and handed to K1 (``ops/mrf.py``), as the JAX
function hands it to its plain kernel.

The phase packing (time phases stacked on the channel axis, x_packed[(p,
c), s] = x[P*s + p, c]) exists to fill a TPU's 128-row matrix unit at
C = 32. The CUDA kernel does not pack: time is the rows of its products
and a tap is a row offset. It runs K1's conv pass (``csrc/mrf_conv.cuh``:
3xTF32 warpgroup products with f32 accuracy, K1's tile and rows) on
channels-last rows, and equals K1 on the transposed input. The packing
survives here as the plain version, an independent formulation of the
stage that the tests hold against K1's plain ``F.conv1d`` chain and
against JAX.
"""

import ctypes
import functools
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from matcha_tpu_torch.ops import cuda_build, mrf

#: launches of the CUDA kernel in this process (the CPU path does not count)
LAUNCHES = {"mrf_stage_phase": 0}

MAX_CHANNELS = 64  # the widest C with P = 128 // C >= 2; the halo, thread
# and shared-memory limits are K1's (``mrf.HALO`` etc.)


# --- the phase packing (own copy of the JAX package's helpers) ------------

def _phase_offsets(k: int, d: int, P: int) -> Tuple[int, ...]:
    """Sorted union of packed-lane offsets needed by a (k, d) conv at P."""
    c0 = (k - 1) // 2
    return tuple(sorted({p + (t - c0) * d for p in range(P) for t in range(k)}))


def _phase_pad(kernel_sizes, dilations, P: int) -> int:
    """Packed-lane halo of the worst ResBlock chain: each conv's tap shifts
    reach ceil(c0*d/P) lanes each side and the round-ups accumulate along
    the chain; rounded up to a multiple of 64 as in the JAX package."""
    worst = 0
    for k, dils in zip(kernel_sizes, dilations):
        c0 = (k - 1) // 2
        budget = sum(-(-c0 * int(d) // P) + -(-c0 // P) for d in dils)
        worst = max(worst, budget)
    return -(-worst // 64) * 64


def _mrf_offsets(kernel_sizes, dilations, P: int):
    """Offsets per (block, dil) for conv 1 (dilated) and conv 2 (d=1)."""
    return tuple(tuple((_phase_offsets(k, int(d), P), _phase_offsets(k, 1, P)) for d in dils)
                 for k, dils in zip(kernel_sizes, dilations))


def _pack_conv_weights(W: torch.Tensor, bias: torch.Tensor, d: int, k: int, P: int):
    """(k, C_in, C_out) kernel -> (P*C_out, |O|*C_in) packed matmul weights
    + (P*C_out,) bias: tap t of output phase p goes to the column block of
    offset o = p + (t - c0)*d. Within one phase the taps take distinct
    offsets, so every packed entry is one weight or 0."""
    offsets = _phase_offsets(k, d, P)
    oi = {o: i for i, o in enumerate(offsets)}
    c0 = (k - 1) // 2
    C_in, C_out = W.shape[1], W.shape[2]
    M = np.zeros((k, P, len(offsets)), np.float32)
    for p in range(P):
        for t in range(k):
            M[t, p, oi[p + (t - c0) * d]] = 1.0
    # Wp[(p, o), (q, i)] = sum_t M[t, p, q] * W[t, i, o]
    Wp = torch.einsum("tpq,tio->poqi", torch.from_numpy(M).to(W), W)
    return Wp.reshape(P * C_out, len(offsets) * C_in), bias.repeat(P)


def pack_mrf_weights_phase(weights: Sequence[torch.Tensor], kernel_sizes, dilations,
                           P: int) -> Tuple[torch.Tensor, ...]:
    """Per block, per dilation j: (W1p, b1p, W2p, b2p), W1p packed at
    (k, d_j) and W2p at (k, 1)."""
    out = []
    for blk, (k, dils) in enumerate(zip(kernel_sizes, dilations)):
        W1, B1, W2, B2 = weights[4 * blk:4 * blk + 4]
        for j, d in enumerate(dils):
            out += [*_pack_conv_weights(W1[j], B1[j], int(d), k, P),
                    *_pack_conv_weights(W2[j], B2[j], 1, k, P)]
    return tuple(out)


# --- the plain version -----------------------------------------------------

def _packed_conv(x: torch.Tensor, Wp: torch.Tensor, bp: torch.Tensor, offsets, C: int,
                 P: int) -> torch.Tensor:
    """One conv on the packed (B, P*C, T4) activation: the |O| shifted row
    groups (row group o % P, shifted by o // P packed lanes, zero-filled)
    stacked, times the packed weights."""
    T4 = x.shape[-1]
    lo, hi = -min(0, offsets[0] // P), max(0, offsets[-1] // P)
    xp = F.pad(x, (lo, hi))
    X = torch.cat([xp[:, (o % P) * C:(o % P + 1) * C, lo + o // P:lo + o // P + T4]
                   for o in offsets], dim=1)
    return torch.matmul(Wp, X) + bp[:, None]


def fused_mrf_stage_phase_reference(x: torch.Tensor, weights: Sequence[torch.Tensor],
                                    kernel_sizes=(3, 7, 11),
                                    dilations=((1, 3, 5),) * 3) -> torch.Tensor:
    """Plain torch version, computed through the phase packing: x (B, T, C)
    packed to (B, P*C, T4), P = max(1, 128 // C); per conv one product of
    the packed weights with the stacked shifted row groups; every conv's
    output re-zeroed where its original-time position is outside [0, T);
    the mean of the chains unpacked to (B, T, C)."""
    B, T, C = x.shape
    P = max(1, 128 // C)
    T4 = -(-T // P)
    packed = pack_mrf_weights_phase(weights, kernel_sizes, dilations, P)
    offs = _mrf_offsets(kernel_sizes, dilations, P)
    # x_p[b, p*C + c, s] = x[b, P*s + p, c]
    x_p = F.pad(x, (0, 0, 0, T4 * P - T)).reshape(B, T4, P, C).permute(0, 2, 3, 1)
    x_p = x_p.reshape(B, P * C, T4)
    row_phase = torch.arange(P, device=x.device).repeat_interleave(C)
    gpos = P * torch.arange(T4, device=x.device)[None, :] + row_phase[:, None]
    valid = gpos < T

    def leaky(v):
        return F.leaky_relu(v, 0.1)

    xs, w = None, 0
    for blk, dils in enumerate(dilations):
        xb = x_p
        for j in range(len(dils)):
            W1p, b1p, W2p, b2p = packed[w:w + 4]
            w += 4
            o1, o2 = offs[blk][j]
            xt = torch.where(valid, _packed_conv(leaky(xb), W1p, b1p, o1, C, P), 0.0)
            xt = torch.where(valid, _packed_conv(leaky(xt), W2p, b2p, o2, C, P), 0.0)
            xb = xt + xb
        xs = xb if xs is None else xs + xb
    out = (xs / len(kernel_sizes)).reshape(B, P, C, T4).permute(0, 3, 1, 2)
    return out.reshape(B, T4 * P, C)[:, :T]


# --- the kernel ------------------------------------------------------------

def launch_geometry(C: int, T: int, B: int = 1, t_tile: Optional[int] = None,
                    kernel_sizes=mrf.HIFIGAN_KS, dilations=mrf.HIFIGAN_DILS) -> Tuple[int, int]:
    """(t_tile, threads) of a launch. The kernel runs K1's conv pass on
    K1's rows at C <= 64 (two shared buffers of t_tile + 2*HALO rows of
    C + ROW_PAD floats beside the weight ring), so its tile is K1's,
    ``mrf.pick_t_tile``, and so are its threads: two consumer warpgroups
    and the producer's."""
    return mrf.pick_t_tile(C, T, t_tile, B, kernel_sizes, dilations), mrf.THREADS


def _check(x, weights, kernel_sizes, dilations) -> Tuple[int, int]:
    if x.dtype != torch.float32 or x.dim() != 3 or not x.is_contiguous():
        raise ValueError("fused_mrf_stage_phase takes a contiguous (B, T, C) float32 tensor")
    B, T, C = x.shape
    if C % 16 or C > MAX_CHANNELS:
        raise ValueError(f"C={C}: the kernel needs a multiple of 16 channels, at most "
                         f"{MAX_CHANNELS}")
    if x.data_ptr() % 16:
        raise ValueError("the kernel moves rows as float4: x must start on 16 bytes")
    return mrf.check_stage(C, x.device, weights, kernel_sizes, dilations)


@functools.cache
def _library():
    lib = cuda_build.load("mrf_phase")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.mrf_phase_launch.argtypes = [p, p, p, i, i, i, i, i, i,
                                     ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int), p]
    lib.mrf_phase_launch.restype = ctypes.c_int
    lib.mrf_phase_error_string.argtypes = [ctypes.c_int]
    lib.mrf_phase_error_string.restype = ctypes.c_char_p
    return lib


def _launch(x, weights, kernel_sizes, dilations, t_tile) -> torch.Tensor:
    n_blocks, n_dil = _check(x, weights, kernel_sizes, dilations)
    B, T, C = x.shape
    t_tile, _ = launch_geometry(C, T, B, t_tile, kernel_sizes, dilations)
    y = torch.empty_like(x)
    ks = (ctypes.c_int * n_blocks)(*kernel_sizes)
    ds = (ctypes.c_int * (n_blocks * n_dil))(*(int(d) for dils in dilations for d in dils))
    lib = _library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.mrf_phase_launch(x.data_ptr(), weights[0].data_ptr(), y.data_ptr(), B, C, T,
                                   t_tile, n_blocks, n_dil, ks, ds, stream)
    if err != 0:
        raise RuntimeError(f"mrf_phase launch failed: {lib.mrf_phase_error_string(err).decode()}")
    LAUNCHES["mrf_stage_phase"] += 1
    return y


def fused_mrf_stage_phase(x: torch.Tensor, weights: Sequence[torch.Tensor],
                          kernel_sizes=(3, 7, 11), dilations=((1, 3, 5),) * 3,
                          t_tile: Optional[int] = None) -> torch.Tensor:
    """One whole MRF stage on (B, T, C) f32, channels-last. C <= 64: the
    CUDA kernel on a CUDA tensor, the plain version on a CPU tensor. Wider
    C: transposed to (B, C, T) for ``mrf.fused_mrf_stage`` (K1) and back;
    the result is then a transposed view.

    ``t_tile``: the kernel's central tile in samples, checked on both
    devices when given and clamped to the largest that fits, as K1's;
    None = ``mrf.pick_t_tile``'s choice for B. The JAX function counts its
    ``t_tile`` in packed lanes of P = 128 // C samples each. The output
    does not depend on the tile, so that is the only difference."""
    kernel_sizes = tuple(int(k) for k in kernel_sizes)
    dilations = tuple(tuple(int(d) for d in dils) for dils in dilations)
    B, T, C = x.shape
    if 128 // C < 2:
        y = mrf.fused_mrf_stage(x.transpose(1, 2).contiguous(), weights, kernel_sizes,
                                dilations, t_tile=t_tile)
        return y.transpose(1, 2)
    if t_tile is not None:
        mrf.pick_t_tile(C, T, t_tile, B)
    if x.device.type == "cpu":
        return fused_mrf_stage_phase_reference(x, weights, kernel_sizes, dilations)
    if x.device.type != "cuda":
        raise ValueError(f"fused_mrf_stage_phase runs on CUDA or CPU tensors, not {x.device}")
    return _launch(x, weights, kernel_sizes, dilations, t_tile)
