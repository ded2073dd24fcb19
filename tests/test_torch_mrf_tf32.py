"""The numerics of kernel K1 (``csrc/mrf_stage.cu``), emulated on the CPU.

K1 runs each of the stage's 18 convs on TF32 tensor cores with f32
accuracy (3xTF32): every operand v is split into hi, v rounded to TF32
(a 10-bit mantissa, to nearest with ties away from zero, as
``cvt.rna.tf32.f32``), and lo = v - hi, of which the tensor core reads
only the TF32 bits; each product is taken as lo·hi + hi·lo + hi·hi in
f32. Here the same split is done in torch by integer bit operations, and
the stage runs through ``F.conv1d`` on the split operands. The products
of TF32 values are exact in f32, so what remains is the sum order and the
dropped lo·lo term.

    JAX_PLATFORMS=cpu PYTHONPATH=. python tests/test_torch_mrf_tf32.py

prints the largest error of the 3xTF32 stage and of a single TF32 product
per conv (hi·hi only) against the plain f32 stage, at the widths below.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from matcha_tpu.ops.mrf_pallas import fused_mrf_stage as jax_fused_mrf_stage
from matcha_tpu_torch.ops import mrf

KS, DILS = (3, 7, 11), ((1, 3, 5),) * 3


def tf32(v: torch.Tensor) -> torch.Tensor:
    """Round f32 to TF32: add half a unit of the 13 dropped bits to the
    magnitude, then clear them."""
    bits = v.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def tf32_bits(v: torch.Tensor) -> torch.Tensor:
    """The TF32 bits of f32 values, as a tensor core reads them: the 13
    low mantissa bits cleared."""
    return (v.contiguous().view(torch.int32) & -0x2000).view(torch.float32)


def _conv(x, W, b, k, d, terms):
    """One 'same' conv (W (k, C_in, C_out)) from TF32 parts: terms = 3 is
    lo·hi + hi·lo + hi·hi, small terms first; terms = 1 is hi·hi."""
    w = W.permute(2, 1, 0)
    x_hi, w_hi = tf32(x), tf32(w)
    x_lo, w_lo = tf32_bits(x - x_hi), tf32_bits(w - w_hi)

    def conv(a, ww):
        return F.conv1d(a, ww, padding=(k - 1) // 2 * d, dilation=d)

    if terms == 1:
        return conv(x_hi, w_hi) + b[:, None]
    return conv(x_lo, w_hi) + conv(x_hi, w_lo) + conv(x_hi, w_hi) + b[:, None]


def stage_tf32(x, weights, terms=3, kernel_sizes=KS, dilations=DILS):
    """``fused_mrf_stage_reference`` with every conv's product in TF32 parts."""
    xs = None
    for blk, (k, dils) in enumerate(zip(kernel_sizes, dilations)):
        W1, B1, W2, B2 = weights[4 * blk:4 * blk + 4]
        xb = x
        for j, d in enumerate(dils):
            xt = _conv(F.leaky_relu(xb, 0.1), W1[j], B1[j], k, d, terms)
            xt = _conv(F.leaky_relu(xt, 0.1), W2[j], B2[j], k, 1, terms)
            xb = xt + xb
        xs = xb if xs is None else xs + xb
    return xs / len(kernel_sizes)


def _inputs(C, B=2, T=700, seed=0):
    """Seeded numpy activations (B, C, T) and full-width v1 stage weights,
    scaled as in tests/test_torch_kernels_cuda.py (0.3 / sqrt(k C))."""
    rng = np.random.default_rng(seed + C)
    x = rng.normal(size=(B, C, T)).astype(np.float32)
    weights = [(rng.normal(size=shape) * (0.3 / (k * C) ** 0.5)).astype(np.float32)
               for k in KS for shape in ((3, k, C, C), (3, C), (3, k, C, C), (3, C))]
    return x, weights


def test_tf32_rounding():
    """Round to nearest on the 10-bit mantissa, ties away from zero."""
    one_ulp = 2.0 ** -10
    v = torch.tensor([1.0, 1 + one_ulp / 4, 1 + one_ulp / 2, 1 + 3 * one_ulp / 4,
                      -(1 + one_ulp / 2), 3.0e-3])
    got = tf32(v)
    assert got[:5].tolist() == [1.0, 1.0, 1 + one_ulp, 1 + one_ulp, -(1 + one_ulp)]
    assert abs(got[5].item() - 3.0e-3) <= 3.0e-3 * 2.0 ** -11
    x = torch.randn(1000, generator=torch.Generator().manual_seed(0))
    assert (tf32(tf32(x)) == tf32(x)).all()  # idempotent
    assert ((x - tf32(x)).abs() <= x.abs() * 2.0 ** -11).all()
    assert tf32_bits(v)[1:4].tolist() == [1.0, 1.0, 1.0]  # truncation
    assert (tf32_bits(tf32(x)) == tf32(x)).all()


@pytest.mark.parametrize("C", [32, 64])
def test_3xtf32_stage_holds_f32_accuracy(C):
    """The full-width v1 stage (3 chains x 3 dilations, T = 700) with each
    product in 3xTF32 stays within 1e-5 of the plain f32 stage (outputs
    of magnitude ~1; the dropped lo·lo term is ~2^-22 of each product) and
    within 2e-5 of the JAX package's kernel in interpret mode, the atol of
    tests/test_torch_vocoder.py."""
    x, weights = _inputs(C)
    xt, wt = torch.from_numpy(x), tuple(map(torch.from_numpy, weights))
    got = stage_tf32(xt, wt)
    plain = mrf.fused_mrf_stage_reference(xt, wt, KS, DILS)
    assert got.shape == xt.shape and float(plain.abs().max()) > 1.0
    assert (got - plain).abs().max().item() < 1e-5
    want = np.asarray(jax_fused_mrf_stage(jnp.asarray(x), tuple(map(jnp.asarray, weights)),
                                          t_tile=256, interpret=True))
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5)


if __name__ == "__main__":
    for C in (32, 64):
        x, weights = _inputs(C)
        xt, wt = torch.from_numpy(x), tuple(map(torch.from_numpy, weights))
        plain = mrf.fused_mrf_stage_reference(xt, wt, KS, DILS)
        errs = {terms: (stage_tf32(xt, wt, terms) - plain).abs().max().item() for terms in (3, 1)}
        print(f"C={C} B=2 T=700 max|plain|={plain.abs().max().item():.3f} "
              f"3xTF32 max_abs_err={errs[3]:.3e} 1xTF32 max_abs_err={errs[1]:.3e}")
