"""The port's MRF stage on channels-last activations (kernel K3's plain
version and its phase-packing helpers) against the JAX package, and K1's
geometry up to C = 128.

The plain version computes the stage through the phase packing, so it is
held against JAX's Pallas kernel in interpret mode, a flax ResBlock1
stack, and K1's plain ``F.conv1d`` chain. The CUDA kernel itself is held
against the plain version on a GPU by tests/test_torch_kernels_cuda.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from matcha_tpu.models.hifigan import ResBlock1
from matcha_tpu.ops import mrf_pallas
from matcha_tpu_torch.models.hifigan import Generator, HiFiGANConfig
from matcha_tpu_torch.models.hifigan_fused import fused_stage_weights, generator_apply_fused
from matcha_tpu_torch.ops import mrf, mrf_phase

KS, DILS = (3, 7, 11), ((1, 3, 5),) * 3


def _stage(C, B, T, ks=KS, dils=DILS, seed=0):
    """Seeded (B, T, C) activations and weights in the kernels' layout
    (per chain W1 (n_dil, k, C, C), B1, W2, B2), as numpy."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(B, T, C)).astype(np.float32)
    weights = []
    for k, d in zip(ks, dils):
        for shape in ((len(d), k, C, C), (len(d), C)) * 2:
            scale = (0.3 / (k * C) ** 0.5) if len(shape) == 4 else 0.1
            weights.append((rng.normal(size=shape) * scale).astype(np.float32))
    return x, weights


def _flax_stage(C, B, T, seed=0):
    """Seeded activations, flax-initialised ResBlock1 weights (the full v1
    stage) in the kernels' layout, and the flax stack's output."""
    x, _ = _stage(C, B, T, seed=seed)
    key = jax.random.PRNGKey(seed)
    params, ref = [], None
    for n, (k, d) in enumerate(zip(KS, DILS)):
        blk = ResBlock1(C, k, tuple(d))
        p = blk.init(jax.random.fold_in(key, n), jnp.asarray(x[:, :8]))
        params.append(p["params"])
        y = blk.apply(p, jnp.asarray(x))
        ref = y if ref is None else ref + y
    weights = [np.array(w) for w in mrf_pallas.mrf_weights_from_params(params)]
    return x, weights, np.asarray(ref / len(KS))


@pytest.mark.parametrize("C", [16, 32, 64])
def test_phase_helpers_match_jax(C):
    """Offsets and halo for every (k, d) of HiFi-GAN, and the packed
    weights EXACTLY (each packed entry is one weight or 0)."""
    P = 128 // C
    for k in (3, 7, 11):
        for d in (1, 3, 5):
            assert mrf_phase._phase_offsets(k, d, P) == mrf_pallas._phase_offsets(k, d, P)
    for ks, dils in ((KS, DILS), ((3, 7), ((1, 3),) * 2), ((3,), ((1, 2),))):
        assert mrf_phase._phase_pad(ks, dils, P) == mrf_pallas._phase_pad(ks, dils, P)
        assert mrf_phase._mrf_offsets(ks, dils, P) == mrf_pallas._mrf_offsets(ks, dils, P)
    _, weights = _stage(C, 1, 16)
    want = mrf_pallas.pack_mrf_weights_phase(tuple(map(jnp.asarray, weights)), KS, DILS, P)
    got = mrf_phase.pack_mrf_weights_phase(tuple(map(torch.from_numpy, weights)), KS, DILS, P)
    assert len(got) == len(want) == 4 * 9
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("C,T", [(32, 700), (64, 260)])
def test_phase_plain_matches_pallas_interpret(C, T):
    """The tier-1 cases of tests/test_mrf_pallas.py: a 2-chain config,
    t_tile 128 packed lanes, T not a multiple of P * t_tile; atol 2e-5
    (f32 sums in another order)."""
    ks, dils = (3, 7), ((1, 3), (1, 3))
    x, weights = _stage(C, 1, T, ks, dils)
    want = np.asarray(mrf_pallas.fused_mrf_stage_phase(
        jnp.asarray(x), tuple(map(jnp.asarray, weights)), kernel_sizes=ks, dilations=dils,
        t_tile=128, interpret=True))
    before = mrf_phase.LAUNCHES["mrf_stage_phase"]
    got = mrf_phase.fused_mrf_stage_phase(torch.from_numpy(x), tuple(map(torch.from_numpy, weights)),
                                          ks, dils)
    assert got.shape == x.shape
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5)
    assert mrf_phase.LAUNCHES["mrf_stage_phase"] == before  # the CPU path launches no kernel


def test_phase_plain_matches_resblocks_full_v1():
    """The full v1 stage (3 chains, k 3/7/11, dilations 1/3/5) at C = 32,
    T = 700, the geometry of the JAX package's slow phase test, against
    the flax ResBlock1 stack; atol 2e-5."""
    x, weights, ref = _flax_stage(32, 1, 700)
    got = mrf_phase.fused_mrf_stage_phase_reference(torch.from_numpy(x),
                                                    tuple(map(torch.from_numpy, weights)))
    np.testing.assert_allclose(got.numpy(), ref, atol=2e-5)


@pytest.mark.parametrize("C,B,T", [(16, 2, 333), (32, 3, 129), (48, 1, 100), (64, 2, 517)])
def test_phase_plain_matches_k1_plain(C, B, T):
    """Two formulations of one stage: the phase-packed products against
    K1's F.conv1d chain on the transposed input; atol 1e-5."""
    x, weights = _stage(C, B, T, seed=C + T)
    w = mrf.pack_mrf_weights(list(map(torch.from_numpy, weights)))
    xt = torch.from_numpy(x)
    got = mrf_phase.fused_mrf_stage_phase_reference(xt, w)
    want = mrf.fused_mrf_stage_reference(xt.transpose(1, 2), w).transpose(1, 2)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-5)


@pytest.mark.parametrize("C", [96, 128])
def test_p1_branch_goes_to_k1(C):
    """P = 128 // C = 1: the stage is K1's on the transposed input, as in
    JAX (checked against its interpret-mode kernel, 2-chain config)."""
    ks, dils = (3, 7), ((1, 3), (1, 3))
    x, weights = _stage(C, 2, 150, ks, dils, seed=C)
    want = np.asarray(mrf_pallas.fused_mrf_stage_phase(
        jnp.asarray(x), tuple(map(jnp.asarray, weights)), kernel_sizes=ks, dilations=dils,
        interpret=True))
    w = mrf.pack_mrf_weights(list(map(torch.from_numpy, weights)))
    got = mrf_phase.fused_mrf_stage_phase(torch.from_numpy(x), w, ks, dils)
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5)
    k1 = mrf.fused_mrf_stage(torch.from_numpy(x).transpose(1, 2).contiguous(), w, ks, dils)
    assert torch.equal(got, k1.transpose(1, 2))
    assert mrf_phase.fused_mrf_stage_phase_reference(torch.from_numpy(x), w, ks, dils).shape \
        == x.shape  # the packing at P = 1 as well


def test_kernel_geometry_and_argument_checks():
    """K3's launch (K1's tile and threads: two shared buffers of t_tile +
    128 rows of C + 8 floats beside the weight ring, two consumer
    warpgroups and the producer's), and its refusals; K1's tiles up to
    C = 128 (conv-1 buffer in global scratch above C = 80). The tiles are
    those of the fewest waves times rows computed (``mrf.conv_rows``), up
    to the largest that fits."""
    assert mrf_phase.launch_geometry(64, 10**6, B=8) == (208, 384)  # the largest: 672 x 288 B
    assert mrf_phase.launch_geometry(32, 10**6, B=8) == (496, 384)  # 544 fits; 496: fewer rows
    assert mrf_phase.launch_geometry(16, 10**6, B=8) == (880, 384)  # 1,024 fits
    assert mrf_phase.launch_geometry(32, 100) == (64, 384)  # MIN_TILE
    assert mrf_phase.launch_geometry(64, 8192, B=8) == (176, 384)
    assert mrf_phase.launch_geometry(32, 10**6, 1, 256) == (256, 384)
    assert mrf_phase.launch_geometry(64, 10**6, 1, 256) == (208, 384)  # clamped
    with pytest.raises(ValueError, match="multiple of 16"):
        mrf_phase.launch_geometry(64, 10**6, 1, 40)
    assert [mrf.pick_t_tile(C, 10**6, B=8) for C in (80, 96, 112, 128)] == [128, 304, 224, 176]
    assert [mrf.hb_in_global(C) for C in (32, 64, 80, 96, 128)] == [False] * 3 + [True] * 2
    with pytest.raises(ValueError, match="too wide"):
        mrf.pick_t_tile(256, 1000)

    x, weights = _stage(32, 1, 40)
    xt, wt = torch.from_numpy(x), mrf.pack_mrf_weights(list(map(torch.from_numpy, weights)))
    assert mrf_phase._check(xt, wt, KS, DILS) == (3, 3)
    with pytest.raises(ValueError, match="pack_mrf_weights"):
        mrf_phase._check(xt, tuple(map(torch.from_numpy, weights)), KS, DILS)
    with pytest.raises(ValueError, match="multiple of 16"):
        mrf_phase._check(torch.zeros(1, 40, 24), wt, KS, DILS)
    with pytest.raises(ValueError, match="float32"):
        mrf_phase._check(xt.double(), wt, KS, DILS)
    with pytest.raises(ValueError, match="contiguous"):
        mrf_phase._check(torch.zeros(1, 80, 32)[:, ::2], wt, KS, DILS)
    with pytest.raises(ValueError, match="built for"):
        mrf_phase._check(xt, wt, (3, 5, 11), DILS)
    with pytest.raises(ValueError, match="runs on CUDA or CPU"):
        mrf_phase.fused_mrf_stage_phase(xt.to("meta"), wt)
    with pytest.raises(ValueError, match="t_tile"):
        mrf_phase.fused_mrf_stage_phase(xt, wt, t_tile=100)


@pytest.mark.parametrize("C", [16, 32, 48, 64])
def test_k3_tile_is_k1s(C):
    """K3 keeps K1's rows at C <= 64, so it takes K1's tile, batch-aware,
    explicit tiles clamped alike."""
    for B in (1, 8):
        for T in (100, 8192, 10**6):
            assert mrf_phase.launch_geometry(C, T, B)[0] == mrf.pick_t_tile(C, T, B=B)
        assert mrf_phase.launch_geometry(C, 10**6, B, 2048)[0] == \
            mrf.pick_t_tile(C, 10**6, 2048, B) == mrf._most_tile(C, 2)


def _generator_128():
    """A port generator with a C = 128 stage and two narrow ones (64, 32)."""
    torch.manual_seed(0)
    return Generator(HiFiGANConfig(upsample_initial_channel=256, upsample_rates=(2, 2, 2),
                                   upsample_kernel_sizes=(4, 4, 4))).eval()


@pytest.mark.parametrize("fn,C,t_tile", [
    ("fused_mrf_stage", 32, 2048), ("fused_mrf_stage", 64, 256), ("fused_mrf_stage", 128, 1024),
    ("fused_mrf_stage_phase", 32, 2048), ("fused_mrf_stage_phase", 64, 1024),
    ("generator_apply_fused", 128, 256), ("generator_apply_fused", 128, 2048)])
def test_explicit_tile_above_the_largest_is_clamped(fn, C, t_tile):
    """A tile that JAX runs (its default 2048, its pick_t_tile(128) = 1024,
    256 at C = 64) is clamped to the largest that fits, not refused: the
    result equals the default tile's."""
    if fn == "generator_apply_fused":
        gen = _generator_128()
        mel = torch.from_numpy(np.random.default_rng(C).normal(size=(2, 8, 80)).astype(np.float32))
        weights = fused_stage_weights(gen, C)
        got, want = (generator_apply_fused(gen, mel, weights, max_fused_channels=C,
                                           narrow_impl="phase", t_tile=t) for t in (t_tile, None))
    else:
        x, weights = _stage(C, 2, 300, seed=C)
        w = mrf.pack_mrf_weights(list(map(torch.from_numpy, weights)))
        xt = torch.from_numpy(x)
        if fn == "fused_mrf_stage":
            xt = xt.transpose(1, 2).contiguous()
        stage = getattr(mrf if fn == "fused_mrf_stage" else mrf_phase, fn)
        got, want = stage(xt, w, t_tile=t_tile), stage(xt, w)
        assert mrf.pick_t_tile(C, 10**6, t_tile) == mrf._most_tile(C, 1 if mrf.hb_in_global(C) else 2)
    assert torch.equal(got, want)
