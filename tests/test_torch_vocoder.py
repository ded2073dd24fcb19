"""The port's vocoder path against the JAX package: the fused MRF stage
(kernel K1's plain version on the CPU), the plain and the hybrid HiFi-GAN
generator, and STFT / iSTFT / denoiser.

The CUDA kernel itself is held against the plain version on a GPU by
tests/test_torch_kernels_cuda.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from matcha_tpu.audio.stft import istft as jax_istft
from matcha_tpu.audio.stft import stft_magnitude_phase as jax_stft
from matcha_tpu.models.denoiser import compute_bias_spec as jax_bias_spec
from matcha_tpu.models.denoiser import denoise as jax_denoise
from matcha_tpu.models.hifigan import Generator as JaxGenerator
from matcha_tpu.models.hifigan import HiFiGANConfig as JaxHiFiGANConfig
from matcha_tpu.models.hifigan import ResBlock1
from matcha_tpu.ops.mrf_pallas import fused_mrf_stage as jax_fused_mrf_stage
from matcha_tpu.ops.mrf_pallas import mrf_weights_from_params
from matcha_tpu_torch.audio.stft import istft, stft_magnitude_phase
from matcha_tpu_torch.convert import hifigan_state_dict
from matcha_tpu_torch.models.denoiser import compute_bias_spec, denoise
from matcha_tpu_torch.models.hifigan import Generator, HiFiGANConfig
from matcha_tpu_torch.models.hifigan_fused import generator_apply_fused
from matcha_tpu_torch.ops import mrf

KS, DILS = (3, 7, 11), ((1, 3, 5),) * 3


def _stage_inputs(C, B, T, seed=0):
    """Seeded activations (B, C, T) and flax-initialised ResBlock1 weights
    in the kernel layout, as numpy."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(B, T, C)).astype(np.float32)
    key = jax.random.PRNGKey(seed)
    params = [ResBlock1(C, k, (1, 3, 5)).init(jax.random.fold_in(key, n), jnp.asarray(x[:, :8]))
              for n, k in enumerate(KS)]
    weights = [np.array(w) for w in mrf_weights_from_params([p["params"] for p in params])]
    return x.transpose(0, 2, 1).copy(), weights


def test_fused_mrf_stage_plain_matches_pallas_interpret():
    """The case of tests/test_mrf_pallas.py:23-42: C=32, B=2, T=700 (not a
    tile multiple), atol 2e-5 (f32 sums in another order)."""
    x, weights = _stage_inputs(32, 2, 700)
    want = np.asarray(jax_fused_mrf_stage(jnp.asarray(x), tuple(map(jnp.asarray, weights)),
                                          t_tile=256, interpret=True))
    got = mrf.fused_mrf_stage(torch.from_numpy(x), tuple(map(torch.from_numpy, weights)))
    assert got.shape == x.shape
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5)
    assert mrf.LAUNCHES["mrf_stage"] == 0  # the CPU path launches no kernel


def test_mrf_weights_from_resblocks_match_the_plain_stage():
    gen = Generator(HiFiGANConfig(upsample_initial_channel=64, upsample_rates=(2,),
                                  upsample_kernel_sizes=(4,)))
    x = torch.from_numpy(np.random.default_rng(2).normal(size=(1, 32, 50)).astype(np.float32))
    with torch.inference_mode():
        want = gen.mrf_stage(0, x)
        got = mrf.fused_mrf_stage(x, mrf.mrf_weights_from_resblocks(gen.stage_blocks(0)))
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-6)


def test_kernel_geometry_and_argument_checks():
    assert mrf.receptive_field(KS, DILS) == 60 <= mrf.HALO
    # two buffers of t_tile + 128 rows of C + 8 f32 beside a ring of four
    # 3xTF32 weight stages (16 input channels: 128 C bytes each) and 256 B
    # for the mbarriers: 672 x 288 + 32,768 + 256 = 226,560 B at C = 64
    # (t_tile 224 would need 235,776 B); 1,344 x 160 + 16,640 = 231,680 B
    # at C = 32 (560: 236,800 B)
    assert mrf._most_tile(64, 2) == 208
    assert mrf._most_tile(32, 2) == 544
    # one request's narrow stages (B = 1): tiles that fill the 132 SMs in
    # whole waves; at B = 8 the largest that fits
    assert mrf.pick_t_tile(64, 32768) == 128  # 256 blocks: 2 waves
    assert mrf.pick_t_tile(32, 65536) == 512  # 128 blocks: 1 wave
    assert mrf.pick_t_tile(64, 131072, B=8) == 208
    assert mrf.pick_t_tile(64, 100) == 64
    assert mrf.pick_t_tile(64, 40) == 48  # no longer than T rounded up to 16
    x, weights = _stage_inputs(32, 1, 40)
    xt, wt = torch.from_numpy(x), mrf.pack_mrf_weights(list(map(torch.from_numpy, weights)))
    assert mrf._check(xt, wt, KS, DILS) == (3, 3)
    assert wt[1].data_ptr() == wt[0].data_ptr() + 4 * wt[0].numel()  # one buffer
    with pytest.raises(ValueError, match="pack_mrf_weights"):
        mrf._check(xt, tuple(map(torch.from_numpy, weights)), KS, DILS)
    with pytest.raises(ValueError, match="multiple of 16"):
        mrf._check(torch.zeros(1, 24, 40), wt, KS, DILS)
    with pytest.raises(ValueError, match="contiguous"):
        mrf._check(xt.transpose(1, 2), wt, KS, DILS)
    with pytest.raises(ValueError, match="expected"):
        mrf._check(xt, wt[:-1] + (wt[-1][:, :16],), KS, DILS)
    with pytest.raises(ValueError, match="halo"):
        mrf._check(xt, wt, (3, 7, 15), DILS)
    with pytest.raises(ValueError, match="built for"):
        mrf._check(xt, wt, (3, 5, 11), DILS)
    with pytest.raises(ValueError, match="runs on CUDA or CPU"):
        mrf.fused_mrf_stage(xt.to("meta"), wt)


@pytest.mark.parametrize("C,T", [(32, 8192), (64, 8192), (64, 32768), (128, 16384)])
def test_k1_tile_follows_the_batch(C, T):
    """A short T at B = 1 takes a smaller tile (more blocks for the SMs)
    than at B = 8, where the largest tile that fits fills the card; every
    choice is a multiple of 16 within the shared-memory budget."""
    most = mrf._most_tile(C, 1 if mrf.hb_in_global(C) else 2)
    one, eight = mrf.pick_t_tile(C, T, B=1), mrf.pick_t_tile(C, T, B=8)
    assert one < eight <= most
    assert one % mrf.TILE_STEP == eight % mrf.TILE_STEP == 0
    assert mrf.pick_t_tile(C, T, most, B=1) == most  # an explicit tile is kept
    assert mrf.pick_t_tile(C, T, most + mrf.TILE_STEP, B=8) == most  # and clamped
    with pytest.raises(ValueError, match="t_tile"):
        mrf.pick_t_tile(C, T, 40)


# HiFi-GAN v1's and v2's MRF (the same chains), and a 2-chain stage
CHAIN_CONFIGS = {"hifigan_v1_v2": (KS, DILS), "two_chains": ((3, 7), ((1, 3), (1, 3)))}


@pytest.mark.parametrize("name", sorted(CHAIN_CONFIGS))
@pytest.mark.parametrize("t_tile", [16, 208, 544])
def test_conv_rows_cover_what_each_next_conv_reads(name, t_tile):
    """The kernel's row schedule (``mrf.conv_rows``): each conv computes
    whole 64-row tiles from the tile start minus what the chain's later
    convs reach; every conv covers the rows the next one reads, the first
    reads the chain's own receptive field (the window load; the stage's
    receptive field for the widest chain), and the last computes from the
    central tile's first row (only the tile is stored)."""
    ks, dils = CHAIN_CONFIGS[name]
    fields = []
    for k, d in zip(ks, dils):
        rows, reaches = mrf.conv_rows(t_tile, k, d), mrf.chain_reaches(k, d)
        assert len(rows) == len(reaches) == 2 * len(d)
        for i, (first, end) in enumerate(rows):
            rem = sum(reaches[i + 1:])
            assert first == -rem and (end - first) % mrf.WG_ROWS == 0
            assert t_tile + rem <= end < t_tile + rem + mrf.WG_ROWS
            if i + 1 < len(rows):  # what conv i + 1 reads, conv i stored
                nxt = rows[i + 1][0] - reaches[i + 1], t_tile + rem
                assert first <= nxt[0] and nxt[1] <= t_tile + rem
        fields.append(sum(reaches))
        assert -rows[0][0] + reaches[0] == sum(reaches)  # the window: its own field
        assert rows[-1][0] == 0  # the last conv: the central tile
    assert max(fields) == mrf.receptive_field(ks, dils) <= mrf.HALO


@pytest.mark.parametrize("C", [16, 48, 64])
def test_load_time_weight_split_is_exact(C):
    """The weights split once when packed: hi + lo == w exactly, hi with
    its 13 low mantissa bits clear (TF32), as the kernel splits its
    activations; and the staged copies follow the f32 tuple in one buffer
    (``staged_bytes`` of them)."""
    g = torch.Generator().manual_seed(C)
    w = torch.randn(3, 7, C, C, generator=g) * torch.logspace(-8, 2, C)
    hi, lo = mrf.split_tf32(w)
    assert torch.equal(hi + lo, w)
    assert not (hi.view(torch.int32) & 0x1FFF).any()
    assert (lo.abs() <= hi.abs() * 2.0 ** -11).all()
    weights = [(torch.randn(shape, generator=g) * 0.1)
               for k in KS for shape in ((3, k, C, C), (3, C), (3, k, C, C), (3, C))]
    packed = mrf.pack_mrf_weights(weights)
    assert all(torch.equal(a, b) for a, b in zip(packed, weights))
    storage = packed[0].untyped_storage()
    tuple_bytes = 4 * sum(x.numel() for x in weights)
    assert storage.nbytes() == tuple_bytes + mrf.staged_bytes(weights)


def _read_stage(buf: bytes, stage: int, C: int, bf16: bool) -> torch.Tensor:
    """One weight stage as the kernel's products read it: for each k step
    the (K, N) matrix at the descriptor's start + 256 B per step, core
    matrices of 8 rows x 16 B, 128 B apart along K and SBO apart along N;
    3xTF32 stages are a hi tile then a lo tile. Returns (steps, [hi, lo,]
    K, N) as f32."""
    kc = mrf.bf16_stage_channels(C) if bf16 else mrf.TF32_KC
    per = 8 if bf16 else 4  # elements of a core matrix row (16 B)
    step_k, sbo = 2 * per, kc // per * 128
    esize, tiles = (2, 1) if bf16 else (4, 2)
    start = stage * tiles * C * kc * esize
    kk, n = torch.meshgrid(torch.arange(step_k), torch.arange(C), indexing="ij")
    out = []
    for step in range(kc // step_k):
        for tile in range(tiles):
            off = (start + tile * C * kc * esize + step * 256 + n // 8 * sbo
                   + kk // per * 128 + n % 8 * 16 + kk % per * esize)
            raw = torch.frombuffer(bytearray(buf), dtype=torch.uint8)
            idx = off.reshape(-1, 1) + torch.arange(esize)
            vals = raw[idx.reshape(-1)].reshape(-1, esize)
            vals = vals.view(torch.bfloat16).float() if bf16 else vals.view(torch.float32)
            out.append(vals.reshape(step_k, C))
    return torch.stack(out).reshape(kc // step_k, tiles, step_k, C)


@pytest.mark.parametrize("C,bf16", [(16, False), (32, False), (64, False), (16, True),
                                    (48, True), (64, True)])
def test_staged_weights_read_as_the_kernel_reads_them(C, bf16):
    """The staged copies, read through the kernel's descriptor arithmetic,
    are W.permute of the tuple's (dilation, tap, C_in, C_out) weights: per
    k step, row k of the 3xTF32 products is input channel 2k (k < 4) or
    2(k - 4) + 1 of its 8 (the channels a lane's A fragment loads as one
    float2), hi and lo; of the bf16 products the channel itself, rounded to
    bf16 (to nearest even)."""
    g = torch.Generator().manual_seed(C + bf16)
    W = torch.randn(2, 3, C, C, generator=g)
    staged = mrf.staged_bf16(W) if bf16 else mrf.staged_tf32(W)
    buf = staged.numpy().tobytes()
    kc = mrf.bf16_stage_channels(C) if bf16 else mrf.TF32_KC
    order = torch.arange(8) if bf16 else torch.tensor([0, 2, 4, 6, 1, 3, 5, 7])
    hi, lo = mrf.split_tf32(W)
    stage = 0
    for j in range(2):
        for tap in range(3):
            for ci0 in range(0, C, kc):
                got = _read_stage(buf, stage, C, bf16)
                for step in range(got.shape[0]):
                    base = ci0 + step * (16 if bf16 else 8)
                    chans = (base + torch.cat([order, order + 8]) if bf16
                             else base + order)
                    Wt = W.permute(0, 1, 3, 2)[j, tap][:, chans].T  # (K, N)
                    if bf16:
                        assert torch.equal(got[step, 0], Wt.to(torch.bfloat16).float())
                    else:
                        assert torch.equal(got[step, 0], hi.permute(0, 1, 3, 2)[j, tap][:, chans].T)
                        assert torch.equal(got[step, 1], lo.permute(0, 1, 3, 2)[j, tap][:, chans].T)
                        assert torch.equal(got[step, 0] + got[step, 1], Wt)
                stage += 1
    assert stage * (C * kc * (2 if bf16 else 8)) == staged.numel() * 4


def _small_generators(seed=0):
    """Flax and port generators sharing weights: one wide stage (C=128)
    and two narrow ones (C=64, 32) — the hybrid's two branches."""
    kw = dict(upsample_rates=(2, 2, 2), upsample_kernel_sizes=(4, 4, 4),
              upsample_initial_channel=256)
    jgen = JaxGenerator(JaxHiFiGANConfig(**kw))
    mel = np.random.default_rng(seed).normal(size=(2, 8, 80)).astype(np.float32)
    variables = jgen.init(jax.random.PRNGKey(seed), jnp.asarray(mel))
    # flax initialises biases to 0, which would make the zero-mel bias
    # spectrum vanish; give every bias seeded values
    brng = np.random.default_rng(seed + 100)
    variables = jax.tree_util.tree_map_with_path(
        lambda path, a: (jnp.asarray(brng.normal(size=a.shape).astype(np.float32) * 0.1)
                         if path[-1].key == "bias" else a), variables)
    tgen = Generator(HiFiGANConfig(**kw))
    tgen.load_state_dict(hifigan_state_dict(variables))
    return jgen, variables, tgen.eval(), mel


def test_generator_and_hybrid_match_flax():
    """tanh outputs, atol 2e-6: f32 conv sums in another order (measured
    ~2e-7)."""
    jgen, variables, tgen, mel = _small_generators()
    want = np.asarray(jgen.apply(variables, jnp.asarray(mel)))
    plain = tgen(torch.from_numpy(mel))
    hybrid = generator_apply_fused(tgen, torch.from_numpy(mel))
    assert plain.shape == want.shape == (2, 64, 1)
    np.testing.assert_allclose(plain.numpy(), want, atol=2e-6)
    np.testing.assert_allclose(hybrid.numpy(), want, atol=2e-6)


def test_stft_istft_match_jax():
    """f32 FFTs in two libraries: magnitudes (up to ~30 here) to atol
    5e-5 (measured ~6e-6), phases to 1e-4 rad where the magnitude is not
    negligible (measured ~1e-5), iSTFT to 2e-6 (measured ~2e-7)."""
    audio = np.random.default_rng(3).uniform(-0.8, 0.8, size=(2, 4096)).astype(np.float32)
    mag_j, phase_j = jax_stft(jnp.asarray(audio))
    mag_t, phase_t = stft_magnitude_phase(torch.from_numpy(audio))
    np.testing.assert_allclose(mag_t.numpy(), np.asarray(mag_j), atol=5e-5)
    big = np.asarray(mag_j) > 1e-1
    dphi = np.angle(np.exp(1j * (phase_t.numpy() - np.asarray(phase_j))))
    assert np.abs(dphi[big]).max() < 1e-4
    want = np.asarray(jax_istft(mag_j, phase_j, length=4096))
    got = istft(torch.from_numpy(np.asarray(mag_j)), torch.from_numpy(np.asarray(phase_j)),
                length=4096)
    np.testing.assert_allclose(got.numpy(), want, atol=2e-6)
    np.testing.assert_allclose(got.numpy(), audio, atol=2e-6)  # round trip
    one = istft(*stft_magnitude_phase(torch.from_numpy(audio[0])))
    assert one.shape == (4096,)


def test_bias_spectrum_and_denoise_match_jax():
    """Bias from each package's own generator on a zero mel; then denoise
    random audio with it. The bias magnitude (up to ~40 here) to rtol 2e-6
    + atol 1e-5 (measured ~8e-6 absolute), the denoised audio to atol 2e-6
    (measured ~2e-7)."""
    jgen, variables, tgen, _ = _small_generators(1)
    bias_j = jax_bias_spec(lambda m: jgen.apply(variables, m), n_frames=88)
    bias_t = compute_bias_spec(lambda m: generator_apply_fused(tgen, m), device="cpu")
    assert float(np.abs(np.asarray(bias_j)).max()) > 1.0  # a bias worth subtracting
    np.testing.assert_allclose(bias_t.numpy(), np.asarray(bias_j), rtol=2e-6, atol=1e-5)
    audio = np.random.default_rng(4).uniform(-0.5, 0.5, size=(2, 6144)).astype(np.float32)
    want = np.asarray(jax_denoise(jnp.asarray(audio), bias_j, strength=0.05))
    got = denoise(torch.from_numpy(audio), torch.from_numpy(np.asarray(bias_j)), strength=0.05)
    np.testing.assert_allclose(got.numpy(), want, atol=2e-6)
