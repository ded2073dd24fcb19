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
    # two buffers of t_tile + 128 rows, three 32-row margins and a 16-row
    # tail, rows of C + 4 f32: 848 x 272 = 230,656 B at C = 64 (t_tile 256
    # would need 239,360 B); 1,584 x 144 = 228,096 B at C = 32
    assert mrf._most_tile(64, 2) == 240
    assert mrf._most_tile(32, 2) == 608
    # one request's narrow stages (B = 1): tiles that fill the 132 SMs in
    # whole waves; at B = 8 the largest that fits
    assert mrf.pick_t_tile(64, 32768) == 128  # 256 blocks: 2 waves of 256 rows
    assert mrf.pick_t_tile(32, 65536) == 512  # 128 blocks: 1 wave
    assert mrf.pick_t_tile(64, 131072, B=8) == 240
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
