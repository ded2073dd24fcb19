"""The port's serving precision against the JAX package, on the CPU:
``synthesise(compute_dtype=bf16)`` with the decoder alone cast, the f32
noise draw, K1's bf16-product plain version, the hybrid generator with a
bf16 mel and bf16 weights, ``TTSPipeline``'s ``vocoder_bf16``,
``bf16_latency`` and ``vocoder_pallas=False`` on every serving path, and
the four CLI flags and the two daemon flags.

Both packages read the fabricated checkpoints of tests/test_cli_e2e.py (a
tiny Matcha with the full-width HiFi-GAN v1); the noise is JAX's draw,
handed to the port. bf16 rounds at other places in the two frameworks
(flax computes layer norms and the time MLP in f32, JAX's CPU vocoder runs
every stage in bf16 where the port's fused stages keep f32 inside), so
each bf16 case is held to JAX's bf16 output and, in both packages, to the
f32 output within JAX's own bounds (tests/test_model_smoke.py,
tests/test_cli_e2e.py, tests/test_mrf_pallas.py). Durations and mel
lengths must be equal in every mode.
"""

import copy
import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from matcha_tpu import cli as jax_cli
from matcha_tpu.models.hifigan import Generator as JaxGenerator
from matcha_tpu.models.hifigan import HiFiGANConfig as JaxHiFiGANConfig
from matcha_tpu.models.hifigan_pallas import generator_apply_pallas
from matcha_tpu.models.matcha import MatchaTTS as JaxMatchaTTS
from matcha_tpu.ops.mrf_pallas import fused_mrf_stage as jax_fused_mrf_stage
from matcha_tpu_torch import cli as port_cli
from matcha_tpu_torch import pipeline as port_pipeline
from matcha_tpu_torch import serve
from matcha_tpu_torch.convert import hifigan_state_dict
from matcha_tpu_torch.models.components.flow_matching import cfm_sample
from matcha_tpu_torch.models.denoiser import denoise
from matcha_tpu_torch.models.hifigan import Generator, HiFiGANConfig
from matcha_tpu_torch.models.hifigan_fused import fused_stage_weights, generator_apply_fused
from matcha_tpu_torch.models.matcha import decoder_cast
from matcha_tpu_torch.ops import mrf
from matcha_tpu_torch.utils.utils import PCM24_SCALE
from tests.test_cli_e2e import fabricated_ckpts  # noqa: F401  (module fixture)
from tests.test_torch_corpus import _corpus, _jax_noise
from tests.test_torch_fused import CLEANER, MEL_TOL, WAV_TOL, _ids, _noise, loaded  # noqa: F401

BF16 = torch.bfloat16
SHORT = "Precision check."
# the bf16 mel against the f32 one (JAX's bound, tests/test_model_smoke.py)
MEL16_MAX, MEL16_MEAN = 0.3, 0.05
# a bf16 vocoder's waveform against the f32 one, mean (JAX's bounds,
# tests/test_cli_e2e.py: random weights sit in tanh's chaotic regime, so
# the mean, not the max, bounds the audible effect)
WAV16_VOCODER_MEAN, WAV16_LATENCY_MEAN = 0.02, 0.03


def _mean_max(a, b):
    d = np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64))
    return d.mean(), d.max()


@pytest.fixture(scope="module")
def jax_pipes(loaded):  # noqa: F811
    """JAX pipelines by mode, built once for the module (each compiles a
    shape once)."""
    model, params, voc, voc_params, bias = loaded["jax"]

    def make(**kw):
        return jax_cli.TTSPipeline(model, params, voc, voc_params, bias, CLEANER, **kw)

    return {"f32": make(), "bf16": make(vocoder_bf16=True),
            "bf16_chunk": make(vocoder_bf16=True, vocoder_chunk=48),
            "latency": make(bf16_latency=True)}


def _port(loaded, **kw):  # noqa: F811
    port_model, port_voc, port_bias = loaded["port"]
    return port_pipeline.TTSPipeline(port_model, port_voc, port_bias, CLEANER, device="cpu", **kw)


# ---------------------------------------------------------------------------
# the model: compute_dtype, the decoder copy, the noise
# ---------------------------------------------------------------------------


def test_synthesise_bf16_matches_jax(loaded):  # noqa: F811
    """``synthesise(compute_dtype=bf16)`` on ``decoder_cast``'s copy
    against JAX's on its decoder-cast params, same noise: mel_lengths and
    the alignment equal to f32 in both; the bf16 mel within 0.05 (max) and
    5e-3 (mean) of JAX's (measured ~1.6e-2 / 1.5e-3 here: the two round
    the U-Net in other places) and, in each package, within JAX's bound of
    its own f32 mel."""
    model, params, *_ = loaded["jax"]
    port_model = loaded["port"][0]
    x, xl = _ids(SHORT)
    key = jax.random.PRNGKey(4)
    kw = dict(n_timesteps=1, temperature=0.667, y_max_length=64)

    cast = lambda t: jax.tree.map(lambda a: a.astype(jnp.bfloat16) if a.dtype == jnp.float32
                                  else a, t)
    p16 = {"params": {k: (cast(v) if k == "decoder" else v) for k, v in params["params"].items()}}
    synth = jax.jit(functools.partial(model.apply, method=JaxMatchaTTS.synthesise, **kw),
                    static_argnames=("compute_dtype",))
    want32, want16 = (synth(p, jnp.asarray(x), jnp.asarray(xl), key, compute_dtype=cd)
                      for p, cd in ((params, None), (p16, jnp.bfloat16)))

    lat = decoder_cast(port_model, BF16)
    assert {p.dtype for p in lat.decoder.parameters()} == {BF16}
    assert {p.dtype for p in lat.encoder.parameters()} == {torch.float32}
    assert lat.encoder is port_model.encoder and lat.mel_mean is port_model.mel_mean
    assert {p.dtype for p in port_model.decoder.parameters()} == {torch.float32}
    z = _noise(key)(64)
    xt, xlt = torch.from_numpy(x).long(), torch.from_numpy(xl)
    got32 = port_model.synthesise(xt, xlt, z=z, **kw)
    got16 = lat.synthesise(xt, xlt, z=z, compute_dtype=BF16, **kw)

    assert got16["mel"].dtype == torch.float32
    for got, want in ((got32, want32), (got16, want16)):
        np.testing.assert_array_equal(got["mel_lengths"].numpy(), np.asarray(want["mel_lengths"]))
        np.testing.assert_array_equal(got["attn"].numpy(), np.asarray(want["attn"]))
    np.testing.assert_array_equal(got16["mel_lengths"].numpy(), got32["mel_lengths"].numpy())
    np.testing.assert_allclose(got32["mel"].numpy(), np.asarray(want32["mel"]), atol=MEL_TOL)
    mean, most = _mean_max(got16["mel"], want16["mel"])
    assert most < 0.05 and mean < 5e-3, (most, mean)
    for m16, m32 in ((got16["mel"], got32["mel"]), (want16["mel"], want32["mel"])):
        mean, most = _mean_max(m16, m32)
        assert np.isfinite(np.asarray(m16)).all() and most < MEL16_MAX and mean < MEL16_MEAN

    with pytest.raises(ValueError, match="decoder_cast"):
        port_model.synthesise(xt, xlt, z=z, compute_dtype=BF16, **kw)


def test_bf16_flow_stays_bf16_but_its_time_mlp_is_f32(loaded):  # noqa: F811
    """No layer of the bf16 decoder hands back f32 but the sinusoidal
    embedding and its MLP (the MLP and its two Linear layers), as in JAX
    (whose MLP output is cast)."""
    lat = decoder_cast(loaded["port"][0], BF16)
    f32 = set()
    hooks = [m.register_forward_hook(
        lambda mod, inp, out, name=name: f32.add(name) if out.dtype == torch.float32 else None)
        for name, m in lat.decoder.named_modules()]
    try:
        x, xl = _ids(SHORT)
        lat.synthesise(torch.from_numpy(x).long(), torch.from_numpy(xl), n_timesteps=1,
                       y_max_length=64, z=torch.zeros(1, 64, 80), compute_dtype=BF16)
    finally:
        for h in hooks:
            h.remove()
    assert f32 == {"estimator.time_embeddings", "estimator.time_mlp",
                   "estimator.time_mlp.linear_1", "estimator.time_mlp.linear_2"}, sorted(f32)


def test_cfm_noise_is_drawn_in_f32_then_cast():
    """``cfm_sample`` draws z in f32 and casts it to mu's type (JAX's
    ``normal(f32).astype(mu.dtype)``): with a zero vector field the bf16
    flow ends at the f32 draw rounded, times the temperature, and stays
    bf16 through the Euler loop."""
    mu = torch.zeros(2, 16, 8)
    mask = torch.ones(2, 16, 1)

    def zero_field(x, mask, mu, t, spks=None):
        return torch.zeros_like(x)

    z32 = torch.randn(mu.shape, generator=torch.Generator().manual_seed(5))
    got32 = cfm_sample(zero_field, mu, mask, 3, 0.5, generator=torch.Generator().manual_seed(5))
    got16 = cfm_sample(zero_field, mu.to(BF16), mask.to(BF16), 3, 0.5,
                       generator=torch.Generator().manual_seed(5))
    assert got16.dtype == BF16 and got32.dtype == torch.float32
    torch.testing.assert_close(got32, z32 * 0.5, rtol=0, atol=0)
    torch.testing.assert_close(got16, z32.to(BF16) * 0.5, rtol=0, atol=0)


# ---------------------------------------------------------------------------
# K1's bf16 products and the hybrid generator in bf16
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("C", [16, 64])
def test_k1_bf16_plain_matches_pallas_interpret(C):
    """K1's plain version with ``compute_dtype=bf16`` against the Pallas
    kernel's (interpret mode) at T = 400 (not a tile multiple): within
    2e-4 max and 1e-5 mean on unit activations (measured up to 8.7e-5 /
    2.8e-6: f32 sums in another order move a few operands across a bf16
    rounding boundary), while bf16 products move the stage over 10x more
    (mean ~1.2e-4) from the f32 one. The CPU path launches no kernel."""
    rng = np.random.default_rng(C)
    x = rng.normal(size=(2, C, 400)).astype(np.float32)
    weights = [(rng.normal(size=s) * (0.3 / np.sqrt(k * C) if len(s) == 4 else 0.1))
               .astype(np.float32) for k in (3, 7, 11) for s in ((3, k, C, C), (3, C)) * 2]
    want = np.asarray(jax_fused_mrf_stage(jnp.asarray(x), tuple(map(jnp.asarray, weights)),
                                          t_tile=256, interpret=True,
                                          compute_dtype=jnp.bfloat16))
    packed = mrf.pack_mrf_weights([torch.from_numpy(w) for w in weights])
    launches = dict(mrf.LAUNCHES)
    got = mrf.fused_mrf_stage(torch.from_numpy(x), packed, compute_dtype=BF16)
    f32 = mrf.fused_mrf_stage(torch.from_numpy(x), packed)
    assert mrf.LAUNCHES == launches
    mean, most = _mean_max(got, want)
    assert most < 2e-4 and mean < 1e-5, (most, mean)
    assert _mean_max(got, f32)[0] > 10 * mean
    with pytest.raises(ValueError, match="compute_dtype"):
        mrf.fused_mrf_stage(torch.from_numpy(x), packed, compute_dtype=torch.float16)


@pytest.fixture(scope="module")
def small_gen():
    """The generator of tests/test_mrf_pallas.py's bf16 case (stages of
    C = 32 and 16, both fused), flax and port sharing weights, and a
    seeded mel."""
    kw = dict(upsample_rates=(4, 2), upsample_kernel_sizes=(8, 4), upsample_initial_channel=64)
    jgen = JaxGenerator(JaxHiFiGANConfig(**kw))
    mel = np.random.default_rng(3).normal(size=(1, 24, 80)).astype(np.float32)
    params = jax.jit(jgen.init)(jax.random.PRNGKey(0), jnp.asarray(mel))
    tgen = Generator(HiFiGANConfig(**kw))
    tgen.load_state_dict(hifigan_state_dict(params))
    return jgen.config, params, tgen.eval(), mel


def test_hybrid_generator_bf16_matches_pallas(small_gen):
    """A bf16 mel into bf16 weights: cuDNN-side convs in bf16, the fused
    stages f32 inside on the bf16 weights upcast, as
    ``generator_apply_pallas(p16, mel16)``; within 1e-2 of it (measured
    2.0e-3 on a tanh output up to 0.40: bf16 convs round in another order)
    and within JAX's 5e-2 of the f32 generator."""
    h, params, tgen, mel = small_gen
    ref = np.asarray(JaxGenerator(h).apply(params, jnp.asarray(mel)))
    p16 = jax.tree.map(lambda a: a.astype(jnp.bfloat16), params)
    pallas = jax.jit(lambda p, m: generator_apply_pallas(p, h, m, t_tile=128, interpret=True))
    want16 = np.asarray(pallas(p16, jnp.asarray(mel).astype(jnp.bfloat16))).astype(np.float32)
    gen16 = copy.deepcopy(tgen).to(BF16)
    weights16 = fused_stage_weights(gen16)
    assert all(w.dtype == torch.float32 for ws in weights16.values() for w in ws)
    got16 = generator_apply_fused(gen16, torch.from_numpy(mel).to(BF16), weights16)
    assert got16.dtype == BF16 and got16.shape == (1, 24 * 8, 1)
    got16 = got16.float().numpy()
    assert np.abs(got16 - want16).max() < 1e-2
    np.testing.assert_allclose(got16, ref, atol=5e-2)
    np.testing.assert_allclose(want16, ref, atol=5e-2)


def test_all_cudnn_route_matches_the_plain_generator(small_gen):
    """``max_fused_channels=0`` (``--no-pallas-vocoder``) is the plain
    generator, in f32 and in bf16, and f32 matches flax's (2e-6, the f32
    tolerance of tests/test_torch_vocoder.py)."""
    h, params, tgen, mel = small_gen
    m = torch.from_numpy(mel)
    got = generator_apply_fused(tgen, m, max_fused_channels=0)
    torch.testing.assert_close(got, tgen(m), rtol=0, atol=0)
    np.testing.assert_allclose(got.numpy(), np.asarray(JaxGenerator(h).apply(
        params, jnp.asarray(mel))), atol=2e-6)
    gen16 = copy.deepcopy(tgen).to(BF16)
    torch.testing.assert_close(generator_apply_fused(gen16, m.to(BF16), max_fused_channels=0),
                               gen16(m.to(BF16)), rtol=0, atol=0)


# ---------------------------------------------------------------------------
# TTSPipeline: every serving path with vocoder_bf16, bf16_latency, no fused MRF
# ---------------------------------------------------------------------------


def _held(got, want, want32, mean_bound, got32=None):
    """The bf16 waveform against JAX's bf16 one (the mean within twice
    JAX's own bf16-to-f32 bound) and, in each package, against f32 within
    that bound; the mel lengths equal."""
    np.testing.assert_array_equal(np.asarray(got["mel_lengths"]), np.asarray(want["mel_lengths"]))
    w, wj = np.asarray(got["waveform"]), np.asarray(want["waveform"])
    assert w.dtype == np.float32 and w.shape == wj.shape and np.isfinite(w).all()
    assert _mean_max(w, wj)[0] < 2 * mean_bound
    assert _mean_max(wj, want32["waveform"])[0] < mean_bound
    if got32 is not None:
        np.testing.assert_array_equal(np.asarray(got["mel_lengths"]),
                                      np.asarray(got32["mel_lengths"]))
        assert _mean_max(w, got32["waveform"])[0] < mean_bound


def test_vocoder_bf16_dynamic_and_fixed_bucket_match_jax(loaded, jax_pipes):  # noqa: F811
    """``vocoder_bf16`` on the dynamic path and the fixed-bucket body
    (eager on the CPU), against JAX's ``vocoder_bf16`` pipeline: the mel is
    the f32 path's (1e-5), the vocoder's copy is bf16 and the caller's
    generator stays f32, the denoiser bias is the f32 one."""
    x, xl = _ids(SHORT)
    key = jax.random.PRNGKey(2)
    port16, port32 = _port(loaded, vocoder_bf16=True), _port(loaded)
    assert port16.vocoder.conv_pre.weight.dtype == BF16
    assert loaded["port"][1].conv_pre.weight.dtype == torch.float32
    assert port16.denoiser_bias.dtype == torch.float32
    for kw in (dict(), dict(fixed_y_bucket=128)):
        want32 = jax_pipes["f32"].synthesise_batch(x, xl, key, n_timesteps=1, **kw)
        want = jax_pipes["bf16"].synthesise_batch(x, xl, key, n_timesteps=1, **kw)
        got = port16.synthesise_batch(x, xl, n_timesteps=1, z=_noise(key), **kw)
        got32 = port32.synthesise_batch(x, xl, n_timesteps=1, z=_noise(key), **kw)
        np.testing.assert_allclose(got["mel"].numpy(), np.asarray(want["mel"]), atol=MEL_TOL)
        _held(got, want, want32, WAV16_VOCODER_MEAN, got32)
    wavs, mls = port_pipeline.fetch_fused_host(got)
    np.testing.assert_array_equal(mls, got["mel_lengths"].numpy())
    np.testing.assert_allclose(wavs, np.clip(got["waveform"].numpy(), -1, 1),
                               atol=2.0 / PCM24_SCALE)


def test_vocoder_bf16_staged_corpus_matches_jax(loaded, jax_pipes):  # noqa: F811
    """``synthesise_corpus`` with ``vocoder_bf16``, split and with the
    fused stage (eager on the CPU), against JAX's: the same batches and
    host lengths, each batch's waveform held as on the other paths."""
    utts = _corpus(seed=21, n=4)
    key = jax.random.PRNGKey(13)
    kw = dict(n_timesteps=1, batch_size=4)
    want32 = list(jax_pipes["f32"].synthesise_corpus(utts, key, **kw))
    want = list(jax_pipes["bf16"].synthesise_corpus(utts, key, **kw))
    port16 = _port(loaded, vocoder_bf16=True)
    for fuse in (False, True):
        got = list(port16.synthesise_corpus(utts, fuse_stages=fuse, z=_jax_noise(key), **kw))
        assert [c for c, _ in got] == [c for c, _ in want]
        for (_, g), (_, w), (_, w32) in zip(got, want, want32):
            np.testing.assert_array_equal(g["mel_lengths_host"], w["mel_lengths_host"])
            _held(g, w, w32, WAV16_VOCODER_MEAN)


def test_vocoder_bf16_chunked_matches_jax(loaded, jax_pipes):  # noqa: F811
    """``--vocoder-chunk 48`` with ``vocoder_bf16`` (3 windows of the
    128-frame vocoder bucket): each window in bf16 and back to f32 before
    the clip, against JAX's chunked bf16 pipeline; and within the f32
    bound of the port's unchunked bf16 vocoder."""
    x, xl = _ids(SHORT)
    key = jax.random.PRNGKey(2)
    kw = dict(n_timesteps=1)
    want32 = jax_pipes["f32"].synthesise_batch(x, xl, key, **kw)
    want = jax_pipes["bf16_chunk"].synthesise_batch(x, xl, key, **kw)
    got = _port(loaded, vocoder_bf16=True, vocoder_chunk=48).synthesise_batch(
        x, xl, z=_noise(key), **kw)
    assert got["waveform"].shape[-1] == 128 * 256, "the vocoder bucket is not 3 windows"
    whole = _port(loaded, vocoder_bf16=True).synthesise_batch(x, xl, z=_noise(key), **kw)
    _held(got, want, want32, WAV16_VOCODER_MEAN, whole)


def test_bf16_latency_fixed_bucket_matches_jax(loaded, jax_pipes):  # noqa: F811
    """``bf16_latency``: the fixed-bucket body runs the Euler loop on the
    bf16 decoder copy and the vocoder in bf16 (JAX's
    test_bf16_latency_fused_close_to_f32): equal mel lengths, the mel
    within 5e-2 of JAX's bf16 mel, the waveform held within JAX's 0.03;
    the dynamic path stays f32."""
    x, xl = _ids(SHORT)
    key = jax.random.PRNGKey(0)
    kw = dict(n_timesteps=2, fixed_y_bucket=64)
    lat = _port(loaded, bf16_latency=True)
    assert {p.dtype for p in lat.latency_model.decoder.parameters()} == {BF16}
    assert lat.model.decoder.estimator.final_proj.weight.dtype == torch.float32
    assert lat.vocoder.conv_pre.weight.dtype == torch.float32
    want32 = jax_pipes["f32"].synthesise_batch(x, xl, key, **kw)
    want = jax_pipes["latency"].synthesise_batch(x, xl, key, **kw)
    got = lat.synthesise_batch(x, xl, z=_noise(key), **kw)
    got32 = _port(loaded).synthesise_batch(x, xl, z=_noise(key), **kw)
    assert np.abs(got["mel"].numpy() - np.asarray(want["mel"])).max() < 5e-2
    _held(got, want, want32, WAV16_LATENCY_MEAN, got32)
    dyn = lat.synthesise_batch(x, xl, n_timesteps=2, z=_noise(key))
    ref = jax_pipes["f32"].synthesise_batch(x, xl, key, n_timesteps=2)
    np.testing.assert_allclose(dyn["waveform"].numpy(), np.asarray(ref["waveform"]),
                               atol=WAV_TOL)


def test_no_pallas_vocoder_is_the_plain_generator(loaded, jax_pipes):  # noqa: F811
    """``vocoder_pallas=False`` packs no kernel weights and vocodes with
    the plain generator on every path (dynamic, fixed-bucket, chunked):
    its waveform equals the plain ``Generator`` + clip + denoiser on the
    same mel, and JAX's (whose CPU vocoder is flax's ``apply``) within
    5e-4."""
    x, xl = _ids(SHORT)
    key = jax.random.PRNGKey(3)
    for kw in (dict(), dict(fixed_y_bucket=128)):
        for chunk in (0, 48):
            pipe = _port(loaded, vocoder_pallas=False, vocoder_chunk=chunk)
            assert pipe.max_fused_channels == 0 and pipe.vocoder_weights == {}
            got = pipe.synthesise_batch(x, xl, n_timesteps=1, z=_noise(key), **kw)
            mel = got["mel"].transpose(1, 2)[:, :got["waveform"].shape[-1] // 256]
            plain = denoise(torch.clamp(pipe.vocoder(mel)[..., 0], -1, 1),
                            pipe.denoiser_bias, strength=pipe.denoiser_strength)
            if not chunk:
                torch.testing.assert_close(got["waveform"], plain, rtol=0, atol=0)
            want = jax_pipes["f32"].synthesise_batch(x, xl, key, n_timesteps=1, **kw)
            np.testing.assert_allclose(got["waveform"].numpy(), np.asarray(want["waveform"]),
                                       atol=WAV_TOL)


# ---------------------------------------------------------------------------
# the CLI and the daemon
# ---------------------------------------------------------------------------


@pytest.fixture
def tf32_restored(monkeypatch):
    """The TF32 flags as they were, after the test."""
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", torch.backends.cudnn.allow_tf32)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32",
                        torch.backends.cuda.matmul.allow_tf32)


@pytest.mark.parametrize("flags,tf32_off", [
    (["--full-precision", "--fixed-y-bucket", "128", "--bf16-latency", "--bf16-vocoder"], True),
    (["--no-pallas-vocoder", "--bf16-vocoder"], False)])
def test_cli_precision_flags(fabricated_ckpts, tmp_path, monkeypatch, tf32_restored,  # noqa: F811
                             flags, tf32_off):
    """The four flags with ``--cpu`` reach the pipeline and write a wav;
    ``--full-precision`` turns TF32 off for convs and matmuls, and without
    it the CLI leaves torch's flags as they were."""
    monkeypatch.setenv("MATCHA_HOME", fabricated_ckpts)
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = True
    seen = {}
    make = port_pipeline.TTSPipeline

    def spy(*a, **kw):
        seen.update(kw)
        return make(*a, **kw)

    monkeypatch.setattr(port_cli, "TTSPipeline", spy)
    args = port_cli.build_parser().parse_args(["--text", "x", *flags])
    port_cli.cli(["--text", "hello", "--cleaner", CLEANER, "--steps", "1", "--cpu",
                  "--output_folder", str(tmp_path), *flags])
    assert (tmp_path / "utterance_001.wav").exists()
    assert seen["vocoder_bf16"] == args.bf16_vocoder is True
    assert seen["vocoder_pallas"] is not args.no_pallas_vocoder
    assert seen["bf16_latency"] == args.bf16_latency
    assert torch.backends.cudnn.allow_tf32 is not tf32_off
    assert torch.backends.cuda.matmul.allow_tf32 is not tf32_off


def test_not_ported_holds_only_data_parallel_and_spk():
    """``--spk`` and ``--data-parallel`` are both ported: the daemon has
    no list of refused flags left, and the single-request fast path is
    off for a pipeline of more than one replica (JAX gates it on
    ``mesh is None``)."""
    assert not hasattr(serve, "NOT_PORTED")
    for flag in ("--spk", "--data-parallel"):
        assert flag in serve.build_parser().format_help()

    calls = []

    class Pipeline:
        pcm24_transfer, _dur_ratio = False, None
        fit_y_bucket = port_pipeline.TTSPipeline.fit_y_bucket

        def __init__(self, n):
            self.replicas = [None] * n

        def synthesise_batch(self, x, x_lengths, **kw):
            calls.append(kw.get("fixed_y_bucket", 0))
            raise RuntimeError("stop here")

    for n in (1, 2):
        b = serve.BatchingServer.__new__(serve.BatchingServer)
        b.pipeline, b._fused_warm, b._warm_x = Pipeline(n), {(128, 1.0, False): [512]}, [128]
        b.n_timesteps, b.temperature, b._next_generator = 1, 0.667, lambda: None
        req = serve._Request(seq=np.arange(1, 9, dtype=np.int32), speaking_rate=1.0, spk=None)
        with pytest.raises(RuntimeError, match="stop here"):
            b._run([req], 1.0, None)
    # one replica: a replay of the warmed 512 graph; two: the dynamic path
    assert calls == [512, 0]


@pytest.mark.parametrize("flag,bf16,pallas", [("--bf16-vocoder", True, True),
                                              ("--no-pallas-vocoder", False, False)])
def test_daemon_precision_flags_reach_the_pipeline(fabricated_ckpts, monkeypatch,  # noqa: F811
                                                   flag, bf16, pallas):
    """``serve.main`` with ``--bf16-vocoder`` or ``--no-pallas-vocoder``
    builds its pipeline in that mode (the server stops at once)."""
    monkeypatch.setenv("MATCHA_HOME", fabricated_ckpts)
    seen = {}

    class Stop:
        server_address = ("127.0.0.1", 0)

        def serve_forever(self):
            raise KeyboardInterrupt

        def server_close(self):
            pass

    def fake_server(batcher, host, port):
        seen["pipeline"] = batcher.pipeline
        return Stop()

    monkeypatch.setattr(serve, "make_http_server", fake_server)
    serve.main(["--cpu", "--warmup", "", "--cleaner", CLEANER, flag])
    p = seen["pipeline"]
    assert (p.vocoder_bf16, p.vocoder_pallas) == (bf16, pallas)
    assert p.vocoder.conv_pre.weight.dtype == (BF16 if bf16 else torch.float32)
    assert p.bf16_latency is False and os.environ["MATCHA_HOME"] == fabricated_ckpts
