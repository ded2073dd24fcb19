"""The vocoder's variant path against the JAX package: the subpixel
transposed conv, the generator with subpixel upsamples, the fused
generator in every combination of upsample, narrow-stage kernel and fused
cap, its prefix hooks, and the two vocoder profilers on the CPU.
"""

import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_vocoder import _small_generators

from matcha_tpu.models.components.common import (
    subpixel_conv_transpose1d as jax_subpixel_conv_transpose1d,
)
from matcha_tpu.models.hifigan import Generator as JaxGenerator
from matcha_tpu.models.hifigan import HiFiGANConfig as JaxHiFiGANConfig
from matcha_tpu.models.hifigan_pallas import generator_apply_pallas
from matcha_tpu_torch.convert import conv_transpose1d_weight, hifigan_state_dict
from matcha_tpu_torch.models.components.common import (
    SubPixelConvTranspose1d,
    subpixel_conv_transpose1d,
)
from matcha_tpu_torch.models.hifigan import Generator, HiFiGANConfig
from matcha_tpu_torch.models.hifigan_fused import fused_stage_weights, generator_apply_fused
from matcha_tpu_torch.ops import mrf, mrf_phase

REPO = Path(__file__).resolve().parents[1]


@pytest.mark.parametrize("k,u,p", [(16, 8, 4), (4, 2, 1), (16, 16, 0), (5, 3, 1), (12, 4, 4)])
def test_subpixel_matches_jax(k, u, p):
    """The (k, u, p) cases of tests/test_subpixel.py: the port's subpixel
    form on the torch ConvTranspose1d weight against JAX's on the flipped
    kernel, and against torch's own transposed conv; atol 1e-5."""
    rng = np.random.default_rng(k * 100 + u)
    cin, cout = 12, 6
    x = rng.normal(size=(2, 20, cin)).astype(np.float32)
    kern = rng.normal(size=(k, cin, cout)).astype(np.float32)
    bias = rng.normal(size=(cout,)).astype(np.float32)
    want = np.asarray(jax_subpixel_conv_transpose1d(jnp.asarray(x), jnp.asarray(kern),
                                                    jnp.asarray(bias), stride=u, padding=p))
    layer = SubPixelConvTranspose1d(cin, cout, k, u, padding=p)
    with torch.no_grad():
        layer.weight.copy_(conv_transpose1d_weight(kern))
        layer.bias.copy_(torch.from_numpy(bias))
        got = layer(torch.from_numpy(x))
        dilated = torch.nn.functional.conv_transpose1d(
            torch.from_numpy(x).transpose(1, 2), layer.weight, layer.bias, u, p).transpose(1, 2)
        cf = subpixel_conv_transpose1d(torch.from_numpy(x).transpose(1, 2), layer.weight, None,
                                       u, p, channels_first=True)
    assert got.shape == want.shape == dilated.shape
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)
    np.testing.assert_allclose(got.numpy(), dilated.numpy(), atol=1e-5)
    np.testing.assert_allclose((cf + layer.bias[:, None]).transpose(1, 2).detach().numpy(),
                               got.numpy(), atol=1e-6)


def test_subpixel_raises_where_jax_does():
    """2 * padding != k - stride: depth-to-space would emit another length."""
    with pytest.raises(ValueError, match="2\\*padding == k - stride"):
        jax_subpixel_conv_transpose1d(jnp.zeros((1, 4, 2)), jnp.zeros((5, 2, 3)), None,
                                      stride=2, padding=1)
    with pytest.raises(ValueError, match="2\\*padding == k - stride"):
        subpixel_conv_transpose1d(torch.zeros(1, 4, 2), torch.zeros(2, 3, 5), None, 2, 1)
    with pytest.raises(ValueError, match="upsample_impl"):
        Generator(upsample_impl="nearest")


def test_generator_subpixel_matches_jax():
    """The config of tests/test_subpixel.py::test_generator_impls_agree:
    one state dict loads into both impls; each against flax's subpixel
    generator, atol 2e-6 (tanh output, f32 sums in another order)."""
    cfg = dict(upsample_rates=(4, 2), upsample_kernel_sizes=(8, 4), upsample_initial_channel=16,
               resblock_kernel_sizes=(3,), resblock_dilation_sizes=((1, 2),), num_mels=8)
    jgen = JaxGenerator(JaxHiFiGANConfig(**cfg), upsample_impl="subpixel")
    variables = jax.jit(jgen.init)(jax.random.PRNGKey(0), jnp.zeros((1, 16, 8)))
    mel = np.random.default_rng(5).normal(size=(2, 16, 8)).astype(np.float32)
    want = np.asarray(jgen.apply(variables, jnp.asarray(mel)))
    state = hifigan_state_dict(variables)
    for impl in ("subpixel", "dilated"):
        gen = Generator(HiFiGANConfig(**cfg), upsample_impl=impl).eval()
        gen.load_state_dict(state)
        np.testing.assert_allclose(gen(torch.from_numpy(mel)).numpy(), want, atol=2e-6)


@pytest.fixture(scope="module")
def small():
    """The flax and port generators of tests/test_torch_vocoder.py (stages
    of C = 128, 64, 32) and flax's outputs with either upsample."""
    jgen, variables, tgen, mel = _small_generators(2)
    want = {impl: np.asarray(JaxGenerator(jgen.config, upsample_impl=impl).apply(
        variables, jnp.asarray(mel))) for impl in ("dilated", "subpixel")}
    return jgen.config, variables, tgen, mel, want


@pytest.mark.parametrize("cap", [16, 64, 128])
@pytest.mark.parametrize("narrow_impl", ["plain", "phase"])
@pytest.mark.parametrize("upsample_impl", ["dilated", "subpixel"])
def test_fused_generator_variants_match_flax(small, upsample_impl, narrow_impl, cap):
    """Every variant against flax Generator.apply with the same upsample,
    atol 2e-6; on the CPU no kernel launches."""
    _, _, tgen, mel, want = small
    launches = (mrf.LAUNCHES["mrf_stage"], mrf_phase.LAUNCHES["mrf_stage_phase"])
    got = generator_apply_fused(tgen, torch.from_numpy(mel), fused_stage_weights(tgen, cap),
                                max_fused_channels=cap, upsample_impl=upsample_impl,
                                narrow_impl=narrow_impl)
    assert got.shape == want[upsample_impl].shape == (2, 64, 1)
    np.testing.assert_allclose(got.numpy(), want[upsample_impl], atol=2e-6)
    assert (mrf.LAUNCHES["mrf_stage"], mrf_phase.LAUNCHES["mrf_stage_phase"]) == launches


def test_fused_generator_refuses_what_it_cannot_take(small):
    _, _, tgen, mel, _ = small
    m = torch.from_numpy(mel)
    with pytest.raises(ValueError, match="mel into a torch.float32 generator"):
        generator_apply_fused(tgen, m.bfloat16())
    with pytest.raises(ValueError, match="compute_dtype"):
        generator_apply_fused(tgen, m, compute_dtype=torch.float16)
    with pytest.raises(ValueError, match="no bf16-product instance"):
        generator_apply_fused(tgen, m, narrow_impl="phase", compute_dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="at most 128"):
        generator_apply_fused(tgen, m, max_fused_channels=256)
    with pytest.raises(ValueError, match="narrow_impl"):
        generator_apply_fused(tgen, m, narrow_impl="xla")
    with pytest.raises(ValueError, match="no stage 0"):
        generator_apply_fused(tgen, m, fused_stage_weights(tgen), max_fused_channels=128)
    with pytest.raises(ValueError, match="t_tile"):
        generator_apply_fused(tgen, m, t_tile=100)


def test_prefix_hooks_match_jax(small):
    """Each prefix of the stage profiler (conv_pre, + each upsample, + each
    MRF stage, + conv_post) against the JAX function's hooks with no Pallas
    stage; atol 2e-5 on activations up to ~20 (the tanh output 2e-6)."""
    h, variables, tgen, mel, _ = small
    rows = [(0, False, False)]
    for i in range(len(h.upsample_rates)):
        rows += [(i + 1, True, False), (i + 1, False, False)]
    rows.append((len(h.upsample_rates), False, True))
    weights = fused_stage_weights(tgen, 128)
    for n_stages, skip, post in rows:
        want = np.asarray(generator_apply_pallas(
            variables, h, jnp.asarray(mel), max_pallas_channels=0, n_stages=n_stages,
            skip_last_mrf=skip, with_post=post))
        for cap, impl in ((0, "plain"), (128, "phase")):
            got = generator_apply_fused(tgen, torch.from_numpy(mel), weights,
                                        max_fused_channels=cap, narrow_impl=impl,
                                        n_stages=n_stages, skip_last_mrf=skip, with_post=post)
            assert got.shape == want.shape, (n_stages, skip, post)
            np.testing.assert_allclose(got.numpy(), want, atol=2e-6 if post else 2e-5)


@pytest.mark.parametrize("script,args,expect", [
    ("profile_vocoder", [], ["full_pallas_phase_subpixel", "ups_3", "mrf_1 (C=128",
                             "mrf_phase_3 (C=32"]),
    ("profile_vocoder_stages", ["--narrow-impl", "phase", "--upsample-impl", "subpixel"],
     ["+ mrf_3", "+ conv_post/tanh"]),
])
def test_profilers_run_on_the_cpu_without_jax(script, args, expect):
    """Each profiler with --cpu at B = 1 and 4 mel frames, in a process of
    its own, after importing ops.mrf_phase: every section prints, and
    neither JAX nor the JAX package is loaded."""
    code = (
        "import sys\n"
        "import matcha_tpu_torch.ops.mrf_phase\n"
        f"from matcha_tpu_torch.scripts.{script} import main\n"
        f"main(['--cpu', '--batch', '1', '--mel-frames', '4', '--steps', '1', *{args!r}])\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'flax', 'matcha_tpu')]\n"
        "assert not bad, bad\n"
        "print('NO_JAX_OK')\n"
    )
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=dict(os.environ),
                         capture_output=True, text=True, timeout=240)
    assert res.returncode == 0, res.stderr[-2000:]
    for line in expect + ["NO_JAX_OK"]:
        assert line in res.stdout, (line, res.stdout)
