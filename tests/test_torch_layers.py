"""The port's shared layers (models/components/common.py) against the JAX
package's, with the flax parameters carried over by the port's weight
bridge (matcha_tpu_torch.convert), so each case also checks one layout
conversion. Tolerance atol 1e-5 on O(1) outputs: f32 sums over at most a
few hundred products, in another order.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from matcha_tpu.models.components import common as jax_common
from matcha_tpu_torch import convert
from matcha_tpu_torch.models.components import common


def _init(module, x, seed):
    """flax variables with every leaf drawn from a seeded normal (flax
    would start biases at zero, which hides a bias in the wrong place)."""
    variables = module.init(jax.random.PRNGKey(seed), jnp.asarray(x))
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda a: jnp.asarray(rng.normal(size=a.shape).astype(np.float32) * 0.3), variables)


def _x(shape, seed=0):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


@pytest.mark.parametrize("k,padding,dilation", [(5, 2, 1), (3, 3, 3), (1, 0, 1)])
def test_conv1d(k, padding, dilation):
    x = _x((2, 19, 6))
    jm = jax_common.Conv1d(features=7, kernel_size=k, padding=padding, dilation=dilation)
    v = _init(jm, x, k)
    tm = common.Conv1d(6, 7, k, padding=padding, dilation=dilation)
    tm.load_state_dict({"weight": convert.conv1d_weight(v["params"]["conv"]["kernel"]),
                        "bias": torch.from_numpy(np.array(v["params"]["conv"]["bias"]))})
    with torch.inference_mode():
        got = tm(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(jm.apply(v, jnp.asarray(x))), atol=1e-5)


@pytest.mark.parametrize("k,stride,padding", [(4, 2, 1), (16, 8, 4), (3, 1, 1)])
def test_conv_transpose1d_undoes_the_flip(k, stride, padding):
    """The bridge un-flips and transposes the flax kernel; a kernel that
    is not flipped back fails here for every k > 1."""
    x = _x((2, 11, 6))
    jm = jax_common.ConvTranspose1d(features=5, kernel_size=k, stride=stride, padding=padding)
    v = _init(jm, x, k)
    tm = common.ConvTranspose1d(6, 5, k, stride=stride, padding=padding)
    tm.load_state_dict({"weight": convert.conv_transpose1d_weight(v["params"]["kernel"]),
                        "bias": torch.from_numpy(np.array(v["params"]["bias"]))})
    with torch.inference_mode():
        got = tm(torch.from_numpy(x)).numpy()
    want = np.asarray(jm.apply(v, jnp.asarray(x)))
    assert got.shape == want.shape == (2, (11 - 1) * stride - 2 * padding + k, 5)
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_channel_layer_norm_and_activations():
    x = _x((2, 9, 8)) * 3
    jm = jax_common.ChannelLayerNorm(8)
    v = _init(jm, x, 1)
    tm = common.ChannelLayerNorm(8)
    tm.load_state_dict({k: torch.from_numpy(np.array(a)) for k, a in v["params"].items()})
    xt = torch.from_numpy(x)
    with torch.inference_mode():
        np.testing.assert_allclose(tm(xt).numpy(), np.asarray(jm.apply(v, jnp.asarray(x))),
                                   atol=1e-5)
        np.testing.assert_allclose(common.mish(xt).numpy(),
                                   np.asarray(jax_common.mish(jnp.asarray(x))), atol=1e-5)
        for slope in (0.01, 0.1):
            np.testing.assert_array_equal(
                common.leaky_relu(xt, slope).numpy(),
                np.asarray(jax_common.leaky_relu(jnp.asarray(x), slope)))


def test_time_embedding():
    """t up to 1: the sinusoid's argument reaches 1000 rad, so f32 rounding
    in the argument shows; atol 1e-4 on the embedding (values in [-1, 1])
    and on the MLP output."""
    t = np.array([0.0, 0.37, 1.0], np.float32)
    emb_j = jax_common.SinusoidalPosEmb(16).apply({}, jnp.asarray(t))
    emb_t = common.SinusoidalPosEmb(16)(torch.from_numpy(t))
    np.testing.assert_allclose(emb_t.numpy(), np.asarray(emb_j), atol=1e-4)

    jm = jax_common.TimestepEmbedding(32)
    v = _init(jm, np.asarray(emb_j), 2)
    tm = common.TimestepEmbedding(16, 32)
    tm.load_state_dict({f"{name}.{key}": convert.linear_weight(v["params"][name]["kernel"])
                        if key == "weight" else torch.from_numpy(np.array(v["params"][name]["bias"]))
                        for name in ("linear_1", "linear_2") for key in ("weight", "bias")})
    with torch.inference_mode():
        got = tm(torch.from_numpy(np.array(emb_j))).numpy()
    np.testing.assert_allclose(got, np.asarray(jm.apply(v, emb_j)), atol=1e-4)
