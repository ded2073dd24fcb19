"""The port's CFM decoder against the JAX package, both mask modes.

One estimator call, then ``decode`` fed JAX's ``w_ceil`` and the very
noise JAX draws inside ``cfm_sample`` (``z = jax.random.normal(key,
(B, T_y, n_feats))``, injected into the port). Tolerance: atol 1e-6 on
the estimator output (|v| <= ~0.3; measured ~6e-8) and 1e-5 on the mel
after the Euler steps and the denormalisation (|mel| <= ~11; measured
~5e-7). The two frameworks sum matmuls, convs and GroupNorm statistics in
different orders; the sinusoidal time embedding multiplies t by up to
1000 before sin(), so its f32 rounding is computed in the JAX package's
order of operations.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from matcha_tpu.models import MatchaTTS as JaxMatchaTTS
from tests.test_convert import TINY
from tests.test_torch_encoder import tiny_ids, tiny_models

MASK_MODES = ["additive_reference", "proper"]


@pytest.mark.parametrize("mask_mode", MASK_MODES)
def test_estimator_call_matches_jax(mask_mode):
    jm, variables, tm = tiny_models(mask_mode=mask_mode)
    rng = np.random.default_rng(5)
    B, T, nf = 2, 16, TINY["n_feats"]
    x = rng.normal(size=(B, T, nf)).astype(np.float32)
    mu = rng.normal(size=(B, T, nf)).astype(np.float32)
    mask = (np.arange(T)[None, :] < np.array([16, 11])[:, None]).astype(np.float32)[..., None]
    t = np.array([0.3, 0.7], np.float32)
    want = jm.apply(variables, jnp.asarray(x), jnp.asarray(mask), jnp.asarray(mu),
                    jnp.asarray(t), None,
                    method=lambda m, *a: m.decoder(*a, deterministic=True))
    with torch.inference_mode():
        got = tm.decoder.estimator(torch.from_numpy(x), torch.from_numpy(mask),
                                   torch.from_numpy(mu), torch.from_numpy(t))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)


@pytest.mark.parametrize("mask_mode", MASK_MODES)
def test_decode_with_injected_noise_matches_jax(mask_mode):
    jm, variables, tm = tiny_models(mask_mode=mask_mode)
    x, lengths = tiny_ids()
    mu_x, w_ceil, y_lengths = jm.apply(variables, jnp.asarray(x), jnp.asarray(lengths),
                                       method=JaxMatchaTTS.encode)
    T_y = 4 * int(np.ceil(int(np.max(y_lengths)) / 4))
    key = jax.random.PRNGKey(3)
    kw = dict(n_timesteps=3, temperature=0.667, y_max_length=T_y)
    want = jm.apply(variables, mu_x, w_ceil, jnp.asarray(lengths), y_lengths, key, **kw,
                    method=JaxMatchaTTS.decode)
    z = np.array(jax.random.normal(key, (2, T_y, TINY["n_feats"]), dtype=jnp.float32))
    got = tm.decode(torch.from_numpy(np.array(mu_x)), torch.from_numpy(np.array(w_ceil)),
                    torch.from_numpy(lengths), torch.from_numpy(np.array(y_lengths)),
                    z=torch.from_numpy(z), **kw)
    np.testing.assert_array_equal(got["mel_lengths"].numpy(), np.asarray(want["mel_lengths"]))
    np.testing.assert_array_equal(got["attn"].numpy(), np.asarray(want["attn"]))
    np.testing.assert_allclose(got["encoder_outputs"].numpy(),
                               np.asarray(want["encoder_outputs"]), atol=1e-6)
    np.testing.assert_allclose(got["mel"].numpy(), np.asarray(want["mel"]), atol=1e-5)
    assert got["mel"].shape == (2, TINY["n_feats"], T_y)


def test_synthesise_matches_jax():
    """The one-call form at a fixed bucket: same durations, same mel
    (tolerances as above)."""
    jm, variables, tm = tiny_models()
    x, lengths = tiny_ids()
    key = jax.random.PRNGKey(8)
    kw = dict(n_timesteps=2, temperature=0.667, y_max_length=64)
    want = jm.apply(variables, jnp.asarray(x), jnp.asarray(lengths), key, **kw,
                    method=JaxMatchaTTS.synthesise)
    z = np.array(jax.random.normal(key, (2, 64, TINY["n_feats"]), dtype=jnp.float32))
    got = tm.synthesise(torch.from_numpy(x).long(), torch.from_numpy(lengths),
                        z=torch.from_numpy(z), **kw)
    np.testing.assert_array_equal(got["mel_lengths"].numpy(), np.asarray(want["mel_lengths"]))
    np.testing.assert_allclose(got["mel"].numpy(), np.asarray(want["mel"]), atol=1e-5)


def test_decode_rejects_noise_of_the_wrong_shape():
    _, _, tm = tiny_models()
    mu_x = torch.zeros(1, 4, TINY["n_feats"])
    w_ceil = torch.ones(1, 4, 1)
    with pytest.raises(ValueError, match="z has shape"):
        tm.decode(mu_x, w_ceil, torch.tensor([4]), torch.tensor([4]), n_timesteps=1,
                  y_max_length=8, z=torch.zeros(1, 4, TINY["n_feats"]))
