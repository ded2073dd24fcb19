"""MatchaTTS.encode of the PyTorch port against the JAX package.

Both packages load the same reference-layout weights (the JAX one through
its converter). ``mu_x``/``logw`` are f32 allclose at atol 1e-6 (measured
~3e-8 on O(1) values): the two frameworks sum in different orders.
``w_ceil`` and ``y_lengths`` must be EQUAL: they are ceil(exp(logw)), and
the seeded inputs are
checked to keep every exp(logw) more than 1e-4 from an integer, so that
the float noise above cannot move a ceil.
"""

import jax.numpy as jnp
import numpy as np
import torch

from matcha_tpu.models import MatchaTTS as JaxMatchaTTS
from matcha_tpu.utils.checkpoints import convert_matcha_state_dict
from matcha_tpu_torch.models.matcha import MatchaTTS as PortMatchaTTS
from tests.test_convert import TINY, synthetic_matcha_state_dict


def tiny_models(seed: int = 0, mask_mode: str = "additive_reference"):
    """(jax model, jax variables, port model) sharing seeded weights."""
    sd = synthetic_matcha_state_dict(np.random.default_rng(seed))
    variables = convert_matcha_state_dict(sd, n_down_blocks=2,
                                          num_mid_blocks=TINY["dec_num_mid_blocks"])
    jm = JaxMatchaTTS(**TINY, mel_mean=float(sd["mel_mean"]), mel_std=float(sd["mel_std"]),
                      dec_mask_mode=mask_mode)
    tm = PortMatchaTTS(**TINY, dec_mask_mode=mask_mode)
    tm.load_state_dict(sd)
    return jm, variables, tm.eval()


def tiny_ids(seed: int = 1):
    """Seeded ids (B=2, T_x=16) with lengths 16 and 11 (zero padded)."""
    rng = np.random.default_rng(seed)
    x = rng.integers(1, TINY["n_vocab"], size=(2, 16)).astype(np.int32)
    lengths = np.array([16, 11], np.int32)
    x[1, 11:] = 0
    return x, lengths


def _jax_text_encoder(jm, variables, x, lengths):
    x_mask = (np.arange(x.shape[1])[None, :] < lengths[:, None]).astype(np.float32)[..., None]
    return jm.apply(variables, jnp.asarray(x), jnp.asarray(x_mask), None,
                    method=lambda m, *a: m.encoder(*a, deterministic=True))


def test_text_encoder_matches_jax():
    jm, variables, tm = tiny_models()
    x, lengths = tiny_ids()
    mu_j, logw_j = _jax_text_encoder(jm, variables, x, lengths)
    x_mask = (torch.arange(16)[None, :] < torch.from_numpy(lengths)[:, None]).float()[..., None]
    with torch.inference_mode():
        mu_t, logw_t = tm.encoder(torch.from_numpy(x).long(), x_mask)
    np.testing.assert_allclose(mu_t.numpy(), np.asarray(mu_j), atol=1e-6)
    np.testing.assert_allclose(logw_t.numpy(), np.asarray(logw_j), atol=1e-6)


def test_encode_durations_are_equal():
    jm, variables, tm = tiny_models()
    x, lengths = tiny_ids()
    # precondition of the exact comparison (see module doc)
    _, logw = _jax_text_encoder(jm, variables, x, lengths)
    w = np.exp(np.minimum(np.asarray(logw, np.float64), 11.0))[..., 0]
    valid = np.arange(16)[None, :] < lengths[:, None]
    assert np.abs(w - np.round(w))[valid].min() > 1e-4

    mu_j, w_ceil_j, y_len_j = jm.apply(variables, jnp.asarray(x), jnp.asarray(lengths),
                                       method=JaxMatchaTTS.encode)
    mu_t, w_ceil_t, y_len_t = tm.encode(torch.from_numpy(x).long(), torch.from_numpy(lengths))
    np.testing.assert_allclose(mu_t.numpy(), np.asarray(mu_j), atol=1e-6)
    np.testing.assert_array_equal(w_ceil_t.numpy(), np.asarray(w_ceil_j))
    np.testing.assert_array_equal(y_len_t.numpy(), np.asarray(y_len_j))
    assert y_len_t.dtype == torch.int32


def test_encode_length_scale_and_clamp():
    """length_scale multiplies the ceil'd durations; logw is clamped at 11
    before exp, so huge logits give 59875 frames per token, not inf."""
    jm, variables, tm = tiny_models()
    x, lengths = tiny_ids()
    for scale in (0.5, 2.0):
        _, w_j, y_j = jm.apply(variables, jnp.asarray(x), jnp.asarray(lengths),
                               length_scale=scale, method=JaxMatchaTTS.encode)
        _, w_t, y_t = tm.encode(torch.from_numpy(x).long(), torch.from_numpy(lengths), scale)
        np.testing.assert_array_equal(w_t.numpy(), np.asarray(w_j))
        np.testing.assert_array_equal(y_t.numpy(), np.asarray(y_j))
    with torch.no_grad():
        tm.encoder.proj_w.proj.bias.fill_(50.0)
    _, w_ceil, _ = tm.encode(torch.from_numpy(x).long(), torch.from_numpy(lengths))
    assert float(w_ceil.max()) == float(np.ceil(np.float32(np.exp(np.float32(11.0)))))
