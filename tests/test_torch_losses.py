"""``MatchaTTS.losses`` of the PyTorch port against the JAX package.

Both packages load the same reference-layout weights (the JAX one through
its converter), with dropout at 0. The flow time ``t``, the source noise
``z`` and the segment offsets are drawn with ``jax.random`` along the JAX
``losses`` key chain and handed to the port. The alignment ``attn`` must
be EQUAL (the seeds keep the log-prior clear of near-ties that the two
einsums' rounding could flip). The three losses agree to rtol 1e-5 and
every parameter's gradient (JAX's mapped into the port's layout by
``convert.matcha_state_dict``) to 1e-4 of that tensor's largest entry,
plus 1e-7: f32 sums taken in another order through a few dozen layers.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from matcha_tpu.models import MatchaTTS as JaxMatchaTTS
from matcha_tpu.utils.checkpoints import convert_matcha_state_dict
from matcha_tpu_torch.convert import matcha_state_dict
from matcha_tpu_torch.models.matcha import MatchaTTS as PortMatchaTTS
from tests.test_convert import TINY, synthetic_matcha_state_dict

LOSS_RTOL = 1e-5
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-7


def tiny_pair(seed: int = 0, prenet: bool = True):
    """(jax model, jax variables, port model), same weights, no dropout."""
    sd = synthetic_matcha_state_dict(np.random.default_rng(seed))
    if not prenet:
        sd = {k: v for k, v in sd.items() if not k.startswith("encoder.prenet.")}
    variables = convert_matcha_state_dict(sd, n_down_blocks=2,
                                          num_mid_blocks=TINY["dec_num_mid_blocks"])
    kw = dict(TINY, enc_p_dropout=0.0, dec_dropout=0.0, enc_prenet=prenet,
              mel_mean=float(sd["mel_mean"]), mel_std=float(sd["mel_std"]))
    port = PortMatchaTTS(**kw)
    port.load_state_dict(sd)
    return JaxMatchaTTS(**kw), variables, port


def tiny_batch(seed: int = 1, B: int = 2, T_x: int = 16, T_y: int = 64):
    """Seeded ids, lengths and a normalised-mel-like y (B, T_y, n_feats)."""
    rng = np.random.default_rng(seed)
    x = rng.integers(1, TINY["n_vocab"], size=(B, T_x)).astype(np.int32)
    x_lengths = np.array([T_x, T_x - 5][:B], np.int32)
    y_lengths = np.array([T_y, T_y - 14][:B], np.int32)
    y = rng.normal(size=(B, T_y, TINY["n_feats"])).astype(np.float32)
    for i in range(B):
        x[i, x_lengths[i]:] = 0
        y[i, y_lengths[i]:] = 0
    return {"x": x, "x_lengths": x_lengths, "y": y, "y_lengths": y_lengths}


def jax_noise(key, batch, out_size=None) -> dict:
    """t (B,), z and offsets as JAX ``losses`` draws them from ``key``."""
    B, T_y, n_feats = batch["y"].shape
    noise = {}
    if out_size is not None and out_size < T_y:
        k_seg, key = jax.random.split(key)
        max_offset = jnp.clip(jnp.asarray(batch["y_lengths"]) - out_size, min=0)
        noise["offsets"] = torch.from_numpy(np.asarray(
            jax.random.randint(k_seg, (B,), 0, jnp.maximum(max_offset, 1))))
        T_y = out_size
    k_t, k_z = jax.random.split(key)
    noise["t"] = torch.from_numpy(np.asarray(jax.random.uniform(k_t, (B, 1, 1)))[:, 0, 0])
    noise["z"] = torch.from_numpy(np.asarray(jax.random.normal(k_z, (B, T_y, n_feats))))
    return noise


def port_inputs(batch):
    return (torch.from_numpy(batch["x"]).long(), torch.from_numpy(batch["x_lengths"]),
            torch.from_numpy(batch["y"]), torch.from_numpy(batch["y_lengths"]))


def jax_losses(jm, variables, batch, key, out_size=None, durations=None):
    return jm.apply(variables, jnp.asarray(batch["x"]), jnp.asarray(batch["x_lengths"]),
                    jnp.asarray(batch["y"]), jnp.asarray(batch["y_lengths"]), key, None,
                    out_size, durations=None if durations is None else jnp.asarray(durations),
                    method=JaxMatchaTTS.losses)


def _durations(batch):
    """Per-token frame counts that fill each row's mel length."""
    B, T_x = batch["x"].shape
    d = np.zeros((B, T_x), np.float32)
    for i in range(B):
        n = batch["x_lengths"][i]
        d[i, :n] = batch["y_lengths"][i] // n
        d[i, 0] += batch["y_lengths"][i] - d[i, :n].sum()
    return d


@pytest.mark.parametrize("variant", ["mas", "mas_out_size", "durations"])
def test_losses_and_attn_match_jax(variant):
    jm, variables, port = tiny_pair()
    batch = tiny_batch()
    key = jax.random.PRNGKey(5)
    out_size = 32 if variant == "mas_out_size" else None
    durations = _durations(batch) if variant == "durations" else None
    want = jax_losses(jm, variables, batch, key, out_size, durations)
    port.eval()
    with torch.no_grad():
        got = port.losses(*port_inputs(batch), out_size,
                          durations=None if durations is None else torch.from_numpy(durations),
                          **jax_noise(key, batch, out_size))
    for name, g, w in zip(("dur", "prior", "diff"), got[:3], want[:3]):
        np.testing.assert_allclose(float(g), float(w), rtol=LOSS_RTOL, err_msg=name)
    np.testing.assert_array_equal(got[3].numpy(), np.asarray(want[3]))
    assert got[3].shape == (2, 16, out_size or 64)


def _jax_grads(jm, variables, batch, key, out_size, which=(0, 1, 2)):
    def loss(v):
        out = jax_losses(jm, v, batch, key, out_size)
        return sum(out[i] for i in which)

    return jax.grad(loss)(variables)


def _port_grads(port, batch, noise, out_size, which=(0, 1, 2)):
    port.eval()  # dropout is 0 anyway; keep the port in its deterministic mode
    port.zero_grad(set_to_none=True)
    out = port.losses(*port_inputs(batch), out_size, **noise)
    sum(out[i] for i in which).backward()
    return {k: p.grad for k, p in port.named_parameters()}


@pytest.mark.parametrize("out_size", [None, 32])
def test_gradients_match_jax(out_size):
    """Every parameter's gradient of dur + prior + diff. With the duration
    predictor's input not detached, the encoder's gradients pick up the
    duration loss's and this test fails."""
    jm, variables, port = tiny_pair()
    batch = tiny_batch()
    key = jax.random.PRNGKey(11)
    want = matcha_state_dict(_jax_grads(jm, variables, batch, key, out_size), n_down_blocks=2,
                             num_mid_blocks=TINY["dec_num_mid_blocks"])
    got = _port_grads(port, batch, jax_noise(key, batch, out_size), out_size)
    assert set(got) == set(want) - {"mel_mean", "mel_std"}
    for name, g in got.items():
        w = want[name].numpy()
        assert g is not None, name
        np.testing.assert_allclose(g.numpy(), w, rtol=0,
                                   atol=GRAD_RTOL * np.abs(w).max() + GRAD_ATOL, err_msg=name)


def test_duration_loss_trains_only_the_duration_predictor():
    """The detach before ``proj_w``: the duration loss's gradient is zero
    for every encoder parameter outside the duration predictor, as in
    JAX (stop_gradient), and equal to JAX's inside it."""
    jm, variables, port = tiny_pair()
    batch = tiny_batch()
    key = jax.random.PRNGKey(2)
    want = matcha_state_dict(_jax_grads(jm, variables, batch, key, None, which=(0,)),
                             n_down_blocks=2, num_mid_blocks=TINY["dec_num_mid_blocks"])
    got = _port_grads(port, batch, jax_noise(key, batch), None, which=(0,))
    n_predictor = 0
    for name, g in got.items():
        if name.startswith("encoder.proj_w."):
            n_predictor += 1
            np.testing.assert_allclose(g.numpy(), want[name].numpy(), rtol=0,
                                       atol=GRAD_RTOL * np.abs(want[name].numpy()).max()
                                       + GRAD_ATOL, err_msg=name)
        else:
            assert g is None or not g.any(), name
            assert not np.asarray(want[name]).any(), name
    assert n_predictor == 10


def test_dropout_sites_train_only_and_keys_unchanged():
    """Dropout at the JAX package's sites: active in train(), identity in
    eval(); it adds no parameter, so a reference state dict still loads
    strictly."""
    sd = synthetic_matcha_state_dict(np.random.default_rng(0))
    port = PortMatchaTTS(**TINY, enc_p_dropout=0.3, dec_dropout=0.3)
    port.load_state_dict(sd, strict=True)
    drops = [m for m in port.modules() if isinstance(m, torch.nn.Dropout)]
    # per encoder layer 2 (attention, FFN), + residual, prenet, predictor;
    # per decoder transformer block 2 (ff.net.1, attn1.to_out.1)
    n_blocks = 2 + TINY["dec_num_mid_blocks"] + 2
    assert len(drops) == 2 * TINY["enc_n_layers"] + 3 + 2 * n_blocks
    assert {m.p for m in drops} == {0.3, 0.5}
    batch = tiny_batch()
    x, xl, y, yl = port_inputs(batch)
    noise = jax_noise(jax.random.PRNGKey(0), batch)
    port.eval()
    with torch.no_grad():
        a = port.losses(x, xl, y, yl, **noise)[:3]
        b = port.losses(x, xl, y, yl, **noise)[:3]
    assert all(torch.equal(p, q) for p, q in zip(a, b))
    port.train()
    with torch.no_grad():
        torch.manual_seed(0)
        c = port.losses(x, xl, y, yl, **noise)[:3]
        torch.manual_seed(1)
        d = port.losses(x, xl, y, yl, **noise)[:3]
    assert not torch.equal(c[2], d[2]) and not torch.equal(c[2], a[2])


def test_losses_draw_noise_from_the_generator():
    """Without injected noise, t, z and the offsets come from the given
    generator: the same seed gives the same losses."""
    _, _, port = tiny_pair()
    port.eval()
    inputs = port_inputs(tiny_batch())
    with torch.no_grad():
        a = port.losses(*inputs, 32, generator=torch.Generator().manual_seed(3))
        b = port.losses(*inputs, 32, generator=torch.Generator().manual_seed(3))
        c = port.losses(*inputs, 32, generator=torch.Generator().manual_seed(4))
    assert all(torch.equal(p, q) for p, q in zip(a, b))
    assert not torch.equal(a[2], c[2])
