"""The conformer decoder block of the PyTorch port against the JAX package.

Weights come from flax init (halved, as in tests/test_torch_multispeaker.py,
so that activations are O(1)) and are bridged through
``matcha_tpu_torch.convert`` (``conformer_state_dict``,
``matcha_state_dict``); BatchNorm mode gets random running statistics
(fresh ones are the identity). Tolerances are the single-speaker
decoder tests' (tests/test_torch_decoder.py): one block and the
all-conformer estimator at atol 1e-6 (measured 2.4-3.6e-7 on |y| <= 1.8
and 3.5-5.7e-7 on |v| <= 0.7; flax's LayerNorm and GroupNorm take the
variance as E[x^2] - E[x]^2, torch as E[(x - mean)^2]), the mel at 1e-5
(measured 2.4-4.1e-6 on |mel| <= 9.4); the losses at rtol 1e-5 with the
MAS alignment EQUAL, as in tests/test_torch_losses.py.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from matcha_tpu.models import MatchaTTS as JaxMatchaTTS
from matcha_tpu.models.components.conformer import ConformerBlock as JaxConformerBlock
from matcha_tpu_torch.cli import matcha_kwargs
from matcha_tpu_torch.convert import conformer_state_dict, matcha_state_dict
from matcha_tpu_torch.models.components.conformer import ConformerBlock
from matcha_tpu_torch.models.matcha import MatchaTTS as PortMatchaTTS
from tests.test_convert import TINY

BLOCK_ATOL, EST_ATOL, MEL_ATOL, LOSS_RTOL = 1e-6, 1e-6, 1e-5, 1e-5
WEIGHT_SCALE = 0.5
MODES = {"groupnorm": False, "batchnorm": True}
CONFORMER = dict(dec_down_block_type="conformer", dec_mid_block_type="conformer",
                 dec_up_block_type="conformer")


def _randomize_stats(variables, rng):
    """Random BatchNorm running statistics (mean ~N(0, 0.5), var in
    [0.5, 2]) in place of init's zeros and ones."""
    if "batch_stats" not in variables:
        return variables

    def draw(path, a):
        name = path[-1].key
        v = (rng.normal(0, 0.5, a.shape) if name == "mean"
             else rng.uniform(0.5, 2.0, a.shape)).astype(np.float32)
        return jnp.asarray(v)

    return {**variables,
            "batch_stats": jax.tree_util.tree_map_with_path(draw, variables["batch_stats"])}


def _scaled(variables):
    return {**variables, "params": jax.tree.map(lambda a: a * WEIGHT_SCALE, variables["params"])}


@pytest.mark.parametrize("mode", MODES)
def test_conformer_block_matches_jax(mode):
    """B = 2, T = 600 (relative distances past max_pos_emb 512 are
    clipped), ragged lengths; dim 16, 2 heads of 8."""
    bn = MODES[mode]
    rng = np.random.default_rng(3)
    B, T, dim = 2, 600, 16
    x = rng.normal(size=(B, T, dim)).astype(np.float32)
    mask = (np.arange(T)[None, :] < np.array([600, 421])[:, None]).astype(np.float32)
    jb = JaxConformerBlock(dim, heads=2, dim_head=8, use_batch_norm=bn)
    variables = jb.init(jax.random.PRNGKey(2), jnp.asarray(x), jnp.asarray(mask))
    variables = _randomize_stats(_scaled(dict(variables)), rng)
    want = np.asarray(jb.apply(variables, jnp.asarray(x), jnp.asarray(mask)))
    block = ConformerBlock(dim, heads=2, dim_head=8, use_batch_norm=bn)
    block.load_state_dict(conformer_state_dict(variables["params"],
                                               variables.get("batch_stats")))
    with torch.no_grad():
        got = block.eval()(torch.from_numpy(x), torch.from_numpy(mask)).numpy()
    np.testing.assert_allclose(got, want, atol=BLOCK_ATOL)
    if not bn:  # GroupNorm mode masks its output; BatchNorm mode leaves it
        assert not got[1, 421:].any()


def test_batchnorm_block_is_the_same_in_train_and_eval():
    """With dropout 0 a BatchNorm-mode block gives the same output in
    ``train()`` as in ``eval()`` and leaves its running statistics as they
    were: JAX's BatchNorm is ``use_running_average=True`` in training
    too."""
    torch.manual_seed(0)
    block = ConformerBlock(16, heads=2, dim_head=8, use_batch_norm=True)
    bn = block.conv.net[5]
    with torch.no_grad():
        bn.running_mean.normal_()
        bn.running_var.uniform_(0.5, 2.0)
    stats = (bn.running_mean.clone(), bn.running_var.clone(), bn.num_batches_tracked.clone())
    x, mask = torch.randn(2, 50, 16), (torch.arange(50)[None, :] < torch.tensor([[50], [31]]))
    want = block.eval()(x, mask.float())
    got = block.train()(x, mask.float())
    assert torch.equal(got, want)
    for a, b in zip(stats, (bn.running_mean, bn.running_var, bn.num_batches_tracked)):
        assert torch.equal(a, b)


_PAIRS = {}


def _pair(mode, seed=1):
    """(jax model, variables, port model): TINY with every U-Net stage a
    conformer, flax init (jitted, through ``losses`` on given durations),
    made once per mode."""
    if mode in _PAIRS:
        return _PAIRS[mode]
    kw = dict(TINY, **CONFORMER, dec_conformer_batch_norm=MODES[mode], enc_p_dropout=0.0,
              dec_dropout=0.0, mel_mean=-5.5, mel_std=2.1)
    jm = JaxMatchaTTS(**kw)
    rng = np.random.default_rng(seed)
    x = jnp.asarray(rng.integers(1, TINY["n_vocab"], size=(2, 16)))
    y = jnp.zeros((2, 32, TINY["n_feats"]))
    init = jax.jit(functools.partial(jm.init, method=JaxMatchaTTS.losses))
    variables = init({"params": jax.random.PRNGKey(seed)}, x, jnp.array([16, 11]), y,
                     jnp.array([32, 20]), jax.random.PRNGKey(0), durations=jnp.ones((2, 16)))
    variables = _randomize_stats(_scaled(dict(variables)), rng)
    port = PortMatchaTTS(**kw)
    port.load_state_dict(matcha_state_dict(variables, n_down_blocks=2,
                                           num_mid_blocks=TINY["dec_num_mid_blocks"],
                                           mel_mean=-5.5, mel_std=2.1))
    _PAIRS[mode] = jm, variables, port
    return _PAIRS[mode]


@pytest.mark.parametrize("mode", MODES)
def test_all_conformer_decoder_matches_jax(mode):
    """One estimator call, then ``synthesise`` (1 Euler step) on JAX's
    noise."""
    jm, variables, port = _pair(mode)
    port.eval()
    rng = np.random.default_rng(5)
    B, T, nf = 2, 40, TINY["n_feats"]
    xt = rng.normal(size=(B, T, nf)).astype(np.float32)
    mu = rng.normal(size=(B, T, nf)).astype(np.float32)
    mask = (np.arange(T)[None, :] < np.array([40, 26])[:, None]).astype(np.float32)[..., None]
    t = np.array([0.3, 0.7], np.float32)
    estimator = jax.jit(functools.partial(
        jm.apply, method=lambda m, *a: m.decoder(*a, deterministic=True)))
    want = estimator(variables, jnp.asarray(xt), jnp.asarray(mask), jnp.asarray(mu),
                     jnp.asarray(t), None)
    with torch.inference_mode():
        got = port.decoder.estimator(*(torch.from_numpy(a) for a in (xt, mask, mu, t)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=EST_ATOL)

    ids = rng.integers(1, TINY["n_vocab"], size=(2, 16)).astype(np.int32)
    lengths = np.array([16, 9], np.int32)
    ids[1, 9:] = 0
    key = jax.random.PRNGKey(8)
    kw = dict(n_timesteps=1, temperature=0.667, y_max_length=64)
    synth = jax.jit(functools.partial(jm.apply, method=JaxMatchaTTS.synthesise, **kw))
    want = synth(variables, jnp.asarray(ids), jnp.asarray(lengths), key)
    z = np.array(jax.random.normal(key, (2, 64, nf), dtype=jnp.float32))
    got = port.synthesise(torch.from_numpy(ids).long(), torch.from_numpy(lengths),
                          z=torch.from_numpy(z), **kw)
    np.testing.assert_array_equal(got["mel_lengths"].numpy(), np.asarray(want["mel_lengths"]))
    np.testing.assert_allclose(got["mel"].numpy(), np.asarray(want["mel"]), atol=MEL_ATOL)


@pytest.mark.parametrize("mode", MODES)
def test_all_conformer_losses_match_jax(mode):
    """``losses`` with MAS in ``train()`` mode (dropout 0; the BatchNorm
    keeps its running statistics): the alignment EQUAL, the three losses
    at rtol 1e-5."""
    jm, variables, port = _pair(mode)
    rng = np.random.default_rng(6)
    x = rng.integers(1, TINY["n_vocab"], size=(2, 16)).astype(np.int32)
    xl, yl = np.array([16, 12], np.int32), np.array([48, 36], np.int32)
    x[1, 12:] = 0
    y = rng.normal(size=(2, 48, TINY["n_feats"])).astype(np.float32)
    y[1, 36:] = 0
    key = jax.random.PRNGKey(4)
    losses = jax.jit(functools.partial(jm.apply, method=JaxMatchaTTS.losses))
    want = losses(variables, *(jnp.asarray(a) for a in (x, xl, y, yl)), key)
    k_t, k_z = jax.random.split(key)
    noise = {"t": torch.from_numpy(np.array(jax.random.uniform(k_t, (2, 1, 1)))[:, 0, 0]),
             "z": torch.from_numpy(np.array(jax.random.normal(k_z, y.shape)))}
    got = port.train().losses(*(torch.from_numpy(a) for a in (x, xl, y, yl)), **noise)
    np.testing.assert_array_equal(got[3].detach().numpy(), np.asarray(want[3]))
    for g, w in zip(got[:3], want[:3]):
        np.testing.assert_allclose(float(g), float(w), rtol=LOSS_RTOL)
    port.zero_grad(set_to_none=True)
    sum(got[:3]).backward()
    assert all(p.grad is not None for n, p in port.named_parameters()
               if ".ff1." in n and "estimator" in n)
    port.zero_grad(set_to_none=True)


def test_block_types_reach_the_model_from_checkpoints_and_configs():
    """A reference checkpoint's ``decoder.*_block_type`` and
    ``conformer_batch_norm`` build conformer stages (``matcha_kwargs``); an
    unknown block type raises."""
    hp = {"decoder": {"channels": [16, 16], "down_block_type": "conformer",
                      "mid_block_type": "transformer", "up_block_type": "conformer",
                      "conformer_batch_norm": True}}
    kw = matcha_kwargs(hp)
    assert (kw["dec_down_block_type"], kw["dec_mid_block_type"], kw["dec_up_block_type"],
            kw["dec_conformer_batch_norm"]) == ("conformer", "transformer", "conformer", True)
    m = PortMatchaTTS(**dict(TINY, **{k: v for k, v in kw.items() if k.startswith("dec_")
                                      and k != "dec_channels"}))
    est = m.decoder.estimator
    assert type(est.down_blocks[0][1][0]).__name__ == "ConformerBlock"
    assert type(est.mid_blocks[0][1][0]).__name__ == "BasicTransformerBlock"
    assert type(est.up_blocks[0][1][0].conv.net[5]).__name__ == "FrozenBatchNorm1d"
    with pytest.raises(ValueError, match="Unknown block type"):
        PortMatchaTTS(**dict(TINY, dec_up_block_type="lstm"))
