"""Data-parallel training of the port on the CPU: two gloo ranks
(``parallel.dist.launch_local``, a file store, spawned workers from
``tests/torch_ddp_worker.py`` that load no JAX) against JAX's
``make_train_step`` on the global batch.

One spawn runs every case (module fixture); the tests read what each rank
saved:

* one step on 4 rows split 2 + 2 (with the segment cut, ``out_size`` 32)
  and on 3 rows (JAX's gcd rule puts all 3 on rank 0; rank 1 runs a
  zero-weight copy): losses and gradient norm within
  ``test_train_step_matches_jax``'s rtol 1e-5 of JAX's, the updated
  weights within Adam's first-step tolerance (below), both ranks' weights
  and all-reduced gradients bit-equal, and the gradients within
  ``GRAD_RTOL`` of the port's one-process step on the same noise;
* a 2-step ``fit`` with a validation: the same validation means on both
  ranks, one checkpoint (rank 0's), and a resume from it to step 3 that
  equals an uninterrupted 3-step run bit for bit.

Dropout is off in the step cases: the two packages' dropout masks never
agree. The spawn takes ~10-15 s; each JAX step compiles in ~8-14 s.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from matcha_tpu.training import trainer as jax_trainer
from matcha_tpu_torch.models.matcha import MatchaTTS
from matcha_tpu_torch.parallel import dist
from matcha_tpu_torch.training import trainer as port_trainer
from tests import torch_ddp_worker
from tests.test_convert import TINY
from tests.test_torch_losses import jax_noise, tiny_pair
from tests.test_torch_train import CLEANER, TINY_TRAIN, corpus, dm_args  # noqa: F401

torch.set_num_threads(2)

LR = 1e-3
SEED = 3
LOSS_RTOL = 1e-5
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-7
#: Adam's first update is lr * g / (|g| + eps): +-lr wherever |g| >> eps,
#: so a gradient within rounding of zero can flip an update by up to 2 lr.
#: All weights within 2 lr + 1e-7, and all but PARAM_FLIP_SHARE of them
#: within PARAM_ATOL.
PARAM_ATOL = 1e-6
PARAM_FLIP_SHARE = 1e-3

#: name -> (rows, out_size)
STEP_CASES = {"split_cut": (4, 32), "zero_weight": (3, None)}


def global_batch(B: int, seed: int = 5) -> dict:
    """Seeded rows of unequal lengths, padded to the longest (T_y 64, a
    multiple of 4 as the U-Net needs)."""
    rng = np.random.default_rng(seed)
    x_lengths = np.array([16, 9, 13, 6][:B], np.int32)
    y_lengths = np.array([64, 37, 52, 28][:B], np.int32)
    x = rng.integers(1, TINY["n_vocab"], size=(B, 16)).astype(np.int32)
    y = rng.normal(size=(B, 64, TINY["n_feats"])).astype(np.float32)
    for i in range(B):
        x[i, x_lengths[i]:] = 0
        y[i, y_lengths[i]:] = 0
    return {"x": x, "x_lengths": x_lengths, "y": y, "y_lengths": y_lengths}


def port_tiny(seed: int = 0):
    jm, variables, port = tiny_pair(seed, prenet=False)
    kw = dict(TINY, enc_p_dropout=0.0, dec_dropout=0.0, enc_prenet=False,
              mel_mean=float(port.mel_mean), mel_std=float(port.mel_std))
    return jm, variables, port, kw


@pytest.fixture(scope="module")
def ddp_run(tmp_path_factory, corpus):  # noqa: F811
    """Both ranks' results, JAX's step on each case, the port's
    one-process step on the same noise."""
    workdir = str(tmp_path_factory.mktemp("ddp"))
    jm, variables, port, kw = port_tiny()
    state_dict = {k: v.clone() for k, v in port.state_dict().items()}
    steps, want = [], {}
    for name, (B, out_size) in STEP_CASES.items():
        batch = global_batch(B)
        tx = jax_trainer.make_optimizer(lr=LR, gradient_clip_val=5.0)
        params = jax.tree.map(jnp.array, variables)  # the step donates its state
        state = jax_trainer.TrainState(step=jnp.asarray(0, jnp.int32), params=params,
                                       opt_state=tx.init(params))
        base_key = jax.random.PRNGKey(SEED + 17)
        new_state, metrics = jax_trainer.make_train_step(jm, tx, out_size)(
            state, {k: jnp.asarray(v) for k, v in batch.items()}, base_key)
        k_loss, _ = jax.random.split(jax.random.fold_in(base_key, 0))
        noise = jax_noise(k_loss, batch, out_size)
        want[name] = {"metrics": {k: float(v) for k, v in metrics.items()},
                      "params": _port_layout(new_state.params), "one": _one_process(
                          kw, state_dict, batch, noise, out_size)}
        steps.append({"name": name, "batch": batch, "noise": noise, "out_size": out_size,
                      "lr": LR, "seed": SEED})
    bf16 = global_batch(4)
    bf16_noise = {k: v.clone() for k, v in steps[0]["noise"].items()}
    want["bf16"] = {"one": _one_process(kw, state_dict, bf16, bf16_noise, 32, "bf16-mixed")}
    steps.append({"name": "bf16", "batch": bf16, "noise": bf16_noise, "out_size": 32,
                  "lr": LR, "seed": SEED, "precision": "bf16-mixed"})
    fit = {"kw": TINY_TRAIN, "dm": dm_args(corpus),
           "trainer": dict(lr=1e-3, seed=7, loggers={"csv": {}}, log_every_n_steps=1,
                           check_val_every_n_epoch=1, save_every_n_epochs=0)}
    torch.save({"kw": kw, "state_dict": state_dict, "steps": steps, "fit": fit},
               os.path.join(workdir, "in.pt"))
    dist.launch_local(torch_ddp_worker.run, (workdir,), 2, "gloo", workdir, timeout_s=240,
                      threads=2)
    ranks = [torch.load(os.path.join(workdir, f"rank{i}.pt"), weights_only=False)
             for i in range(2)]
    return {"ranks": ranks, "want": want, "workdir": workdir}


def _port_layout(tree):
    from matcha_tpu_torch.convert import matcha_state_dict

    sd = matcha_state_dict(tree, n_down_blocks=2, num_mid_blocks=TINY["dec_num_mid_blocks"])
    return {k: v for k, v in sd.items() if k not in ("mel_mean", "mel_std")}


def _one_process(kw, state_dict, batch, noise, out_size, precision="f32") -> dict:
    """The port's plain step on the whole batch: its gradients (and, as
    ``"metrics"``, its losses)."""
    model = MatchaTTS(**kw)
    model.load_state_dict(state_dict)
    opt, sched = port_trainer.make_optimizer(model, lr=LR)
    grads = {}

    def keep(phase):
        if phase == "backward":
            grads.update({k: p.grad.clone() for k, p in model.named_parameters()})

    metrics = port_trainer.train_step(model, opt, sched, port_trainer.to_device(batch, "cpu"), 0,
                                      SEED, out_size, 5.0, noise=noise, on_phase=keep,
                                      precision=precision)
    return {**grads, "metrics": {k: float(v) for k, v in metrics.items()}}


@pytest.mark.parametrize("case", list(STEP_CASES))
def test_two_rank_step_matches_jax(ddp_run, case):
    """Losses and gradient norm of the global batch within rtol 1e-5 of
    JAX's on both ranks; the updated weights within Adam's first-step
    tolerance."""
    want = ddp_run["want"][case]
    for r in ddp_run["ranks"]:
        got = r[case]["metrics"]
        assert set(got) == set(want["metrics"])
        for k in got:
            np.testing.assert_allclose(got[k], want["metrics"][k], rtol=LOSS_RTOL, err_msg=k)
    got = ddp_run["ranks"][0][case]["params"]
    n = far = 0
    for k, w in want["params"].items():
        d = (got[k] - w).abs()
        assert float(d.max()) <= 2 * LR + 1e-7, k
        n += d.numel()
        far += int((d > PARAM_ATOL).sum())
    assert far <= PARAM_FLIP_SHARE * n, (far, n)


@pytest.mark.parametrize("case", list(STEP_CASES))
def test_two_ranks_hold_equal_weights_and_gradients(ddp_run, case):
    """After the step both ranks hold the same weights and the same
    all-reduced gradients, bit for bit, and the gradients are the
    one-process step's on the same noise within GRAD_RTOL."""
    a, b = (r[case] for r in ddp_run["ranks"])
    for k in a["params"]:
        assert torch.equal(a["params"][k], b["params"][k]), k
    one = ddp_run["want"][case]["one"]
    assert set(a["grads"]) == set(one) - {"metrics"}
    for k in a["grads"]:
        assert torch.equal(a["grads"][k], b["grads"][k]), k
        np.testing.assert_allclose(a["grads"][k].numpy(), one[k].numpy(), rtol=GRAD_RTOL,
                                   atol=GRAD_ATOL, err_msg=k)


def test_bf16_step_syncs_through_ddp(ddp_run):
    """Under ``bf16-mixed`` the loss runs through ``functional_call`` on
    bf16-rounded copies inside ``BatchLoss.forward``: both ranks still end
    with the same all-reduced gradients and weights, bit for bit. Against
    the one-process bf16 step: the losses within rtol 1e-5 (the forward
    computes in f32 on the same rounded weights); each gradient within
    2^-7 of its tensor's largest, since each rank's part is rounded to
    bf16 before the all-reduce (one process rounds the sum once)."""
    a, b = (r["bf16"] for r in ddp_run["ranks"])
    one = ddp_run["want"]["bf16"]["one"]
    for k in a["params"]:
        assert torch.equal(a["params"][k], b["params"][k]), k
    for k in a["grads"]:
        assert torch.equal(a["grads"][k], b["grads"][k]), k
        tol = 2.0**-7 * float(one[k].abs().max()) + GRAD_ATOL
        assert float((a["grads"][k] - one[k]).abs().max()) <= tol, k
    for k in ("dur_loss", "prior_loss", "diff_loss", "loss"):
        np.testing.assert_allclose(a["metrics"][k], one["metrics"][k], rtol=LOSS_RTOL, err_msg=k)


def test_zero_weight_rank_share(ddp_run):
    """3 rows on 2 ranks: rank 0 holds all 3 (gcd(2, 3) = 1), rank 1 a
    zero-weight copy that adds nothing to the loss."""
    s0, s1 = (r["zero_weight"]["share"] for r in ddp_run["ranks"])
    assert (s0.lo, s0.n_rows, s0.n_global) == (0, 3, 3)
    assert (s1.n_rows, s1.n_global) == (3, 3)
    assert s1.dur_scale == s1.mel_scale == 0.0
    assert s0.dur_scale == s0.mel_scale == 2.0
    s0, s1 = (r["split_cut"]["share"] for r in ddp_run["ranks"])
    assert (s0.lo, s1.lo, s0.n_rows, s1.n_rows) == (0, 2, 2, 2)
    assert s0.dur_scale + s1.dur_scale == pytest.approx(2.0)


def test_fit_validates_equally_and_checkpoints_once(ddp_run):
    """A 2-step fit with one validation: both ranks log the same means,
    the last checkpoint and the CSV exist once (rank 0 writes them)."""
    a, b = (r["fit"] for r in ddp_run["ranks"])
    assert a["step"] == b["step"] == 2
    assert a["val"] and a["val"] == b["val"]
    assert np.isfinite(a["result"]["loss/val"]) and a["result"] == b["result"]
    ckpt = os.path.join(ddp_run["workdir"], "fit", "checkpoints")
    assert sorted(os.listdir(ckpt)) == ["last", "last.hparams.json"]
    assert os.path.exists(os.path.join(ddp_run["workdir"], "fit", "csv", "metrics.csv"))
    for k in a["params"]:
        assert torch.equal(a["params"][k], b["params"][k]), k


def test_resume_on_two_ranks_continues_the_run(ddp_run):
    """Resumed from the 2-step checkpoint on both ranks, step 3 gives the
    uninterrupted run's losses, validation and weights, bit for bit."""
    for r in ddp_run["ranks"]:
        resumed, straight = r["resumed"], r["straight"]
        assert resumed["step"] == straight["step"] == 3
        assert resumed["result"] == straight["result"]
        assert resumed["val"][3] == straight["val"][3]
        for k in straight["params"]:
            assert torch.equal(resumed["params"][k], straight["params"][k]), k


@pytest.mark.parametrize("family", ["single", "speakers", "conformer"])
def test_every_parameter_reaches_the_loss(family):
    """``make_ddp`` runs DDP with ``find_unused_parameters`` off: every
    parameter of each model family has a gradient after one backward."""
    extra = {"single": {}, "speakers": {"n_spks": 3, "spk_emb_dim": 8},
             "conformer": {f"dec_{k}_block_type": "conformer" for k in ("down", "mid", "up")}}
    torch.manual_seed(0)
    model = MatchaTTS(**dict(TINY, **extra[family]))
    batch = port_trainer.to_device(global_batch(2), "cpu")
    if family == "speakers":
        batch["spks"] = torch.tensor([0, 2])
    losses = port_trainer.BatchLoss(model, out_size=32)(batch)
    sum(losses).backward()
    assert [k for k, p in model.named_parameters() if p.grad is None] == []


def test_launch_local_reports_a_failed_rank(tmp_path):
    """A worker that raises fails the launch; its partner, left waiting
    at a barrier, is ended."""
    with pytest.raises(Exception, match="rank 1 fails on purpose"):
        dist.launch_local(torch_ddp_worker.fail, (), 2, "gloo", str(tmp_path), timeout_s=120,
                          threads=1)
