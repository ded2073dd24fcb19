"""Tensor parallelism of the port (the ``model`` axis of the mesh) on the
CPU: gloo ranks spawned by ``parallel.dist.launch_local`` from
``tests/torch_ddp_worker.py::run_tp`` (no JAX in the workers, torch on 2
threads), one spawn per world size (module fixtures), against the port's
one-process step and JAX's ``make_train_step``; and the rules against
JAX's ``_TP_RULES`` on the flagship parameter tree.

Cases (the tiny config of ``tests/test_convert.py``; 4 rows, the segment
cut at 32 frames):

* 2 ranks, ``n_model = 2``: the encoder's 2 heads split one per rank, the
  decoder's 1 head is gathered; dropout on (the masks are drawn at full
  width, so the step is the one-process step's), also under ``remat``
  (the recompute runs the collectives again); dropout off against JAX;
  ``bf16-mixed``; a 2-step ``Trainer(n_model_axis=2)`` fit with a
  validation, a resume to step 3 and an uninterrupted 3-step run;
* 4 ranks: ``n_model = 4`` with 2 decoder heads (half a head per rank,
  gathered), with the snake-beta and the GEGLU feed-forward, dropout on;
  data x model = 2 x 2 (dropout off: each data index draws its masks at
  its own rows' shape, as under DDP alone).
"""

import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from matcha_tpu.models import MatchaTTS as JaxMatchaTTS
from matcha_tpu.parallel.mesh import _TP_RULES, param_pspec
from matcha_tpu.training import trainer as jax_trainer
from matcha_tpu.utils.checkpoints import convert_matcha_state_dict
from matcha_tpu_torch import cli
from matcha_tpu_torch.convert import matcha_state_dict
from matcha_tpu_torch.models.matcha import MatchaTTS
from matcha_tpu_torch.parallel import dist
from matcha_tpu_torch.parallel.mesh import TP_RULES, mesh_coords, param_shard_dim, rank_rows
from matcha_tpu_torch.training import trainer as port_trainer
from matcha_tpu_torch.training.data import TextMelDataModule
from matcha_tpu_torch.utils.checkpoints import load_native_checkpoint
from tests import torch_ddp_worker
from tests.test_tensor_parallel import _flagship_init, _flat_paths
from tests.test_torch_ddp import (
    GRAD_ATOL,
    LOSS_RTOL,
    LR,
    PARAM_ATOL,
    PARAM_FLIP_SHARE,
    SEED,
    _one_process,
    _port_layout,
    global_batch,
    port_tiny,
)
from tests.test_torch_losses import jax_noise
from tests.test_torch_train import TINY_TRAIN, corpus, dm_args  # noqa: F401

torch.set_num_threads(2)

OUT_SIZE = 32
#: gathered gradients against the one-process step, as a fraction of each
#: tensor's largest value
GRAD_OF_MAX = 1e-4
DROPOUT = dict(enc_p_dropout=0.1, dec_dropout=0.1)


def _weights(kw: dict) -> dict:
    torch.manual_seed(0)
    return {k: v.clone() for k, v in MatchaTTS(**kw).state_dict().items()}


def _noise(B: int, seed: int = 1) -> dict:
    g = torch.Generator().manual_seed(seed)
    return {"t": torch.rand(B, generator=g), "z": torch.randn(B, OUT_SIZE, 8, generator=g),
            "offsets": torch.tensor([10, 2, 5, 0][:B])}


def _case(name, n_model, kw, weights, batch, noise, precision="f32"):
    return {"name": name, "n_model": n_model, "kw": kw, "weights": weights, "batch": batch,
            "noise": noise, "out_size": OUT_SIZE, "lr": LR, "seed": SEED,
            "precision": precision}


def _spawn(workdir: str, spec: dict, world: int) -> list:
    torch.save(spec, os.path.join(workdir, "in.pt"))
    dist.launch_local(torch_ddp_worker.run_tp, (workdir,), world, "gloo", workdir,
                      timeout_s=240, threads=2)
    return [torch.load(os.path.join(workdir, f"tp{i}.pt"), weights_only=False)
            for i in range(world)]


@pytest.fixture(scope="module")
def tp2(tmp_path_factory, corpus):  # noqa: F811
    """2 ranks: the n_model = 2 cases and the fit; JAX's step and the
    port's one-process steps on the same weights and noise."""
    workdir = str(tmp_path_factory.mktemp("tp2"))
    jm, variables, port, kw = port_tiny()
    tiny = {k: v.clone() for k, v in port.state_dict().items()}
    batch = global_batch(4)
    tx = jax_trainer.make_optimizer(lr=LR, gradient_clip_val=5.0)
    params = jax.tree.map(jnp.array, variables)
    state = jax_trainer.TrainState(step=jnp.asarray(0, jnp.int32), params=params,
                                   opt_state=tx.init(params))
    base_key = jax.random.PRNGKey(SEED + 17)
    new_state, metrics = jax_trainer.make_train_step(jm, tx, OUT_SIZE)(
        state, {k: jnp.asarray(v) for k, v in batch.items()}, base_key)
    k_loss, _ = jax.random.split(jax.random.fold_in(base_key, 0))
    noise = jax_noise(k_loss, batch, OUT_SIZE)
    kw_drop = dict(kw, **DROPOUT)
    cases = [_case("model2_dropout", 2, kw_drop, "tiny", batch, noise),
             _case("model2_remat", 2, dict(kw_drop, remat=True), "tiny", batch, noise),
             _case("model2_jax", 2, kw, "tiny", batch, noise),
             _case("model2_bf16", 2, kw, "tiny", batch, noise, "bf16-mixed")]
    want = {"model2_jax": {"metrics": {k: float(v) for k, v in metrics.items()},
                           "params": _port_layout(new_state.params)}}
    for c in cases:
        want.setdefault(c["name"], {})["one"] = _one_process(
            c["kw"], tiny, batch, noise, OUT_SIZE, c["precision"])
    fit = {"kw": TINY_TRAIN, "dm": dm_args(corpus),
           "trainer": dict(lr=1e-3, seed=7, loggers={"csv": {}}, log_every_n_steps=1,
                           check_val_every_n_epoch=1, save_every_n_epochs=0, n_model_axis=2,
                           hparams={"model_kwargs": TINY_TRAIN})}
    ranks = _spawn(workdir, {"state_dict": {"tiny": tiny}, "steps": cases, "fit": fit}, 2)
    return {"ranks": ranks, "want": want, "workdir": workdir, "corpus": corpus}


@pytest.fixture(scope="module")
def tp4(tmp_path_factory):
    """4 ranks: n_model = 4 with 2 decoder heads (snake-beta and GEGLU),
    and data x model = 2 x 2."""
    workdir = str(tmp_path_factory.mktemp("tp4"))
    _, _, port, kw = port_tiny()
    kw2 = dict(kw, dec_num_heads=2)
    kw_geglu = dict(kw2, dec_act_fn="geglu")
    weights = {"heads2": _weights(kw2), "geglu": _weights(kw_geglu)}
    batch, noise = global_batch(4), _noise(4)
    cases = [_case("model4_split_heads", 4, dict(kw2, **DROPOUT), "heads2", batch, noise),
             _case("model4_geglu", 4, dict(kw_geglu, **DROPOUT), "geglu", batch, noise),
             _case("data2_model2", 2, kw2, "heads2", batch, noise)]
    want = {c["name"]: {"one": _one_process(c["kw"], weights[c["weights"]], batch, noise,
                                            OUT_SIZE)} for c in cases}
    ranks = _spawn(workdir, {"state_dict": weights, "steps": cases}, 4)
    return {"ranks": ranks, "want": want}


def _run(request, case):
    return request.getfixturevalue("tp2" if case.startswith("model2") else "tp4")


# ---------------------------------------------------------------------------
# the rules
# ---------------------------------------------------------------------------

def _flagship_port_params() -> dict:
    with torch.device("meta"):
        return dict(MatchaTTS().named_parameters())


def test_tp_rules_match_flagship_param_tree():
    """The port's analog of ``test_tensor_parallel.py``'s pattern-rot
    guard, on the flagship built on the meta device: every rule matches a
    parameter, and at n_model = 2 exactly 117 tensors split (60 in the
    encoder, 54 in the decoder's transformer blocks, 3 in the time MLP),
    holding more than 45 % of the elements."""
    params = _flagship_port_params()
    dead = [pat for pat, _ in TP_RULES if not any(re.match(pat, n) for n in params)]
    assert not dead, dead
    assert len(TP_RULES) == len(_TP_RULES) == 15
    split = {n: p for n, p in params.items() if param_shard_dim(n, p.shape, 2) is not None}
    enc = [n for n in split if n.startswith("encoder.")]
    dec = [n for n in split if ".attn1." in n or ".ff." in n]
    tmlp = [n for n in split if ".time_mlp." in n]
    assert (len(enc), len(dec), len(tmlp), len(split)) == (60, 54, 3, 117)
    n_split = sum(p.numel() for p in split.values())
    assert n_split / sum(p.numel() for p in params.values()) > 0.45
    # a row layer's bias never splits
    assert not [n for n in split if re.search(r"(conv_2|conv_o|to_out\.0|net\.2|linear_2)\.bias$",
                                               n)]


def test_tp_rules_split_what_jax_splits():
    """Under the weight bridge's name map (``convert.matcha_state_dict``)
    the port splits exactly the tensors JAX's ``param_pspec`` splits on
    the ``jax.eval_shape`` tree, each on the dim JAX's model axis maps to:
    each JAX leaf is filled with its index along its split axis, and the
    converted tensor varies along one dim only, the port's."""
    model = JaxMatchaTTS()
    tree = jax.eval_shape(lambda: _flagship_init(model))["params"]
    filled = {}
    for path, v in _flat_paths(tree):
        spec = param_pspec(path, v.shape, n_model=2)
        arr = np.zeros(v.shape, np.float32)
        if "model" in spec:
            axis = list(spec).index("model")
            shape = [1] * len(v.shape)
            shape[axis] = v.shape[axis]
            arr = arr + np.arange(1, v.shape[axis] + 1, dtype=np.float32).reshape(shape)
        node = filled
        for key in path.split("/")[:-1]:
            node = node.setdefault(key, {})
        node[path.split("/")[-1]] = arr
    sd = matcha_state_dict({"params": filled}, n_down_blocks=2, num_mid_blocks=2)
    want = {}
    for name, t in sd.items():
        varying = [d for d in range(t.dim()) if t.shape[d] > 1
                   and not torch.equal(t, t.narrow(d, 0, 1).expand_as(t))]
        assert len(varying) <= 1, (name, varying)
        if varying:
            want[name] = varying[0]
    params = _flagship_port_params()
    got = {n: d for n, p in params.items()
           if (d := param_shard_dim(n, p.shape, 2)) is not None}
    assert set(params) == set(sd) - {"mel_mean", "mel_std"}
    assert got == want and len(got) == 117


def test_mesh_coords_and_rows():
    """Rank r sits at data index r // n_model, model index r % n_model; a
    model group's ranks hold the same rows, split over the data indices
    by JAX's gcd((n_dev // n_model_axis) // pcount, local_bs)."""
    assert [mesh_coords(r, 2) for r in range(4)] == [(0, 0), (0, 1), (1, 0), (1, 1)]
    assert [rank_rows(8, r, 4, 8, 2) for r in range(4)] == [
        (0, 4, 1), (0, 4, 1), (4, 8, 1), (4, 8, 1)]
    assert [rank_rows(8, r, 4, 8, 4) for r in range(4)] == [(0, 8, 1)] * 4
    # 3 rows over 2 data indices: gcd(2, 3) = 1, the second a zero-weight copy
    assert [rank_rows(3, r, 4, 3, 2) for r in range(4)] == [
        (0, 3, 1), (0, 3, 1), (0, 3, 0), (0, 3, 0)]


def test_model_axis_needs_a_process_group(corpus):  # noqa: F811
    """Without a process group the mesh is 1 x 1 and a model axis of 2 is
    refused, by ``dist`` and by the trainer."""
    assert (dist.n_model(), dist.model_rank(), dist.n_data(), dist.data_rank()) == (1, 0, 1, 0)
    assert dist.model_group() is None and dist.data_group() is None
    dist.set_model_axis(1)
    with pytest.raises(ValueError, match="process group"):
        dist.set_model_axis(2)
    with pytest.raises(ValueError, match="process group"):
        port_trainer.Trainer(MatchaTTS(**TINY_TRAIN), TextMelDataModule(**dm_args(corpus)),
                             "cpu", n_model_axis=2)


# ---------------------------------------------------------------------------
# steps
# ---------------------------------------------------------------------------

STEP_CASES = ["model2_dropout", "model2_remat", "model4_split_heads", "model4_geglu",
              "data2_model2"]


def _assert_close_to_one_process(got: dict, one: dict, grad_of_max: float) -> None:
    for k in ("dur_loss", "prior_loss", "diff_loss", "loss", "grad_norm"):
        np.testing.assert_allclose(got["metrics"][k], one["metrics"][k], rtol=LOSS_RTOL,
                                   err_msg=k)
    assert set(got["grads"]) == set(one) - {"metrics"}
    for k, g in got["grads"].items():
        tol = grad_of_max * float(one[k].abs().max()) + GRAD_ATOL
        assert float((g - one[k]).abs().max()) <= tol, k


@pytest.mark.parametrize("case", STEP_CASES)
def test_split_step_matches_one_process(request, case):
    """Losses and gradient norm within rtol 1e-5 of the port's one-process
    step on the whole batch, and every gathered gradient within 1e-4 of
    its tensor's largest value, on every rank."""
    run = _run(request, case)
    for r in run["ranks"]:
        _assert_close_to_one_process(r[case], run["want"][case]["one"], GRAD_OF_MAX)


@pytest.mark.parametrize("case", STEP_CASES)
def test_split_ranks_hold_equal_replicas(request, case):
    """The ranks of a model group hold their replicated parameters and
    gradients bit for bit alike (f sums the input gradients of each split
    pair), and the gathered weights agree on every rank."""
    ranks = _run(request, case)["ranks"]
    for a in ranks[1:]:
        b = ranks[0]
        assert a[case]["split"] == b[case]["split"] and a[case]["split"]
        for k in b[case]["replicated_grads"]:
            assert torch.equal(a[case]["replicated_grads"][k], b[case]["replicated_grads"][k]), k
        for k in b[case]["replicated_params"]:
            assert torch.equal(a[case]["replicated_params"][k],
                               b[case]["replicated_params"][k]), k
        for k in b[case]["params"]:
            assert torch.equal(a[case]["params"][k], b[case]["params"][k]), k


def test_model2_step_matches_jax(tp2):
    """Dropout off, noise injected: the losses and gradient norm within
    rtol 1e-5 of JAX's ``make_train_step`` on both ranks, the updated
    weights within Adam's first-step tolerance (``test_torch_ddp.py``)."""
    want = tp2["want"]["model2_jax"]
    for r in tp2["ranks"]:
        got = r["model2_jax"]["metrics"]
        assert set(got) == set(want["metrics"])
        for k in got:
            np.testing.assert_allclose(got[k], want["metrics"][k], rtol=LOSS_RTOL, err_msg=k)
    got = tp2["ranks"][0]["model2_jax"]["params"]
    n = far = 0
    for k, w in want["params"].items():
        d = (got[k] - w).abs()
        assert float(d.max()) <= 2 * LR + 1e-7, k
        n += d.numel()
        far += int((d > PARAM_ATOL).sum())
    assert far <= PARAM_FLIP_SHARE * n, (far, n)
    _assert_close_to_one_process(tp2["ranks"][0]["model2_jax"], tp2["want"]["model2_jax"]["one"],
                                 GRAD_OF_MAX)


def test_bf16_model2_step(tp2):
    """``bf16-mixed`` on the split model (``functional_call`` on the
    ranks' bf16-rounded slices): against the one-process bf16 step, the
    losses within rtol 1e-5 and each gradient within 2^-7 of its tensor's
    largest (``test_bf16_step_syncs_through_ddp``'s bounds: a row layer's
    partial products are rounded to bf16 before their sum)."""
    one = tp2["want"]["model2_bf16"]["one"]
    for r in tp2["ranks"]:
        got = r["model2_bf16"]
        for k in ("dur_loss", "prior_loss", "diff_loss", "loss"):
            np.testing.assert_allclose(got["metrics"][k], one["metrics"][k], rtol=LOSS_RTOL,
                                       err_msg=k)
        for k, g in got["grads"].items():
            tol = 2.0**-7 * float(one[k].abs().max()) + GRAD_ATOL
            assert float((g - one[k]).abs().max()) <= tol, k


# ---------------------------------------------------------------------------
# fit, checkpoints, resume
# ---------------------------------------------------------------------------

def test_tp_checkpoint_is_full_and_ordinary(tp2, tmp_path):
    """The 2-step fit writes one checkpoint (rank 0's) of full-width
    weights and Adam moments: a plain model loads it strictly, an
    ``n_model_axis=1`` trainer resumes from it, the CLI serves it, and the
    JAX bridge reads its layout back to the same tensors."""
    a, b = (r["fit"] for r in tp2["ranks"])
    assert a["step"] == b["step"] == 2 and a["val"] and a["val"] == b["val"]
    ckpt_dir = os.path.join(tp2["workdir"], "fit", "checkpoints")
    assert sorted(os.listdir(ckpt_dir)) == ["last", "last.hparams.json"]
    path = os.path.join(ckpt_dir, "last")
    payload = load_native_checkpoint(path)
    full = MatchaTTS(**TINY_TRAIN)
    assert {k: v.shape for k, v in payload["model"].items()} == {
        k: v.shape for k, v in full.state_dict().items()}
    full.load_state_dict(payload["model"])
    for k, v in a["params"].items():
        assert torch.equal(payload["model"][k], v), k
    trainer = port_trainer.Trainer(MatchaTTS(**TINY_TRAIN),
                                   TextMelDataModule(**dm_args(tp2["corpus"])), "cpu",
                                   output_dir=str(tmp_path), loggers={})
    trainer.restore(path)
    assert trainer.step == 2
    for p in trainer.model.parameters():
        st = trainer.optimizer.state[p]
        assert st["exp_avg"].shape == p.shape and float(st["exp_avg"].abs().max()) > 0
    served = cli.load_matcha(path, device="cpu")
    for k, v in served.state_dict().items():
        assert torch.equal(v, payload["model"][k]), k
    sd = {k: v.numpy() for k, v in payload["model"].items()}
    back = matcha_state_dict(convert_matcha_state_dict(sd, n_down_blocks=2, num_mid_blocks=1),
                             n_down_blocks=2, num_mid_blocks=1,
                             mel_mean=float(sd["mel_mean"]), mel_std=float(sd["mel_std"]))
    for k, v in payload["model"].items():
        assert torch.equal(back[k], v), k


def test_tp_resume_bit_identical(tp2):
    """Resumed from the 2-step checkpoint (sharded again), step 3 gives
    the uninterrupted split run's losses, validation and weights bit for
    bit on both ranks."""
    for r in tp2["ranks"]:
        resumed, straight = r["resumed"], r["straight"]
        assert resumed["step"] == straight["step"] == 3
        assert resumed["result"] == straight["result"]
        assert resumed["val"][3] == straight["val"][3]
        for k in straight["params"]:
            assert torch.equal(resumed["params"][k], straight["params"][k]), k
