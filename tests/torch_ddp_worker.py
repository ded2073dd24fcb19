"""The rank side of ``tests/test_torch_ddp.py``: functions that
``parallel.dist.launch_local`` runs in spawned processes. This module
imports torch and the port only (no JAX), so the workers start quickly;
the test reads what each rank saved.

``run(local_rank, workdir)`` reads ``<workdir>/in.pt``:

* ``kw``, ``state_dict``: a tiny ``MatchaTTS`` and its weights;
* ``steps``: cases {"name", "batch" (the global numpy batch, padded to
  its longest row), "noise" (the global batch's t, z, offsets),
  "out_size", "lr", "seed"[, "precision"]}: one data-parallel step each,
  on this rank's
  rows as ``training/data.py`` assigns them, cropped to the rows' own
  longest lengths so that ``share_batch`` must pad them back;
* ``fit``: {"kw", "dm", "trainer"}: a 2-step ``Trainer.fit`` with a
  validation, a resume from its checkpoint to step 3, and an
  uninterrupted 3-step run;

and writes ``<workdir>/rank<i>.pt``.

``run_tp(local_rank, workdir)`` is the same for ``tests/
test_torch_tensor_parallel.py``: each step case also names its
``n_model`` (the model axis; the data axis takes the other ranks) and its
model's ``kw``, and saves the gathered gradients and weights beside the
rank's own replicated ones; ``fit`` names ``n_model`` too. It writes
``<workdir>/tp<i>.pt``.
"""

import os
import time

import numpy as np
import torch

from matcha_tpu_torch.models.matcha import MatchaTTS
from matcha_tpu_torch.parallel import dist, tensor
from matcha_tpu_torch.parallel.mesh import rank_rows
from matcha_tpu_torch.training import trainer as port_trainer
from matcha_tpu_torch.training.data import TextMelDataModule


def rank_batch(batch: dict, local_rank: int, world: int, n_model: int = 1) -> dict:
    """This rank's rows of a global numpy batch, cropped to their own
    longest lengths, with ``rows``."""
    B = batch["x"].shape[0]
    start, stop, weight = rank_rows(B, local_rank, world, B, n_model)
    rows = {k: v[start:stop] for k, v in batch.items()}
    rows["x"] = rows["x"][:, :int(rows["x_lengths"].max())]
    rows["y"] = rows["y"][:, :int(rows["y_lengths"].max())]
    rows["rows"] = np.asarray([start, stop, weight], np.int64)
    return rows


def step_case(local_rank: int, kw: dict, state_dict: dict, case: dict) -> dict:
    model = MatchaTTS(**kw)
    model.load_state_dict(state_dict)
    precision = case.get("precision", "f32")
    ddp = port_trainer.make_ddp(model, "cpu", case["out_size"], precision)
    opt, sched = port_trainer.make_optimizer(model, lr=case["lr"])
    host, share = port_trainer.share_batch(
        rank_batch(case["batch"], local_rank, dist.world_size()), case["out_size"])
    grads = {}

    def keep_grads(phase):
        if phase == "backward":
            grads.update({k: p.grad.clone() for k, p in model.named_parameters()})

    metrics = port_trainer.train_step(
        model, opt, sched, port_trainer.to_device(host, "cpu"), 0, case["seed"],
        case["out_size"], 5.0, noise=case["noise"], on_phase=keep_grads, precision=precision,
        ddp=ddp, share=share)
    return {"metrics": {k: float(v) for k, v in metrics.items()},
            "params": {k: v.detach().clone() for k, v in model.state_dict().items()},
            "grads": grads, "share": share}


def tp_step_case(local_rank: int, state_dict: dict, case: dict) -> dict:
    """One step of a model split over ``case["n_model"]`` ranks: the
    metrics, the gathered gradients (before the clip) and weights, and
    the rank's replicated gradients and weights as they are."""
    dist.set_model_axis(case["n_model"])
    model = MatchaTTS(**case["kw"])
    model.load_state_dict(state_dict)
    tensor.shard_model(model)
    precision = case.get("precision", "f32")
    loss = (port_trainer.make_ddp(model, "cpu", case["out_size"], precision) if dist.n_data() > 1
            else port_trainer.BatchLoss(model, case["out_size"], precision))
    opt, sched = port_trainer.make_optimizer(model, lr=case["lr"])
    host, share = port_trainer.share_batch(
        rank_batch(case["batch"], local_rank, dist.world_size(), dist.n_model()),
        case["out_size"])
    plan = tensor.plan_of(model)
    grads, own = {}, {}

    def keep_grads(phase):
        if phase == "backward":
            for k, p in model.named_parameters():
                grads[k] = tensor.full_tensor(model, k, p.grad.clone())
                if k not in plan.dims:
                    own[k] = p.grad.clone()

    metrics = port_trainer.train_step(
        model, opt, sched, port_trainer.to_device(host, "cpu"), 0, case["seed"],
        case["out_size"], 5.0, noise=case["noise"], on_phase=keep_grads, precision=precision,
        ddp=loss, share=share)
    return {"metrics": {k: float(v) for k, v in metrics.items()},
            "params": {k: v.detach().clone() for k, v in tensor.full_state_dict(model).items()},
            "grads": grads, "replicated_grads": own,
            "replicated_params": {k: v.detach().clone() for k, v in model.state_dict().items()
                                  if k not in plan.dims},
            "split": sorted(plan.dims), "share": share}


def fit_case(cfg: dict, out_dir: str, max_steps: int, restore_from=None) -> dict:
    torch.manual_seed(0)
    trainer = port_trainer.Trainer(MatchaTTS(**cfg["kw"]), TextMelDataModule(**cfg["dm"]), "cpu",
                                   output_dir=out_dir, max_steps=max_steps, **cfg["trainer"])
    val = {}
    validate = trainer.validate

    def record(epoch):
        means = validate(epoch)
        val[trainer.step] = means
        return means

    trainer.validate = record
    result = trainer.fit(restore_from=restore_from)
    return {"result": result, "val": val, "step": trainer.step,
            "params": {k: v.detach().clone()
                       for k, v in tensor.full_state_dict(trainer.model).items()}}


def run(local_rank: int, workdir: str) -> None:
    spec = torch.load(os.path.join(workdir, "in.pt"), weights_only=False)
    out = {"world": dist.world_size(), "rank": dist.rank()}
    for case in spec.get("steps", []):
        out[case["name"]] = step_case(local_rank, spec["kw"], spec["state_dict"], case)
    if "fit" in spec:
        cfg = spec["fit"]
        first = os.path.join(workdir, "fit")
        out["fit"] = fit_case(cfg, first, 2)
        out["resumed"] = fit_case(cfg, os.path.join(workdir, "resumed"), 3,
                                  restore_from=os.path.join(first, "checkpoints", "last"))
        out["straight"] = fit_case(cfg, os.path.join(workdir, "straight"), 3)
    torch.save(out, os.path.join(workdir, f"rank{local_rank}.pt"))


def run_tp(local_rank: int, workdir: str) -> None:
    spec = torch.load(os.path.join(workdir, "in.pt"), weights_only=False)
    out = {"world": dist.world_size(), "rank": dist.rank()}
    for case in spec.get("steps", []):
        out[case["name"]] = tp_step_case(local_rank, spec["state_dict"][case["weights"]], case)
    if "fit" in spec:
        cfg = spec["fit"]
        first = os.path.join(workdir, "fit")
        out["fit"] = fit_case(cfg, first, 2)
        out["resumed"] = fit_case(cfg, os.path.join(workdir, "resumed"), 3,
                                  restore_from=os.path.join(first, "checkpoints", "last"))
        out["straight"] = fit_case(cfg, os.path.join(workdir, "straight"), 3)
    torch.save(out, os.path.join(workdir, f"tp{local_rank}.pt"))


def fail(local_rank: int) -> None:
    """Rank 1 raises, rank 0 would run on: the launcher must report rank
    1's error and end rank 0."""
    if local_rank == 1:
        raise ValueError("rank 1 fails on purpose")
    time.sleep(300)
