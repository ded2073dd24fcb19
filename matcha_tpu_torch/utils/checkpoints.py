"""The port's native training checkpoints.

The counterpart of ``matcha_tpu/utils/checkpoints.py``'s native
save/load: one ``torch.save`` file ``<ckpt_dir>/<name>`` holding the
model's and the optimizer's ``state_dict``s (and the learning-rate
schedule's), the step and the count of completed epochs, beside the same
``<name>.hparams.json`` the JAX package writes. Resuming from it
continues the run bit for bit. In a process group only rank 0 writes;
every rank returns from the save once the file is on disk.
"""

import json
import os
from typing import Optional

import torch

from matcha_tpu_torch.parallel import dist


def save_native_checkpoint(ckpt_dir: str, model: torch.nn.Module, hparams: dict,
                           step: int = 0, optimizer=None, scheduler=None, epoch: int = 0,
                           name: Optional[str] = None) -> str:
    """Write the training state and its hparams json; returns the path.
    ``epoch`` is the number of completed epochs. Rank 0 writes, then every
    rank meets at a barrier."""
    ckpt_dir = os.path.abspath(ckpt_dir)
    name = name if name is not None else f"checkpoint_{step:06d}"
    path = os.path.join(ckpt_dir, name)
    if dist.rank() == 0:
        _write(ckpt_dir, path, name, model, hparams, step, optimizer, scheduler, epoch)
    dist.barrier()
    return path


def _write(ckpt_dir, path, name, model, hparams, step, optimizer, scheduler, epoch) -> None:
    os.makedirs(ckpt_dir, exist_ok=True)
    payload = {"model": model.state_dict(), "step": int(step), "epoch": int(epoch)}
    if optimizer is not None:
        payload["optimizer"] = optimizer.state_dict()
    if scheduler is not None:
        payload["scheduler"] = scheduler.state_dict()
    tmp = f"{path}.{os.getpid()}.tmp"
    torch.save(payload, tmp)
    os.replace(tmp, path)
    with open(os.path.join(ckpt_dir, f"{name}.hparams.json"), "w", encoding="utf-8") as f:
        json.dump({"hparams": hparams, "step": int(step), "epoch": int(epoch)}, f, indent=2,
                  default=str)


def load_native_checkpoint(path: str, map_location="cpu") -> dict:
    """The payload of a native checkpoint: ``model`` and, when saved,
    ``optimizer`` and ``scheduler`` state dicts, ``step``, ``epoch``, and
    ``hparams`` from the json beside it ({} when it is missing)."""
    path = os.path.abspath(path)
    payload = torch.load(path, map_location=map_location, weights_only=True)
    hparams = {}
    if os.path.exists(path + ".hparams.json"):
        with open(path + ".hparams.json", encoding="utf-8") as f:
            hparams = json.load(f).get("hparams", {})
    payload["hparams"] = hparams
    return payload


def scan_checkpoints(ckpt_dir: str) -> Optional[str]:
    """The latest ``checkpoint_<step>`` in a directory, or None."""
    if not os.path.isdir(ckpt_dir):
        return None
    cands = [d for d in os.listdir(ckpt_dir)
             if d.startswith("checkpoint_") and not d.endswith((".json", ".tmp"))]
    return os.path.join(ckpt_dir, sorted(cands)[-1]) if cands else None
