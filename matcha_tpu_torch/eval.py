"""Evaluation entry: ``python -m matcha_tpu_torch.eval ckpt_path=... [overrides]``.

The port of ``matcha_tpu/eval.py``: composes ``configs/eval.yaml``,
builds the model and the data module with ``train.py``'s
``build_model_from_cfg`` and ``build_datamodule_from_cfg``,
loads the port's native checkpoint, and averages the validation losses
of ``trainer.eval_step`` over the validation batches (MAS: K2 on the
card). On the first batch, unless ``eval_mcd=false``, it synthesises two
utterances at 10 steps and reports their MCD against the target mels
(``mcd_vs_target``, ``utils/metrics.py``). It runs on the card, or on the
CPU with ``trainer.accelerator=cpu``.
"""

import sys
from typing import Callable, Optional

import numpy as np
import torch

from matcha_tpu_torch.utils.config import compose
from matcha_tpu_torch.utils.pylogger import get_pylogger
from matcha_tpu_torch.utils.utils import task_wrapper

log = get_pylogger(__name__)


@task_wrapper
def evaluate(cfg, noise: Optional[Callable[[int, dict], dict]] = None,
             mcd_z: Optional[torch.Tensor] = None):
    """(means, {"cfg": cfg}). The noise is JAX's key chain's counterpart:
    every batch's losses draw from a generator seeded 0 and the synthesis
    from one seeded 1, unless given: ``noise(batch_index, batch)`` returns
    the ``t``, ``z`` (and ``offsets``) of a batch's losses, and ``mcd_z``
    is the synthesis's unit noise (2, T_y, n_feats)."""
    from matcha_tpu_torch.train import (build_datamodule_from_cfg, build_model_from_cfg,
                                        train_device)
    from matcha_tpu_torch.training.trainer import eval_step, to_device
    from matcha_tpu_torch.utils.checkpoints import load_native_checkpoint
    from matcha_tpu_torch.utils.metrics import mcd

    if not cfg.get("ckpt_path") or cfg.get("ckpt_path") == "???":
        raise ValueError("eval requires ckpt_path=...")
    device = train_device(cfg)
    datamodule = build_datamodule_from_cfg(cfg)
    model = build_model_from_cfg(cfg)
    payload = load_native_checkpoint(cfg.ckpt_path)
    model.load_state_dict(payload["model"])
    model.to(device)
    log.info(f"Loaded checkpoint at step {payload['step']}")

    sums, count, mcds = {}, 0, []
    for bi, batch in enumerate(datamodule.val_batches()):
        dev = to_device(batch, device)
        m = eval_step(model, dev, noise=None if noise is None else noise(bi, batch))
        for k, v in m.items():
            sums[k] = sums.get(k, 0.0) + float(v)
        count += 1
        if bi == 0 and cfg.get("eval_mcd", True):
            spks = dev.get("spks")
            out = model.synthesise(
                dev["x"][:2], dev["x_lengths"][:2], n_timesteps=10,
                y_max_length=batch["y"].shape[1], z=mcd_z,
                generator=torch.Generator(device).manual_seed(1),
                spks=None if spks is None else spks[:2])
            gen_mels = out["decoder_outputs"].float().cpu().numpy()
            mel_lengths = out["mel_lengths"].cpu().numpy()
            for i in range(min(2, batch["y"].shape[0])):
                target = batch["y"][i].T  # (F, T), normalised
                L = int(min(batch["y_lengths"][i], mel_lengths[i]))
                mcds.append(mcd(gen_mels[i], target, lengths=L))
    means = {k: v / max(count, 1) for k, v in sums.items()}
    if mcds:
        means["mcd_vs_target"] = float(np.mean(mcds))
    for k, v in sorted(means.items()):
        log.info(f"{k}: {v:.5f}")
        print(f"{k}: {v:.5f}")
    return means, {"cfg": cfg}


def main(argv=None) -> Optional[dict]:
    import logging

    logging.basicConfig(level=logging.INFO)
    argv = list(sys.argv[1:] if argv is None else argv)
    cfg = compose("eval", overrides=argv)
    metrics, _ = evaluate(cfg)
    return metrics


if __name__ == "__main__":
    main()
