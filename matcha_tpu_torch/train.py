"""Training entry point: ``python -m matcha_tpu_torch.train [overrides...]``.

The port of ``matcha_tpu/train.py``: it composes the repo's ``configs/``
tree with the same override syntax
(``experiment=ljspeech trainer.max_steps=100 data.batch_size=16``),
builds the model and the data module, and trains on the card, or on the
CPU with ``trainer.accelerator=cpu``. Without a card and without that
override it raises. Before training it applies the config's ``extras``
(``extras.print_config`` writes ``config_tree.log``,
``extras.enforce_tags`` ``tags.log`` into the output directory).

Several GPUs (``parallel/dist.py``): under ``torchrun --nproc_per_node N``
(or the ``MATCHA_*`` env contract) each process joins the NCCL group and
trains on ``cuda:<LOCAL_RANK>`` of the GPUs ``trainer.devices`` selects.
Started without a launcher, ``main`` with ``trainer.devices`` selecting
more than one GPU starts one worker per selected GPU itself (one node, a
file store in a temporary directory), as one JAX process uses all the
devices it is given. ``trainer.accelerator=cpu`` under ``torchrun`` trains
on the CPU over gloo.
"""

import json
import logging
import os
import sys
import tempfile
from typing import Optional, Tuple

from matcha_tpu_torch import resolve_device
from matcha_tpu_torch.parallel import dist
from matcha_tpu_torch.utils.config import compose, save_config
from matcha_tpu_torch.utils.pylogger import get_pylogger
from matcha_tpu_torch.utils.utils import extras, get_metric_value, task_wrapper

log = get_pylogger(__name__)


def build_model_from_cfg(cfg):
    """MatchaTTS from the composed config's ``model`` tree."""
    from matcha_tpu_torch.models.matcha import MatchaTTS

    m = cfg.model
    enc = m.encoder.encoder_params
    dp = m.encoder.duration_predictor_params
    dec = m.decoder
    stats = m.get("data_statistics") or {}
    return MatchaTTS(
        n_vocab=int(m.n_vocab),
        n_spks=int(m.n_spks),
        spk_emb_dim=int(m.spk_emb_dim),
        n_feats=int(m.n_feats),
        enc_n_channels=int(enc.n_channels),
        enc_filter_channels=int(enc.filter_channels),
        enc_filter_channels_dp=int(enc.filter_channels_dp),
        enc_n_heads=int(enc.n_heads),
        enc_n_layers=int(enc.n_layers),
        enc_kernel_size=int(enc.kernel_size),
        enc_p_dropout=float(enc.p_dropout),
        enc_prenet=bool(enc.prenet),
        dp_kernel_size=int(dp.kernel_size),
        dec_channels=tuple(dec.channels),
        dec_dropout=float(dec.dropout),
        dec_attention_head_dim=int(dec.attention_head_dim),
        dec_n_blocks=int(dec.n_blocks),
        dec_num_mid_blocks=int(dec.num_mid_blocks),
        dec_num_heads=int(dec.num_heads),
        dec_act_fn=str(dec.act_fn),
        dec_down_block_type=str(dec.get("down_block_type", "transformer")),
        dec_mid_block_type=str(dec.get("mid_block_type", "transformer")),
        dec_up_block_type=str(dec.get("up_block_type", "transformer")),
        dec_conformer_batch_norm=bool(dec.get("conformer_batch_norm", False)),
        sigma_min=float(m.cfm.sigma_min),
        prior_loss=bool(m.prior_loss),
        mel_mean=float(stats.get("mel_mean", 0.0)),
        mel_std=float(stats.get("mel_std", 1.0)),
    )


def build_datamodule_from_cfg(cfg):
    from matcha_tpu_torch.training.data import TextMelDataModule

    d = dict(cfg.data)
    d.pop("_target_", None)
    return TextMelDataModule(**d)


def _on_cpu(cfg) -> bool:
    return str(cfg.trainer.get("accelerator", "auto")) == "cpu"


def _selected_gpus(cfg):
    """The local GPUs ``trainer.devices`` selects (raises without one)."""
    from matcha_tpu_torch.parallel.mesh import local_devices

    resolve_device(None)
    return local_devices(cfg.trainer.get("devices", "all"))


def train_device(cfg):
    """``trainer.accelerator=cpu`` -> the CPU; anything else -> the card
    (raises without one): in a process group the selected GPU of this
    rank's local rank, else the first selected GPU."""
    if _on_cpu(cfg):
        return resolve_device("cpu")
    return _selected_gpus(cfg)[dist.local_rank()]


@task_wrapper
def train(cfg) -> Tuple[dict, dict]:
    import torch

    from matcha_tpu_torch.training.trainer import Trainer

    device = train_device(cfg)
    seed = int(cfg.get("seed", 1234))
    torch.manual_seed(seed)  # the initial weights
    datamodule = build_datamodule_from_cfg(cfg)
    model = build_model_from_cfg(cfg)

    t = cfg.trainer
    output_dir = cfg.paths.output_dir
    os.makedirs(output_dir, exist_ok=True)
    if dist.rank() == 0:
        save_config(cfg, os.path.join(output_dir, "config.yaml"))

    cbs = cfg.get("callbacks") or {}
    cb = cbs.get("model_checkpoint") or {}
    ms = cbs.get("model_summary")
    trainer = Trainer(
        model=model,
        datamodule=datamodule,
        device=device,
        out_size=cfg.model.get("out_size"),
        lr=float(cfg.model.optimizer.get("lr", 1e-4)),
        weight_decay=float(cfg.model.optimizer.get("weight_decay", 0.0)),
        gradient_clip_val=float(t.get("gradient_clip_val", 5.0)),
        max_epochs=int(t.get("max_epochs", -1)),
        max_steps=int(t.get("max_steps", -1)),
        check_val_every_n_epoch=int(t.get("check_val_every_n_epoch", 1)),
        log_every_n_steps=int(t.get("log_every_n_steps", 10)),
        output_dir=output_dir,
        seed=seed,
        fast_dev_run=bool(t.get("fast_dev_run", False)),
        overfit_batches=int(t.get("overfit_batches", 0)),
        limit_train_batches=t.get("limit_train_batches"),
        limit_val_batches=t.get("limit_val_batches"),
        detect_anomaly=bool(t.get("detect_anomaly", False)),
        save_every_n_epochs=int(cb.get("every_n_epochs", 100)),
        save_top_k=int(cb.get("save_top_k", 10)),
        monitor=str(cb.get("monitor", "epoch")),
        monitor_mode=str(cb.get("mode", "max")),
        enable_checkpointing="model_checkpoint" in cbs,
        save_last=bool(cb.get("save_last", True)),
        model_summary_depth=int(ms.get("max_depth", 3)) if ms is not None else 0,
        enable_progress_bar="rich_progress_bar" in cbs,
        precision=str(t.get("precision", "f32")),
        hparams={"cfg": dict(cfg)},
        scheduler=cfg.model.get("scheduler"),
        loggers=cfg.get("logger", {"tensorboard": {}}),
        profiler=t.get("profiler"),
    )

    metric_dict = {}
    if cfg.get("train", True):
        log.info("Starting training!")
        metric_dict = trainer.fit(restore_from=cfg.get("ckpt_path"))
    return metric_dict, {"cfg": cfg, "datamodule": datamodule, "model": model,
                         "trainer": trainer}


def _launcher_env() -> bool:
    env = os.environ
    return bool(env.get("MATCHA_COORDINATOR_ADDRESS") or env.get("MATCHA_DIST") == "1"
                or "TORCHELASTIC_RUN_ID" in env)


def _run(cfg) -> Optional[float]:
    extras(cfg)
    metric_dict, _ = train(cfg)
    return get_metric_value(metric_dict, cfg.get("optimized_metric"))


def _worker(local_rank: int, cfg, result_path: str) -> None:
    """One GPU's process of a run that ``main`` started itself."""
    logging.basicConfig(level=logging.INFO,
                        format="[%(asctime)s][%(name)s][%(levelname)s] - %(message)s")
    metric = _run(cfg)
    if dist.rank() == 0:
        with open(result_path, "w", encoding="utf-8") as f:
            json.dump({"metric": metric}, f)


def main(argv=None) -> Optional[float]:
    logging.basicConfig(level=logging.INFO,
                        format="[%(asctime)s][%(name)s][%(levelname)s] - %(message)s")
    cfg = compose("train", overrides=list(sys.argv[1:] if argv is None else argv))
    joined = False
    if _launcher_env() and not dist.is_initialized():
        cpu = _on_cpu(cfg)
        device = None if cpu else _selected_gpus(cfg)[int(os.environ.get("LOCAL_RANK", 0))]
        dist.maybe_initialize_distributed(backend="gloo" if cpu else "nccl", device=device)
        joined = True
    elif not _on_cpu(cfg) and len(_selected_gpus(cfg)) > 1:
        gpus = _selected_gpus(cfg)
        log.info(f"Training on {len(gpus)} GPUs: one process each")
        with tempfile.TemporaryDirectory(prefix="matcha-ddp-") as tmp:
            result = os.path.join(tmp, "result.json")
            dist.launch_local(_worker, (cfg, result), len(gpus), "nccl", tmp, timeout_s=None,
                              cuda_devices=[d.index for d in gpus])
            with open(result, encoding="utf-8") as f:
                return json.load(f)["metric"]
    try:
        return _run(cfg)
    finally:
        if joined:
            dist.destroy()


if __name__ == "__main__":
    main()
