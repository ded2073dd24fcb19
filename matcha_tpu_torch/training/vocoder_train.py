"""HiFi-GAN vocoder training entry point.

``python -m matcha_tpu_torch.training.vocoder_train --train-filelist ... --output-dir ...``

The port of ``matcha_tpu/training/vocoder_train.py``, with its flags:
the v1 generator with the MPD and MSD, all weight-normed (the MSD's scale
0 spectrally normalised with a running u); LSGAN + feature matching +
45 x mel L1; Adam(0.8, 0.99) at ``lr * 0.999 ** epoch``; random
8,192-sample segments (``MelDataset``), or fine-tuning on precomputed
mels (``--fine-tuning --base-mels-path``). It runs on the card unless
``--device cpu`` is given, and raises without one.

Checkpoints are the port's own format (``torch.save`` of the models,
the MSD's u, both optimisers and the step) at ``checkpoints/last`` after
every epoch and ``checkpoints/g_{step:08d}`` every
``--save-every-n-epochs``, each beside a ``.meta.json`` with the step and
the epoch; ``--restore-from`` continues from one exactly. Metrics
(``loss/gen``, ``loss/disc``, ``loss/mel_l1``) go to tensorboard and
``csv/metrics.csv``.
"""

import argparse
import json
import logging
import os
import time
from typing import Optional

import torch

from matcha_tpu_torch import resolve_device
from matcha_tpu_torch.models.hifigan import HiFiGANConfig
from matcha_tpu_torch.training.trainer import MetricLogger, prefetch_iterator
from matcha_tpu_torch.training.vocoder_data import MelDataset
from matcha_tpu_torch.training.vocoder_trainer import (
    VocoderTrainState,
    init_vocoder_state,
    vocoder_train_step,
)

log = logging.getLogger(__name__)


def save_vocoder_checkpoint(ckpt_dir: str, state: VocoderTrainState, epoch: int,
                            tag: Optional[str] = None) -> str:
    """The full training state at ``ckpt_dir/<tag or g_{step:08d}>``, and
    the step and epoch in ``.meta.json`` beside it."""
    os.makedirs(ckpt_dir, exist_ok=True)
    path = os.path.abspath(os.path.join(ckpt_dir, tag or f"g_{state.step:08d}"))
    tmp = f"{path}.{os.getpid()}.tmp"
    torch.save(state.state_dict(), tmp)
    os.replace(tmp, path)
    with open(path + ".meta.json", "w", encoding="utf-8") as f:
        json.dump({"step": state.step, "epoch": epoch}, f)
    return path


def load_vocoder_checkpoint(path: str, state: VocoderTrainState) -> int:
    """Load a checkpoint into ``state``; returns the epochs it had
    completed. Read on the host: ``load_state_dict`` moves the weights and
    the optimisers' moments to the models' device and leaves Adam's step
    counts on the host, where a fresh optimiser keeps them."""
    state.load_state_dict(torch.load(path, map_location="cpu", weights_only=True))
    try:
        with open(path + ".meta.json", encoding="utf-8") as f:
            return int(json.load(f).get("epoch", 0))
    except OSError:
        return 0


def train(args, h: Optional[HiFiGANConfig] = None) -> dict:
    """Train from the parsed ``args``; returns the last logged metrics."""
    device = resolve_device(args.device)
    if h is None:
        h = HiFiGANConfig(segment_size=args.segment_size)
    if args.batch_size:
        h.batch_size = args.batch_size
    if args.learning_rate:
        h.learning_rate = args.learning_rate
    ds = MelDataset(
        args.train_filelist, segment_size=h.segment_size, n_fft=h.n_fft,
        num_mels=h.num_mels, hop_size=h.hop_size, win_size=h.win_size,
        sampling_rate=h.sampling_rate, fmin=h.fmin, fmax=h.fmax,
        fmax_loss=None, seed=h.seed,
        fine_tuning=args.fine_tuning, base_mels_path=args.base_mels_path,
    )
    # full batches only: the remainder of an epoch is dropped
    state = init_vocoder_state(h, device, steps_per_epoch=max(1, len(ds) // h.batch_size))
    start_epoch = 0
    ckpt_dir = os.path.join(args.output_dir, "checkpoints")
    if args.restore_from:
        start_epoch = load_vocoder_checkpoint(args.restore_from, state)
        log.info(f"Restored vocoder state at step {state.step} (epoch {start_epoch})")

    logger = MetricLogger(os.path.join(args.output_dir, "tensorboard"),
                          os.path.join(args.output_dir, "csv", "metrics.csv"))
    pin = device.type == "cuda"
    last = {}
    for epoch in range(start_epoch, args.epochs):
        t0 = time.time()
        for batch in prefetch_iterator(ds.batches(h.batch_size, epoch=epoch), pin=pin):
            batch = {k: v.to(device, non_blocking=True) for k, v in batch.items()}
            metrics = vocoder_train_step(state, batch)
            if state.step % args.log_every_n_steps == 0:
                last = {k: float(v) for k, v in metrics.items()}
                logger.scalars({"loss/gen": last["gen_loss"], "loss/disc": last["disc_loss"],
                                "loss/mel_l1": last["mel_l1"]}, state.step)
                log.info(f"epoch {epoch} step {state.step}: gen={last['gen_loss']:.3f} "
                         f"disc={last['disc_loss']:.3f} mel_l1={last['mel_l1']:.3f}")
            if args.max_steps and state.step >= args.max_steps:
                break
        save_vocoder_checkpoint(ckpt_dir, state, epoch + 1, tag="last")
        if (epoch + 1) % args.save_every_n_epochs == 0:
            save_vocoder_checkpoint(ckpt_dir, state, epoch + 1)
        log.info(f"epoch {epoch} done in {time.time() - t0:.1f}s")
        if args.max_steps and state.step >= args.max_steps:
            break
    logger.close()
    return last


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description="Train HiFi-GAN (the PyTorch port's vocoder)")
    p.add_argument("--train-filelist", type=str, required=True, help="`path|...` filelist of wavs")
    p.add_argument("--output-dir", type=str, default="logs/vocoder")
    p.add_argument("--epochs", type=int, default=3100)
    p.add_argument("--max-steps", type=int, default=0, help="stop after N steps (0 = unlimited)")
    p.add_argument("--batch-size", type=int, default=None)
    p.add_argument("--learning-rate", type=float, default=None)
    p.add_argument("--segment-size", type=int, default=8192)
    p.add_argument("--log-every-n-steps", type=int, default=20)
    p.add_argument("--save-every-n-epochs", type=int, default=50)
    p.add_argument("--restore-from", type=str, default=None)
    p.add_argument("--fine-tuning", action="store_true",
                   help="fine-tune on precomputed mels read from --base-mels-path")
    p.add_argument("--base-mels-path", type=str, default=None)
    p.add_argument("--device", type=str, default=None,
                   help="torch device (default: the GPU; raises without one)")
    return p.parse_args(argv)


def main(argv=None) -> dict:
    logging.basicConfig(level=logging.INFO, format="[%(asctime)s][%(name)s] %(message)s")
    return train(parse_args(argv))


if __name__ == "__main__":
    main()
