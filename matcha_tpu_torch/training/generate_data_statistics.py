"""Mel statistics of a data config: ``python -m matcha_tpu_torch.training.generate_data_statistics``.

The port of ``matcha_tpu/training/generate_data_statistics.py``, with its
arguments and output: the train split is read with the statistics
nulled (mean 0, std 1), the masked mel sum and sum of squares are
accumulated, and ``{"mel_mean": ..., "mel_std": ...}`` is written as JSON
(default ``<config>-stats.json``; ``--force`` overwrites). Overrides after
the flags go to the config, as for ``matcha_tpu_torch.train``. It runs
on the host only.
"""

import argparse
import json
import logging
import os
import sys

import numpy as np

from matcha_tpu_torch.utils.config import compose

log = logging.getLogger(__name__)


def compute_data_statistics(datamodule) -> dict:
    total_sum = 0.0
    total_sq = 0.0
    total_count = 0
    for batch in datamodule.train_batches(0):
        y, y_lengths = batch["y"], batch["y_lengths"]  # (B, T, F)
        for i in range(y.shape[0]):
            mel = y[i, :y_lengths[i]]
            total_sum += mel.sum()
            total_sq += (mel ** 2).sum()
            total_count += mel.size
    mean = total_sum / total_count
    std = float(np.sqrt(total_sq / total_count - mean ** 2))
    return {"mel_mean": float(mean), "mel_std": std}


def main(argv=None) -> None:
    logging.basicConfig(level=logging.INFO, format="[%(asctime)s][%(name)s] %(message)s")
    parser = argparse.ArgumentParser(description="Compute mel statistics for a data config")
    parser.add_argument("-i", "--input-config", default="ljspeech",
                        help="data config name (configs/data/<name>.yaml)")
    parser.add_argument("-b", "--batch-size", type=int, default=32)
    parser.add_argument("-f", "--force", action="store_true")
    parser.add_argument("-o", "--output", default=None, help="output JSON path")
    args, extra = parser.parse_known_args(argv)

    cfg = compose(
        "train",
        overrides=[f"data={args.input_config}", f"data.batch_size={args.batch_size}",
                   "data.data_statistics.mel_mean=0.0", "data.data_statistics.mel_std=1.0",
                   *extra],
    )
    out_file = args.output or f"{args.input_config}-stats.json"
    if os.path.exists(out_file) and not args.force:
        print(f"{out_file} exists; use --force to overwrite")
        sys.exit(1)

    from matcha_tpu_torch.train import build_datamodule_from_cfg

    stats = compute_data_statistics(build_datamodule_from_cfg(cfg))
    print(stats)
    with open(out_file, "w", encoding="utf-8") as f:
        json.dump(stats, f, indent=4)
    log.info(f"Data statistics saved to {out_file}")


if __name__ == "__main__":
    main()
