"""The benchmark's own tests: ``python -m pytest benchmark/tests -q`` from
the checkout's root. Those marked ``cuda`` skip without a card."""

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

import json

import pytest


def tiny_cell(name: str, **traffic) -> dict:
    """Cell ``name`` at a size a CPU test run holds: narrow models, short
    texts, few answers checked; the limits are the cell's own."""
    from benchmark.harness import common
    cell = common.resolve_cell(common.load_spec(), name)
    cfg = json.loads(json.dumps(cell["config"]))
    cfg["model"].update(enc_n_channels=32, enc_filter_channels=64, enc_filter_channels_dp=32,
                        enc_n_layers=1, dec_channels=[32, 32], dec_attention_head_dim=16,
                        dec_num_mid_blocks=1)
    cfg["vocoder"]["upsample_initial_channel"] = 128
    tr = dict(cell["traffic"], chars={"min": 10, "max": 40, "mean": 25, "sd": 8})
    if tr["kind"] == "serve":
        tr.update(rate_rps=4.0, warmup="64:256,96:384", check_answers=4, warm_requests=2, warm_seconds=1.0)
    else:
        tr.update(utterances=8, batch_size=4, check_answers=4)
    tr.update(traffic)
    return dict(cell, config=cfg, traffic=tr, limits=dict(cell["limits"], min_checked=2))


@pytest.fixture
def cpu_run():
    """Run a tiny cell on the CPU through everything but the look for a
    card: (correct, checks, run)."""
    import time

    import torch

    from benchmark.harness.execute import execute

    def go(cell, seed=2**31 + 77, seconds=3.0):
        torch.set_num_threads(2)
        rc, line, run = execute(cell, seed, seconds, False, torch.device("cpu"),
                                time.perf_counter())
        assert rc == 0
        return json.loads(line)["correct"], run["checks"], run

    return go
