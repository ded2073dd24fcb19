"""The command's behaviour at its edges: no result without a card, and
(on a card) one short run of a cell with the contract's last line."""

import json
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]


def _run(*args, timeout=1500):
    return subprocess.run([sys.executable, "benchmark/run.py", *args], cwd=ROOT,
                          capture_output=True, text=True, timeout=timeout)


def test_no_result_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    out = _run("--workload", "ljspeech.corpus", "--seed", str(2**31 + 3), "--seconds", "1",
               "--trace", "0")
    assert out.returncode != 0
    assert out.stdout.strip() == ""


def test_unknown_workload_fails():
    out = _run("--workload", "no-such-cell", "--seed", "1", "--seconds", "1", "--trace", "0")
    assert out.returncode != 0 and out.stdout.strip() == ""


@pytest.mark.cuda
def test_a_cell_runs_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    out = _run("--workload", "vctk.serve-speakers", "--seed", str(2**31 + 99), "--seconds", "3",
               "--trace", "0")
    assert out.returncode == 0, out.stderr[-3000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(line)[-1] == "checks"
    assert line["device"]["platform"] == "gpu" and line["device"]["count"] == 1
    assert {"setup_s", "latency_p50_ms"} <= set(line["metrics"])
