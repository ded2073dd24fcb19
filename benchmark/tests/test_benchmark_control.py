"""The control fails the check: the reference in bfloat16 put in the
system's place (``execute(control=True)``), read as the system's answers
are read, against the cell's own limits. A tiny cell on the CPU; on the
card, ``benchmark/control.py`` reads the same at the cell's own size."""

import pytest

from benchmark.harness.judge import summarise
from conftest import tiny_cell


@pytest.mark.parametrize("name", ["vctk.serve-speakers", "ljspeech.corpus"])
def test_control_is_not_correct(name, cpu_run):
    import time

    import torch

    from benchmark.harness.execute import execute

    cell = tiny_cell(name)
    torch.set_num_threads(2)
    rc, _, run = execute(cell, 2**31 + 91, 3.0, False, torch.device("cpu"), time.perf_counter(),
                         control=True)
    assert rc == 0
    res = run["results"]
    system_ok, _ = summarise(res, cell["limits"], run["answered"], run["due"])
    assert system_ok
    as_control = [dict(r, dur_gap=r["dur_gap_control"], wav_err=r["wav_err_control"],
                       mel_err=r["mel_err_control"]) for r in res]
    control_ok, checks = summarise(as_control, cell["limits"], run["answered"], run["due"])
    assert not control_ok, checks
    by = {c["name"]: c for c in checks}
    assert by["mel_err"]["value"] > cell["limits"]["mel_err"]
