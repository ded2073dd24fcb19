"""BENCHMARK.json against the contract's shape, and every cell resolving
from its files."""

import json
import re

import pytest

from benchmark.harness import common

SPEC = common.load_spec()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
TEXT = re.compile(r"^[^\t\n]{1,200}$")


def test_top_level_keys():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    assert SPEC["paths"] == ["benchmark"]
    assert SPEC["command"] == ["python3", "benchmark/run.py"]
    assert 1 <= SPEC["run_seconds"] <= 51 and isinstance(SPEC["run_seconds"], int)
    assert len(json.dumps(SPEC)) < 64 * 1024


def test_names_units_and_texts():
    names = []
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for e in SPEC[group]:
            assert NAME.match(e["name"]), e["name"]
            names.append((group in ("end_to_end", "per_layer"), e["name"]))
            for key in ("why", "layer"):
                if key in e:
                    assert TEXT.match(e[key]), (e["name"], key)
            if group == "configs":
                assert TEXT.match(e["source"]) and len(e["reduced"]) <= 16
            if "unit" in e:
                assert UNIT.match(e["unit"]), e["unit"]
                assert e["better"] in ("lower", "higher")
    metrics = [n for m, n in names if m]
    assert len(metrics) == len(set(metrics))
    for group in ("configs", "workloads"):
        assert len({e["name"] for e in SPEC[group]}) == len(SPEC[group])
    for w in SPEC["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert w["chips"] in (1, 4)
        assert TEXT.match(w["why"])


def test_metric_entries():
    e2e = {m["name"]: m for m in SPEC["end_to_end"]}
    assert "setup_s" in e2e and "workloads" not in e2e["setup_s"]
    for m in SPEC["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    cells = {w["name"] for w in SPEC["workloads"]}
    for m in SPEC["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["moves"] in e2e and m["source"] in (
            "device_trace", "program_span", "program_counter", "host_clock")
        assert set(m["workloads"]) <= cells
        moved = e2e[m["moves"]]
        for w in m["workloads"]:  # each listed cell reports the metric it moves
            assert "workloads" not in moved or w in moved["workloads"]
        if m["name"].split(".")[0].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"


@pytest.mark.parametrize("name", [w["name"] for w in SPEC["workloads"]])
def test_cell_resolves(name):
    cell = common.resolve_cell(SPEC, name)
    assert cell["traffic"]["kind"] in ("serve", "corpus")
    names = {m["name"] for m in cell["end_to_end"]}
    assert "setup_s" in names and len(names) >= 2
    assert cell["per_layer"]
    for m in cell["end_to_end"] + cell["per_layer"]:
        assert callable(common.metric_reader(m["name"]))
    cfg_entry = next(c for c in SPEC["configs"] if c["name"] == cell["workload"]["config"])
    assert cfg_entry["file"].startswith("benchmark/configs/")
    assert cell["config"]["name"] == cfg_entry["name"]
    for key in ("min_checked", "dur_gap", "wav_err"):
        assert key in cell["limits"]


def test_every_config_used():
    used = {w["config"] for w in SPEC["workloads"]}
    assert used == {c["name"] for c in SPEC["configs"]}


@pytest.mark.parametrize("entry", SPEC["configs"], ids=lambda c: c["name"])
def test_every_config_names_a_vocoder_module(entry):
    from benchmark.harness import vocoders
    arch = common.load_json(common.ROOT / entry["file"])["vocoder_arch"]
    assert (common.BENCH / "harness" / "vocoders" / f"{arch}.py").is_file(), arch
    assert arch in vocoders.known()
