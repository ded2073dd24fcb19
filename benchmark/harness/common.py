"""Shared pieces of the harness: the spec, a cell's files, seeds, the
device's description and the result line.

A cell is found by its name in ``BENCHMARK.json``: its configuration in
``benchmark/configs/<config>.json`` (whose vocoder is built by
``benchmark/harness/vocoders/<vocoder_arch>.py``), its traffic mix in
``benchmark/traffic/<traffic>.json``, the limits of its correctness check
in ``benchmark/limits/<workload>.json`` and each metric's reader in
``benchmark/metrics/<metric>.py``. A later cell or metric is added by
adding such files and entries.
"""

import importlib.util
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
#: top-level module names that must not be loaded in a run: JAX and the
#: JAX package (compared whole: the system under test's name begins with
#: the JAX package's)
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "matcha_tpu")


def load_spec(root: Path = ROOT) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def resolve_cell(spec: dict, name: str) -> dict:
    """The workload ``name`` with its configuration, traffic and limits
    read from their files, and the metrics it reports at each trace
    level: ``{"workload", "config", "traffic", "limits", "end_to_end",
    "per_layer"}``."""
    cells = {w["name"]: w for w in spec["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json (have {sorted(cells)})")
    w = cells[name]
    cfg = next(c for c in spec["configs"] if c["name"] == w["config"])

    def reports(m):
        return name in m["workloads"] if "workloads" in m else True

    e2e = [m for m in spec["end_to_end"] if reports(m)]
    names = {m["name"] for m in e2e}
    per_layer = [m for m in spec["per_layer"]
                 if (name in m["workloads"] if "workloads" in m else m["moves"] in names)]
    return {"workload": w,
            "config": load_json(ROOT / cfg["file"]),
            "traffic": load_json(BENCH / "traffic" / f"{w['traffic']}.json"),
            "limits": load_json(BENCH / "limits" / f"{name}.json"),
            "end_to_end": e2e, "per_layer": per_layer}


def metric_reader(name: str):
    """``read(run) -> number | None`` of ``benchmark/metrics/<name>.py``."""
    path = BENCH / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"benchmark_metric_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def derive_seed(seed: int, *tags) -> int:
    """A 63-bit seed for one use of the run's ``--seed`` (weights, traffic,
    noise, sample), so that the uses draw independent streams."""
    words = [int(seed) & 0xFFFFFFFF, (int(seed) >> 32) & 0xFFFFFFFF]
    words += [int.from_bytes(str(t).encode(), "little") % (1 << 32) for t in tags]
    return int(np.random.SeedSequence(words).generate_state(1, np.uint64)[0] >> 1)


def forbidden_loaded(modules=None) -> list:
    """The forbidden top-level module names that ``sys.modules`` holds."""
    tops = {k.split(".", 1)[0] for k in (sys.modules if modules is None else modules)}
    return sorted(tops & set(FORBIDDEN_MODULES))


def power_limit_w() -> str:
    """The card's power limit as ``nvidia-smi`` reads it ("not measured"
    when it cannot)."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                              "--format=csv,noheader,nounits"],
                             capture_output=True, text=True, timeout=20)
        return out.stdout.strip().splitlines()[0] if out.returncode == 0 else "not measured"
    except (OSError, subprocess.TimeoutExpired, IndexError):
        return "not measured"


def set_cache_dirs() -> None:
    """Point every kernel and build cache a run could use at fixed
    directories inside the checkout (the port builds its own kernels under
    ``build/`` of the checkout already)."""
    cache = ROOT / "build" / "benchmark_cache"
    for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TORCHINDUCTOR_CACHE_DIR", "inductor"), ("CUDA_CACHE_PATH", "cuda")):
        os.environ[var] = str(cache / sub)
    # no library the port uses may pull JAX in through its own imports
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


def percentile(values, q: float) -> float:
    """The ``q``-th percentile (0-100) of ``values`` by linear
    interpolation between closest ranks (numpy's default), with ``inf``
    kept as the largest value: a failed request counts as infinitely
    late."""
    v = np.sort(np.asarray(values, dtype=np.float64))
    if v.size == 0:
        return float("nan")
    pos = (v.size - 1) * q / 100.0
    lo, hi = int(np.floor(pos)), int(np.ceil(pos))
    if lo == hi or v[lo] == v[hi]:
        return float(v[lo])
    if np.isinf(v[hi]):
        return float("inf")
    return float(v[lo] + (v[hi] - v[lo]) * (pos - lo))


def print_checks(checks: list) -> None:
    """Each compared number beside its limit, as the last lines on
    standard error."""
    for c in checks:
        print(f"check {c['name']}: {c['value']!r} (limit {c['limit']!r}, {c['rule']})",
              file=sys.stderr, flush=True)


def result_line(correct: bool, attempted: int, failed: int, metrics: dict, device: dict,
                checks: list, breakdown=None) -> str:
    """The run's last line: the contract's keys, ``breakdown`` on a traced
    run, and the compared numbers with their limits under ``checks``,
    last."""
    out = {"correct": bool(correct), "attempted": int(attempted), "failed": int(failed),
           "metrics": metrics, "device": device}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["checks"] = {c["name"]: {"value": c["value"], "limit": c["limit"]} for c in checks}
    return json.dumps(out)
