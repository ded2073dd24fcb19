"""One run of one cell: set-up, the measured window, the check against
the reference, and the result line.

The kind of a cell's traffic (``"kind"`` in its traffic file) names the
module that runs it; the metrics are read by the readers that
``BENCHMARK.json`` lists for the cell.
"""

import gc
import sys
import time

import torch

from benchmark.harness import common
from benchmark.harness.corpus import CorpusCell
from benchmark.harness.serve import ServeCell

KINDS = {"serve": ServeCell, "corpus": CorpusCell}
#: the traced run measures a window of at most this many seconds, so that
#: reading its trace keeps the run short
TRACE_WINDOW_S = 10.0


def execute(cell: dict, seed: int, seconds: float, traced: bool, device, t_start: float,
            control: bool = False) -> tuple:
    """(exit code, the result dict or None, the checks). ``control``: the
    reference's bf16 control is computed beside the check, and its numbers
    printed (the control runs, never the benchmark's own)."""
    from benchmark.harness.models import with_speaking_rate

    kind = cell["traffic"]["kind"]
    cfg = with_speaking_rate(cell["config"], cell["traffic"], seed, device)
    cell = dict(cell, config=cfg)
    if device.type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)
    sut = KINDS[kind](cell, seed, device, traced)
    setup_s = time.perf_counter() - t_start
    run = sut.window(min(seconds, TRACE_WINDOW_S) if traced else seconds)
    run["setup_s"] = setup_s
    run["config"] = cfg
    memory_peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0

    # the check, once the window has closed and the system's state is freed
    rows = sut.answers()
    if kind == "serve":
        from benchmark.harness.judge import reference_ids
        sut.attach_calls(rows, lambda text: reference_ids(text, cfg["cleaner"]))
    sut.close()
    del sut
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    from benchmark.harness.judge import Reference, summarise
    ref = Reference(cfg, seed, device, control=control)
    results = []
    for r in rows:
        if r.get("noise") is None:
            results.append({"ids_mismatch": 1, "len_mismatch": 0, "dur_gap": float("inf"),
                            "wav_err": float("inf"), "mel_err": None})
            continue
        results.append(ref.check(r))
    correct, checks = summarise(results, cell["limits"], run["answered"], run["due"])
    if control:
        for key in ("dur_gap_control", "wav_err_control", "mel_err_control"):
            vals = [r[key] for r in results if r.get(key) is not None]
            print(f"control {key}: {max(vals) if vals else None!r} (the worst of "
                  f"{len(vals)} answers, as the system's number is read)",
                  file=sys.stderr, flush=True)
    run["checks"] = checks
    run["results"] = results

    names = cell["per_layer"] if traced else cell["end_to_end"]
    metrics = {}
    for m in names:
        value = common.metric_reader(m["name"])(run)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
           "count": int(cell["workload"]["chips"]), "memory_peak_bytes": int(memory_peak),
           "power_limit_w": common.power_limit_w() if device.type == "cuda" else "not measured"}
    breakdown = None
    if traced:
        dev["busy_s"] = run["trace"]["busy_s"]
        dev["window_s"] = run["trace"]["window_s"]
        breakdown = run["trace"]["breakdown"]
    failed = run["due"] - run["answered"]
    # last, once the check and the metric readers have loaded what they load
    found = common.forbidden_loaded()
    if found:
        print(f"forbidden modules loaded in the run: {found}", file=sys.stderr, flush=True)
        return 3, None, run
    common.print_checks(checks)
    line = common.result_line(correct, run["due"], failed, metrics, dev, checks, breakdown)
    return 0, line, run
