#!/usr/bin/env python3
"""Readings for the limits of a cell's correctness check: the system's
numbers over many seeds, and the control's beside them.

    python benchmark/control.py --workload <name> --seconds 10 --seeds 101 102 ... \\
        [--out control.jsonl]

Each seed is one whole run of the cell (set-up, a window at the cell's
own load, the check), in one process, with the control computed beside
the check: the reference with its decoder and vocoder in bfloat16, put
in the system's place. One JSON line per seed: the system's numbers
and the control's, each the worst over the sampled answers.
The benchmark's own runs never run the control.
"""

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seconds", type=float, default=10.0)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)

    from benchmark.harness import common
    common.set_cache_dirs()
    import torch

    from benchmark.harness.execute import execute
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    cell = common.resolve_cell(common.load_spec(), args.workload)
    for seed in args.seeds:
        t0 = time.perf_counter()
        rc, line, run = execute(cell, seed, args.seconds, False, torch.device("cuda"), t0,
                                control=True)
        res = run["results"]

        def worst(k):
            v = [r[k] for r in res if r.get(k) is not None]
            return max(v) if v else None

        out = {"workload": args.workload, "seed": seed, "correct": json.loads(line)["correct"],
               "metrics": json.loads(line)["metrics"],
               "system": {k: worst(k) for k in ("dur_gap", "wav_err", "mel_err")},
               "control": {k: worst(k) for k in ("dur_gap_control", "wav_err_control",
                                                  "mel_err_control")},
               "length_scale": run["config"]["synthesis"]["length_scale"],
               "checked": len(res), "seconds": time.perf_counter() - t0}
        print(json.dumps(out), flush=True)
        if args.out:
            Path(args.out).parent.mkdir(parents=True, exist_ok=True)
            with open(args.out, "a") as f:
                f.write(json.dumps(out) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
