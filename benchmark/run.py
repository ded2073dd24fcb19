#!/usr/bin/env python3
"""Run one cell of the benchmark once.

    python benchmark/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

The cell's configuration, traffic and limits are found from its name in
``BENCHMARK.json``. ``--trace 0`` prints the cell's end-to-end metrics,
``--trace 1`` its per-layer metrics from a traced run, whose window is
``--seconds`` or 10 s, whichever is shorter. The last line of
standard output is the result; the numbers the correctness check
compared are the last lines of standard error. A machine without the
cards the cell asks for gets no result and a non-zero exit code: the
benchmark never falls back to the CPU.
"""

import argparse
import sys
import time
from pathlib import Path

T_START = time.perf_counter()
ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    from benchmark.harness import common
    common.set_cache_dirs()
    cell = common.resolve_cell(common.load_spec(), args.workload)
    import torch
    chips = int(cell["workload"]["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"no result: the cell needs {chips} CUDA device(s), this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr, flush=True)
        return 2
    from benchmark.harness.execute import execute
    rc, line, _ = execute(cell, args.seed, args.seconds, bool(args.trace),
                          torch.device("cuda"), T_START)
    if line is not None:
        print(line, flush=True)
    return rc


if __name__ == "__main__":
    sys.exit(main())
