#!/usr/bin/env python3
"""Find the highest arrival rate a serve cell's daemon sustains.

    python benchmark/sweep_rate.py --workload <serve cell> --seed <n> --seconds 15 \\
        --rates 8 12 16 20 [--out sweep.json]

One set-up, then one open-loop window per rate (the cell's traffic with
its ``rate_rps`` replaced), in the order given. A rate is sustained when
every request is answered and the median latency of the window's last
third of requests is at most 1.5 times that of its first third (a
growing backlog makes later requests wait longer). Prints a markdown
table and the highest sustained rate; the cell's traffic file takes 0.8
of it.
"""

import argparse
import json
import sys
import time
from pathlib import Path

T_START = time.perf_counter()
ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, default=15.0)
    p.add_argument("--rates", type=float, nargs="+", required=True)
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)

    from benchmark.harness import common
    common.set_cache_dirs()
    import numpy as np
    import torch

    from benchmark.harness.models import with_speaking_rate
    from benchmark.harness.serve import ServeCell
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    device = torch.device("cuda")
    cell = common.resolve_cell(common.load_spec(), args.workload)
    cell = dict(cell, config=with_speaking_rate(cell["config"], cell["traffic"], args.seed, device))
    sut = ServeCell(cell, args.seed, device, traced=False)
    print(f"set-up {time.perf_counter() - T_START:.1f} s, length_scale "
          f"{cell['config']['synthesis']['length_scale']}", flush=True)
    rows = []
    for rate in args.rates:
        sut.cell = dict(sut.cell, traffic=dict(cell["traffic"], rate_rps=rate))
        run = sut.window(args.seconds)
        sut.release()
        lat = np.asarray(run["latency_ms"])
        third = max(1, len(lat) // 3)
        first, last = np.median(lat[:third]), np.median(lat[-third:])
        a, b = run["counters_after"], run["counters_before"]
        nb = a["n_batches"] - b["n_batches"]
        row = {"rate_rps": rate, "due": run["due"], "answered": run["answered"],
               "p50_ms": common.percentile(lat, 50), "p95_ms": common.percentile(lat, 95),
               "first_third_p50_ms": float(first), "last_third_p50_ms": float(last),
               "req_per_batch": (a["n_requests"] - b["n_requests"]) / nb if nb else None,
               "fast_share": (a["n_fast"] - b["n_fast"]) / max(1, a["n_requests"] - b["n_requests"]),
               "sustained": bool(run["answered"] == run["due"] and last <= 1.5 * first)}
        rows.append(row)
        print(json.dumps(row), flush=True)
    sut.close()
    best = max((r["rate_rps"] for r in rows if r["sustained"]), default=None)
    print("| rate (req/s) | due | answered | p50 ms | p95 ms | first / last third p50 ms | "
          "req/batch | fast path | sustained |")
    print("| --- | --- | --- | --- | --- | --- | --- | --- | --- |")
    for r in rows:
        print(f"| {r['rate_rps']} | {r['due']} | {r['answered']} | {r['p50_ms']:.1f} | "
              f"{r['p95_ms']:.1f} | {r['first_third_p50_ms']:.1f} / {r['last_third_p50_ms']:.1f} | "
              f"{r['req_per_batch'] or 0:.2f} | {100 * r['fast_share']:.1f}% | {r['sustained']} |")
    print(f"highest sustained rate: {best} req/s on {torch.cuda.get_device_name(device)}, "
          f"power limit {common.power_limit_w()} W")
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps({"workload": args.workload, "rows": rows,
                                              "highest_sustained_rps": best}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
