"""K2's time, split: ``ops/mas.py::maximum_path`` at the training step's
shape, the whole call with CUDA events, then the same calls under
``torch.profiler``, split into the MAS kernel's device time and the sum of
the wrapper's other device operations (the mask multiply, the length
sums, the zeroed path, the final mask and cast). Log-prior values and
ragged lengths come from a seed; the path is checked EQUAL to the plain
version.

Usage: python -m matcha_tpu_torch.scripts.profile_mas [--shape 32,288,832 ...] [--reps 20]

One JSON line per shape; several shapes at one T_y and growing T_x show
how the kernel's time grows with the cells each lane carries.

The script imports only ``matcha_tpu_torch.ops.mas``, so it also times
another checkout's kernel (for an A/B in one run) when run as a file with
that checkout first on the path:
    PYTHONPATH=<other checkout> python3 matcha_tpu_torch/scripts/profile_mas.py
"""

import argparse
import json
import subprocess

import torch

SEED = 1234
KERNEL = "mas_kernel"


def mas_inputs(B: int, T_x: int, T_y: int, device, seed: int = SEED):
    """(value, mask, t_xs, t_ys): values normal x 3; lengths drawn in the
    top quarter of (T_x, T_y), the first row full, as a bucketed batch."""
    g = torch.Generator().manual_seed(seed)
    t_xs = torch.randint(T_x * 3 // 4, T_x + 1, (B,), generator=g)
    t_ys = torch.randint(T_y * 3 // 4, T_y + 1, (B,), generator=g)
    t_xs[0], t_ys[0] = T_x, T_y
    value = torch.randn(B, T_x, T_y, generator=g) * 3
    mask = ((torch.arange(T_x)[None, :, None] < t_xs[:, None, None])
            & (torch.arange(T_y)[None, None, :] < t_ys[:, None, None])).float()
    return value.to(device), mask.to(device), t_xs.tolist(), t_ys.tolist()


def mas_split(fn, reps: int) -> dict:
    """``fn()`` (one maximum_path call) timed with CUDA events over
    ``reps`` calls (``ms``), then ``reps`` more under torch.profiler:
    per call, the device time of the kernels named like K2
    (``kernel_ms``) and of every other device operation (``wrapper_ms``).
    Raises when the trace holds no K2 kernel."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / reps
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    kernel_us = wrapper_us = 0.0
    n_ops, names = 0, set()
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        n_ops += 1
        us = e.time_range.end - e.time_range.start
        if KERNEL in e.name:
            kernel_us += us
            names.add(e.name[:80])
        else:
            wrapper_us += us
    if not names:
        raise AssertionError(f"no {KERNEL} in the trace ({n_ops} device operations)")
    return {"ms": ms, "kernel_ms": kernel_us / 1e3 / reps, "wrapper_ms": wrapper_us / 1e3 / reps,
            "device_ops_per_call": n_ops / reps, "kernel_names": sorted(names),
            "note": f"ms: CUDA events, mean of {reps} calls; kernel_ms, wrapper_ms: "
                    f"torch.profiler device time per call over {reps} more"}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--shape", action="append", help="B,T_x,T_y (repeatable; 32,288,832)")
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_mas: no CUDA device")
    from matcha_tpu_torch.ops import mas

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    for shape in args.shape or ["32,288,832"]:
        B, T_x, T_y = (int(v) for v in shape.split(","))
        value, mask, t_xs, t_ys = mas_inputs(B, T_x, T_y, "cuda")
        split = mas_split(lambda: mas.maximum_path(value, mask), args.reps)
        equal = torch.equal(mas.maximum_path(value, mask),
                            mas.maximum_path_reference(value, mask))
        layout = mas.mas_layout(T_x, T_y) if hasattr(mas, "mas_layout") else None
        print(json.dumps({"script": "profile_mas", "nvidia_smi": smi, "mas_module": mas.__file__,
                          "B": B, "T_x": T_x, "T_y": T_y, "max_t_x": max(t_xs),
                          "max_t_y": max(t_ys), "layout": layout, "equal": equal, **split}),
              flush=True)
        if not equal:
            raise SystemExit(f"profile_mas: the kernel's path differs from the plain version at "
                             f"{shape}")


if __name__ == "__main__":
    main()
