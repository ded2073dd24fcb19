"""The traced run's reading of a ``torch.profiler`` trace of the card: the
device's busy time (the union of its kernel and copy intervals, a frozen
copy of the arithmetic of ``chip_smoke.py::device_busy``), kernel time by
name, and the idle gaps named by what the host was doing.

Only device activity is traced (CUPTI): the host's own operations are
not recorded, so the host-bound paths run at their untraced pace. What
the host was doing comes from the harness's spans (``Spans``), taken on
the host's clock around the calls into the system's layers. The trace's
timestamps are wall-clock nanoseconds; ``mark_start`` ties them to the
host's ``time.perf_counter``.

A trace stays open ``TRACE_SETTLE_S`` after its last synchronise: the
profiler gets the records of a CUDA graph's kernels some time after the
replay ends, and a trace closed at once can lose the last replay's
kernels (``matcha_tpu_torch/scripts/trace_settle.py`` measured it).
"""

import threading
import time

import torch

TRACE_SETTLE_S = 1.0


class Spans:
    """Harness spans on the host's clock: (name, start, end) in
    ``time.perf_counter`` seconds, from any thread. Off (recording
    nothing) unless ``on``."""

    def __init__(self, on: bool):
        self.on = on
        self.items = []
        self._lock = threading.Lock()

    def span(self, name: str):
        return _Span(self, name)

    def add(self, name: str, t0: float, t1: float) -> None:
        with self._lock:
            self.items.append((name, t0, t1))


class _Span:
    def __init__(self, spans: Spans, name: str):
        self.spans, self.name = spans, name

    def __enter__(self):
        self.t0 = time.perf_counter() if self.spans.on else 0.0
        return self

    def __exit__(self, *exc):
        if self.spans.on:
            self.spans.add(self.name, self.t0, time.perf_counter())
        return False


class Trace:
    """A profiler of the card's activity over the measured window:
    ``mark_start`` and ``mark_end`` give the window's host times; after the
    ``with`` block, ``device_events`` reads the kernels and copies as
    (name, start_us, end_us) from the window's start, clipped to it."""

    def __init__(self):
        from torch.profiler import ProfilerActivity, profile
        on_card = torch.cuda.is_available()
        self.prof = profile(activities=[ProfilerActivity.CUDA if on_card else ProfilerActivity.CPU])
        self.t_start = self.t_end = None

    def __enter__(self):
        self.prof.__enter__()
        return self

    def mark_start(self, t: float) -> None:
        """The window starts at host time ``t`` (``time.perf_counter``).
        On a card, a marker kernel (``torch.cuda._sleep``'s spin kernel)
        launched on an idle device ties the trace's clock to the host's;
        else the wall clock does."""
        self.wall_minus_perf_ns = time.time_ns() - time.perf_counter() * 1e9
        self.t_mark = None
        if torch.cuda.is_available():
            torch.cuda.synchronize()
            self.t_mark = time.perf_counter()
            torch.cuda._sleep(100)
        self.t_start = t

    def mark_end(self, t: float) -> None:
        self.t_end = t

    def __exit__(self, *exc):
        if exc[0] is None:
            if torch.cuda.is_available():
                torch.cuda.synchronize()
            time.sleep(TRACE_SETTLE_S)
        self.prof.__exit__(*exc)
        return False

    def window_us(self) -> float:
        return (self.t_end - self.t_start) * 1e6

    def to_window_us(self, t: float) -> float:
        """A host ``perf_counter`` time in µs from the window's start."""
        return (t - self.t_start) * 1e6

    def device_events(self) -> list:
        events = [e for e in self.prof.profiler.kineto_results.events()
                  if e.device_type() == torch.autograd.DeviceType.CUDA
                  and not e.is_user_annotation()]
        marks = [e for e in events if "spin_kernel" in e.name()]
        if self.t_mark is not None and marks:
            offset_ns = min(e.start_ns() for e in marks) - self.t_mark * 1e9
            events = [e for e in events if "spin_kernel" not in e.name()]
        else:
            offset_ns = self.wall_minus_perf_ns
        start_ns = self.t_start * 1e9 + offset_ns
        end = self.window_us()
        out = []
        for e in events:
            s = (e.start_ns() - start_ns) / 1e3
            t = s + e.duration_ns() / 1e3
            if t <= 0 or s >= end:
                continue
            out.append((e.name(), max(s, 0.0), min(t, end)))
        return out


def busy_us(dev_events) -> float:
    """The union of the device intervals."""
    total, end = 0.0, float("-inf")
    for _, s, t in sorted(dev_events, key=lambda e: e[1]):
        total += max(0.0, t - max(s, end))
        end = max(end, t)
    return total


def idle_gaps(dev_events, window_us: float) -> list:
    """The intervals of the window in which no device event ran."""
    gaps, end = [], 0.0
    for _, s, t in sorted(dev_events, key=lambda e: e[1]):
        if s > end:
            gaps.append((end, s))
        end = max(end, t)
    if window_us > end:
        gaps.append((end, window_us))
    return gaps


def breakdown(dev_events, spans, window_us: float, top: int = 10) -> dict:
    """The device operations that took most time, and the idle gaps
    summed by the innermost harness span ((name, start_us, end_us) from
    the window's start) open at each gap's middle ("host: no span open"
    outside them), in seconds."""
    by_name = {}
    for name, s, t in dev_events:
        by_name[name[:80]] = by_name.get(name[:80], 0.0) + (t - s) / 1e6
    spans = sorted(spans, key=lambda h: h[1])
    gap_by, active, k = {}, [], 0
    for a, b in idle_gaps(dev_events, window_us):
        mid = (a + b) / 2
        while k < len(spans) and spans[k][1] <= mid:
            active.append(spans[k])
            k += 1
        active = [h for h in active if h[2] >= mid]
        name = min(active, key=lambda h: h[2] - h[1])[0][:80] if active else "host: no span open"
        gap_by[name] = gap_by.get(name, 0.0) + (b - a) / 1e6
    order = lambda d: sorted(([k, v] for k, v in d.items()), key=lambda kv: -kv[1])[:top]
    return {"device_ops": order(by_name), "idle_gaps": order(gap_by)}


def read(tracer: Trace, spans: Spans) -> dict:
    """busy_s, window_s, the breakdown and the device events of a closed
    trace."""
    dev = tracer.device_events()
    win = tracer.window_us()
    host = [(n, tracer.to_window_us(a), tracer.to_window_us(b)) for n, a, b in spans.items]
    return {"busy_s": busy_us(dev) / 1e6, "window_s": win / 1e6,
            "breakdown": breakdown(dev, host, win), "events": dev}
