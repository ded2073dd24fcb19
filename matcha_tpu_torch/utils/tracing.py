"""Spans of the program's own layers, on the host's clock.

``span(name, **attrs)`` is a context manager that records one span:
``Span(name, t0_ns, t1_ns, tid, sid, parent, attrs)``, its times from
``time.perf_counter_ns`` (the clock a ``torch.profiler`` trace can be tied
to with a marker kernel), the thread it ran on, its own id and its
parent's: the innermost span open on the same thread, unless one is
passed. ``record`` adds a span whose ends were taken elsewhere, such as a
request's queue wait, which no one thread lives through; such spans carry
``tid`` 0. A request's spans on other threads name the request's span as
their parent and share its id in ``attrs["req"]``.

Tracing is off by default. Off, ``span`` checks one module flag and
returns a shared no-op: no clock read and no record. On (``enable``),
spans go into a ring of ``RING_SPANS`` (a ``deque`` with a maximum
length: a daemon that runs for days keeps its last spans, not all of
them); ``spans`` reads it, ``reset`` empties it and ``write_chrome``
writes it as a Chrome trace (``chrome://tracing``, Perfetto).

Spans go around the calls into the models, in the pipeline's and the
daemon's eager Python, never inside a module's ``forward`` (what
``torch.export`` traces), and none is recorded while a CUDA graph
captures (a replay runs no host code). Names say the layer:
``serve.*``, ``pipeline.*``, ``models.*``. Counters are plain integers on
the objects that do the work (``BatchingServer.n_requests``, ...), and are
always on.
"""

import itertools
import json
import os
import threading
import time
from collections import deque
from typing import NamedTuple, Optional

#: spans the ring keeps when tracing is on: the daemon records about a
#: dozen a request, so some ten thousand requests' worth
RING_SPANS = 1 << 17


class Span(NamedTuple):
    name: str
    t0_ns: int
    t1_ns: int
    #: the thread it ran on; 0 for a span that crosses threads
    tid: int
    sid: int
    parent: Optional[int]
    attrs: dict


_on = False
_ring: deque = deque(maxlen=RING_SPANS)
_ids = itertools.count(1)
_open = threading.local()


def enable() -> None:
    global _on
    _on = True


def disable() -> None:
    global _on
    _on = False


def enabled() -> bool:
    return _on


def new_id() -> int:
    """A span id no other span of the process has."""
    return next(_ids)


def _stack() -> list:
    stack = getattr(_open, "stack", None)
    if stack is None:
        stack = _open.stack = []
    return stack


class _Span:
    __slots__ = ("name", "parent", "attrs", "sid", "t0")

    def __init__(self, name: str, parent: Optional[int], attrs: dict):
        self.name, self.parent, self.attrs = name, parent, attrs
        self.sid = next(_ids)

    def set(self, **attrs) -> None:
        """Attributes known only once the span has started."""
        self.attrs.update(attrs)

    def __enter__(self):
        stack = _stack()
        if self.parent is None and stack:
            self.parent = stack[-1]
        stack.append(self.sid)
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter_ns()
        _stack().pop()
        _ring.append(Span(self.name, self.t0, t1, threading.get_ident(), self.sid, self.parent,
                          self.attrs))
        return False


class _NoSpan:
    """What ``span`` returns while tracing is off."""

    __slots__ = ()
    sid = None

    def set(self, **attrs) -> None:
        pass

    def __bool__(self) -> bool:
        return False

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NO_SPAN = _NoSpan()


def span(name: str, parent: Optional[int] = None, **attrs):
    """``with span("pipeline.replay", B=1) as s:`` records the block as one
    span while tracing is on; ``s.set(...)`` adds attributes inside it."""
    if not _on:
        return _NO_SPAN
    return _Span(name, parent, attrs)


def record(name: str, t0_ns: int, t1_ns: int, sid: Optional[int] = None,
           parent: Optional[int] = None, tid: int = 0, **attrs) -> None:
    """Record a span whose ends were taken elsewhere (``tid`` 0: it crosses
    threads); nothing while tracing is off."""
    if _on:
        _ring.append(Span(name, int(t0_ns), int(t1_ns), tid, new_id() if sid is None else sid,
                          parent, attrs))


def ns(t: float) -> int:
    """A ``time.perf_counter()`` reading in the ring's nanoseconds."""
    return int(t * 1e9)


def spans(since_ns: int = 0) -> list:
    """The ring's spans that started at ``since_ns`` or later, oldest
    first."""
    return [s for s in _ring.copy() if s.t0_ns >= since_ns]


def reset() -> None:
    _ring.clear()


def write_chrome(path) -> int:
    """Write the ring as a Chrome trace JSON file: a complete event per
    thread span, a pair of async events per span that crosses threads (a
    request's, grouped by its id); returns the number of spans."""
    items, pid, events = spans(), os.getpid(), []
    for s in items:
        args = dict(s.attrs, id=s.sid, parent=s.parent)
        ts, dur = s.t0_ns / 1e3, (s.t1_ns - s.t0_ns) / 1e3
        if s.tid:
            events.append({"name": s.name, "ph": "X", "ts": ts, "dur": dur, "pid": pid,
                           "tid": s.tid, "args": args})
        else:
            key = {"cat": "request", "id": s.attrs.get("req", s.sid), "pid": pid, "tid": 0}
            events.append(dict(key, name=s.name, ph="b", ts=ts, args=args))
            events.append(dict(key, name=s.name, ph="e", ts=ts + dur))
    with open(path, "w") as f:
        json.dump({"traceEvents": events, "displayTimeUnit": "ms"}, f)
    return len(items)
