"""The open-loop load generator: a process of its own that sends POST
``/synthesise`` requests on a fixed schedule, whatever the server's
state, so that the clients never hold the server's interpreter lock and
a slow server gets the same load.

Each request is timed from when it was due to the last byte of its
response; how late the generator sent it is kept beside. The protocol
over the pipe: the parent sends ``("go", schedule)``; the child answers
``("t0", t0)`` at once, sends every request at ``t0 + due``, and when all
have answered (or ``grace_s`` past the last due time) sends
``("done", summary)``. The parent then sends ``("wavs", indices)`` and
gets back ``{index: wav bytes}``. Only the standard library and numpy
are loaded here.
"""

import http.client
import json
import time
from concurrent.futures import ThreadPoolExecutor
from concurrent.futures import TimeoutError as FutureTimeout


def _post(port: int, body: bytes, timeout_s: float):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout_s)
    try:
        conn.request("POST", "/synthesise", body=body,
                     headers={"Content-Type": "application/json"})
        resp = conn.getresponse()
        data = resp.read()
        return resp.status, data
    finally:
        conn.close()


def serve_schedule(conn, port: int, grace_s: float = 60.0, max_workers: int = 32) -> None:
    """Run one schedule for the parent at the other end of ``conn``. At
    most ``max_workers`` requests are open at once (threads are started
    only as requests overlap); one that finds them all busy is sent
    late, and its lateness says so."""
    msg, schedule = conn.recv()
    if msg != "go":
        raise RuntimeError(f"expected go, got {msg!r}")
    n = len(schedule)
    status = [None] * n
    latency = [float("inf")] * n
    lateness = [None] * n
    wavs = [b""] * n
    t0 = time.perf_counter() + 0.05
    conn.send(("t0", t0))
    last_due = max((d for d, _ in schedule), default=0.0)
    deadline = t0 + last_due + grace_s

    def send(i, due, body):
        start = time.perf_counter()
        lateness[i] = start - (t0 + due)
        try:
            code, data = _post(port, body, max(1.0, deadline - start))
        except OSError:
            return
        done = time.perf_counter()
        status[i] = code
        if code == 200:
            latency[i] = done - (t0 + due)
            wavs[i] = data

    pool = ThreadPoolExecutor(max_workers=max_workers)
    futures = []
    for i, (due, payload) in enumerate(schedule):
        body = json.dumps(payload).encode()
        wait = t0 + due - time.perf_counter()
        if wait > 0:
            time.sleep(wait)
        futures.append(pool.submit(send, i, due, body))
    for f in futures:
        try:  # an answer that never comes stays unanswered (infinitely late)
            f.result(timeout=max(0.0, deadline - time.perf_counter()) + 5.0)
        except FutureTimeout:
            pass
    pool.shutdown(wait=True)
    t_end = max((t0 + d + latency[i] for i, (d, _) in enumerate(schedule)
                 if latency[i] != float("inf")), default=t0)
    conn.send(("done", {"status": status, "latency_s": latency, "lateness_s": lateness,
                        "wav_bytes": [len(w) for w in wavs], "t0": t0, "t_end": t_end}))
    msg, idx = conn.recv()
    if msg != "wavs":
        raise RuntimeError(f"expected wavs, got {msg!r}")
    conn.send({i: wavs[i] for i in idx})


def child_main(conn, port: int, grace_s: float) -> None:
    """The spawned process's entry."""
    try:
        serve_schedule(conn, port, grace_s)
    finally:
        conn.close()

