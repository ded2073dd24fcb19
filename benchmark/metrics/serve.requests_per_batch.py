"""serve.requests_per_batch: the daemon's requests over its batches in
the window (the change in ``BatchingServer.n_requests`` over that in
``n_batches``; a fast-path request is a batch of one)."""


def read(run):
    if run["kind"] != "serve":
        return None
    a, b = run["counters_after"], run["counters_before"]
    batches = a["n_batches"] - b["n_batches"]
    return (a["n_requests"] - b["n_requests"]) / batches if batches else None
