"""serve.fast_path_share: the share of the window's requests that the
daemon served by one replay of a warmed graph (the change in
``BatchingServer.n_fast`` over that in ``n_requests``), in %."""


def read(run):
    if run["kind"] != "serve":
        return None
    a, b = run["counters_after"], run["counters_before"]
    n = a["n_requests"] - b["n_requests"]
    return 100.0 * (a["n_fast"] - b["n_fast"]) / n if n else None
