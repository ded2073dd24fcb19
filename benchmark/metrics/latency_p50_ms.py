"""latency_p50_ms: the median latency of every request due in the
window, from the time it was due under the open-loop schedule to the
last byte of its answer; a request that failed or never came counts as
infinitely late (host clock, in the load generator)."""

from benchmark.harness.common import percentile


def read(run):
    if run["kind"] != "serve":
        return None
    return percentile(run["latency_ms"], 50)
