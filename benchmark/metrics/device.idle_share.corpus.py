"""device.idle_share.corpus: the share of the traced window in which no
kernel or copy ran on the card, 1 - (union of the device intervals under
torch.profiler) / (window), in %."""


def read(run):
    t = run.get("trace")
    if run["kind"] != "corpus" or not t or t["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
