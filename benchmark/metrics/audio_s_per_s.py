"""audio_s_per_s: seconds of audio synthesised, counted at the true mel
lengths (frames x hop / sample rate, never the buckets' padding), over
the wall seconds from the window's start to the end of its last pass
(host clock; the window ends with a synchronise)."""


def read(run):
    if run["kind"] != "corpus":
        return None
    return run["audio_s"] / run["window_s"]
