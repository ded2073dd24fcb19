"""mfu.corpus: the model FLOPs of every utterance the traced window
synthesised, at its true lengths (encoder, the U-Net once per Euler
step, the vocoder; ``flops.ModelFlops``), over the window's seconds times
the card's TF32 peak, in %."""

from benchmark.harness import flops


def read(run):
    t = run.get("trace")
    if run["kind"] != "corpus" or not t:
        return None
    mf = flops.ModelFlops(run["config"])
    total = sum(mf.utterance(int(nx), int(ny)) for b in run["batches"]
                for nx, ny in zip(b["x_lengths"], b["mel_lengths"]))
    return 100.0 * total / (t["window_s"] * flops.PEAK_TF32_FLOPS)
