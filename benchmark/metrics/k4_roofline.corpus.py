"""k4_roofline.corpus: K4's (``aa_snake_kernel``, BigVGAN's anti-aliased
SnakeBeta) share of its roofline over the traced window: the least time
its launches could take, from the work at each batch's true frames (the
vocoder adapter's ``k4_least_s``: max(FLOPs / 67 TFLOP/s f32, bytes /
3.35 TB/s)), over their device time in the trace, in %. Each batch's
vocoder call launches K4 ``k4_launches`` times; a trace that holds another
number of K4 events than that gives no reading, and so does a
configuration whose vocoder has no K4."""


def read(run):
    t = run.get("trace")
    if run["kind"] != "corpus" or not t:
        return None
    from benchmark.harness.vocoders import adapter
    arch, voc = adapter(run["config"]), run["config"]["vocoder"]
    if not hasattr(arch, "k4_launches"):
        return None
    k4 = [(s_, e) for name, s_, e in t["events"] if "aa_snake_kernel" in name]
    if not k4 or len(k4) != arch.k4_launches(voc) * len(run["batches"]):
        return None
    least = sum(arch.k4_least_s(voc, int(b["mel_lengths"].sum())) for b in run["batches"])
    return 100.0 * least / (sum(e - s_ for s_, e in k4) / 1e6)
