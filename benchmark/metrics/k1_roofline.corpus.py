"""k1_roofline.corpus: K1's (``mrf_stage_kernel``) share of its roofline
over the traced window: the least time its launches could take, from
the work at the true frames (``flops.k1_least_s``), over their device
time in the trace, in %. Each batch launches K1 once per fused stage; a
trace that holds another number of K1 events than that gives no
reading."""

from benchmark.harness import flops


def read(run):
    t = run.get("trace")
    if run["kind"] != "corpus" or not t:
        return None
    k1 = [(s_, e) for name, s_, e in t["events"] if "mrf_stage_kernel" in name]
    stages = flops.k1_stages(run["config"]["vocoder"])
    if not k1 or len(k1) != len(stages) * len(run["batches"]):
        return None
    least = sum(flops.k1_least_s(C, up * int(b["mel_lengths"].sum()))
                for b in run["batches"] for C, up in stages)
    return 100.0 * least / (sum(e - s_ for s_, e in k1) / 1e6)
