"""The harness's arithmetic: percentiles with failures, the window rates,
the counters' ratios, the idle share, K1's and the model's FLOPs against
``torch.utils.flop_counter`` on the reference, and the reading of the
system's durations."""

import math

import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from benchmark.harness import common, flops, trace
from benchmark.harness.judge import read_durations


def test_percentile_counts_failures_as_infinitely_late():
    assert common.percentile([1, 2, 3, 4], 50) == pytest.approx(np.percentile([1, 2, 3, 4], 50))
    assert common.percentile(list(range(1, 101)), 95) == pytest.approx(
        np.percentile(np.arange(1, 101), 95))
    lat = [10.0] * 94 + [float("inf")] * 6
    assert common.percentile(lat, 95) == math.inf
    assert common.percentile(lat, 50) == 10.0
    assert common.percentile([10.0] * 99 + [float("inf")], 95) == 10.0


def _reader(name):
    return common.metric_reader(name)


def test_window_metrics():
    serve = {"kind": "serve", "latency_ms": [100.0, 200.0, 300.0, float("inf")],
             "counters_before": {"n_requests": 10, "n_batches": 5, "n_fast": 2},
             "counters_after": {"n_requests": 40, "n_batches": 15, "n_fast": 8},
             "setup_s": 12.5, "trace": {"busy_s": 3.0, "window_s": 12.0}}
    assert _reader("latency_p50_ms")(serve) == pytest.approx(250.0)
    assert common.percentile(serve["latency_ms"], 95) == math.inf  # a failure: infinitely late
    assert _reader("serve.requests_per_batch")(serve) == pytest.approx(3.0)
    assert _reader("serve.fast_path_share")(serve) == pytest.approx(20.0)
    assert _reader("device.idle_share.serve")(serve) == pytest.approx(75.0)
    assert _reader("device.idle_share.corpus")(serve) is None
    assert _reader("audio_s_per_s")(serve) is None
    assert _reader("setup_s")(serve) == 12.5
    corpus = {"kind": "corpus", "audio_s": 1200.0, "window_s": 3.0,
              "trace": {"busy_s": 0.0, "window_s": 3.0}}
    assert _reader("audio_s_per_s")(corpus) == pytest.approx(400.0)
    assert _reader("device.idle_share.corpus")(corpus) is None  # nothing ran: no reading
    assert _reader("latency_p50_ms")(corpus) is None


def test_busy_union_and_gaps():
    dev = [("a", 0.0, 10.0), ("b", 5.0, 12.0), ("c", 20.0, 30.0)]
    assert trace.busy_us(dev) == 22.0
    assert trace.idle_gaps(dev, 40.0) == [(12.0, 20.0), (30.0, 40.0)]
    bd = trace.breakdown(dev, [("bench.x", 11.0, 25.0)], 40.0)
    assert dict(bd["idle_gaps"]) == pytest.approx({"bench.x": 8e-6, "host: no span open": 1e-5})
    assert dict(bd["device_ops"])["c"] == pytest.approx(10e-6)


@pytest.mark.parametrize("C,T", [(32, 64), (64, 48)])
def test_k1_flops_against_the_flop_counter(C, T):
    from benchmark.reference.models.hifigan import ResBlock1
    blocks = [ResBlock1(C, k, (1, 3, 5)) for k in flops.K1_KERNEL_SIZES]
    x = torch.zeros((1, C, T))
    with FlopCounterMode(display=False) as fc, torch.no_grad():
        for b in blocks:
            b(x)
    assert fc.get_total_flops() == flops.k1_flops(C, T)
    weights = sum(p.numel() for b in blocks for p in b.parameters())
    assert flops.k1_bytes(C, T) == 4 * (2 * C * T + weights)


def test_k1_stages_of_hifigan_v1():
    cfg = {"upsample_rates": [8, 8, 2, 2], "upsample_initial_channel": 512}
    assert flops.k1_stages(cfg) == [(64, 128), (32, 256)]


def test_model_flops_fit_matches_a_direct_count():
    cfg = {"model": {"n_vocab": 178, "n_spks": 1, "n_feats": 80, "enc_n_channels": 32,
                     "enc_filter_channels": 64, "enc_filter_channels_dp": 32, "enc_n_heads": 2,
                     "enc_n_layers": 1, "dec_channels": [32, 32], "dec_attention_head_dim": 16,
                     "dec_num_mid_blocks": 1, "dec_num_heads": 2},
           "vocoder_arch": "hifigan", "vocoder": {"upsample_initial_channel": 64},
           "synthesis": {"n_timesteps": 10}}
    mf = flops.ModelFlops(cfg)
    n, T = 100, 300
    direct = mf.encoder_at(n) + 10 * mf.estimator_at(T) + mf.vocoder_at(T)
    assert mf.utterance(n, T) == pytest.approx(direct, rel=1e-9)


def test_read_durations():
    ls = 1.9
    w = np.asarray([0.4, 1.2, 2.0, 0.9999])
    k = np.ceil(w)
    edges = np.ceil(np.cumsum(k * ls))
    frames = np.diff(np.concatenate([[0], edges]))
    n = int(np.floor(np.sum(k * ls)))
    ks, gap = read_durations(w, frames, ls, n)
    assert np.array_equal(ks, k) and gap == 0.0
    # a ceil flipped where w lies 1e-4 under an integer: admissible, a small gap
    k2 = k.copy()
    k2[3] = 2.0
    edges = np.ceil(np.cumsum(k2 * ls))
    frames = np.diff(np.concatenate([[0], edges]))
    ks, gap = read_durations(w, frames, ls, int(np.floor(np.sum(k2 * ls))))
    assert np.array_equal(ks, k2) and gap == pytest.approx(1e-4)
    # frames no duration gives
    ks, gap = read_durations(w, frames + np.asarray([0, 0, 7, 0]), ls, 100)
    assert ks is None and gap == math.inf
