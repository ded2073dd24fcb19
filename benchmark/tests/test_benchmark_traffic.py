"""The traffic generators: the same seed gives the same inputs."""

import numpy as np
import pytest

from benchmark.harness import common, serve
from benchmark.harness.textgen import make_texts

SPEC = common.load_spec()
SERVE = [w["name"] for w in SPEC["workloads"]
         if common.resolve_cell(SPEC, w["name"])["traffic"]["kind"] == "serve"]


@pytest.mark.parametrize("name", SERVE)
def test_schedule_is_deterministic_and_poisson(name):
    tr = common.resolve_cell(SPEC, name)["traffic"]
    a = serve.schedule(tr, 2**31 + 17, 30.0)
    b = serve.schedule(tr, 2**31 + 17, 30.0)
    c = serve.schedule(tr, 2**31 + 18, 30.0)
    assert a == b and a != c
    dues = np.asarray([d for d, _ in a])
    assert np.all(np.diff(dues) > 0) and dues[-1] < 30.0
    # about rate * seconds arrivals (Poisson: within 5 standard deviations)
    expect = tr["rate_rps"] * 30.0
    assert abs(len(a) - expect) < 5 * expect ** 0.5
    texts = [p["text"] for _, p in a]
    assert len(set(texts)) == len(texts)
    chars = tr["chars"]
    assert all(chars["min"] - 4 <= len(t) <= chars["max"] for t in texts)
    if tr.get("n_speakers"):
        spks = [p["spk"] for _, p in a]
        assert min(spks) >= 0 and max(spks) < tr["n_speakers"]


def test_texts_follow_the_length_mix():
    chars = {"min": 20, "max": 190, "mean": 100, "sd": 40}
    rng = np.random.default_rng(7)
    texts = make_texts(rng, 400, chars)
    lens = np.asarray([len(t) for t in texts])
    assert lens.min() >= 16 and lens.max() <= 190
    assert 85 <= lens.mean() <= 110
    assert make_texts(np.random.default_rng(7), 400, chars) == texts


def test_derive_seed_separates_uses_and_takes_large_seeds():
    s = 2**31 + 12345
    assert common.derive_seed(s, "weights") == common.derive_seed(s, "weights")
    assert common.derive_seed(s, "weights") != common.derive_seed(s, "traffic")
    assert common.derive_seed(s, "a") != common.derive_seed(s + 1, "a")
    assert 0 <= common.derive_seed(2**40 + 3, "x") < 2**63
