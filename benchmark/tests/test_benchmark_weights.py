"""The seeded weights: the same seed gives the same weights, and the
system's models and the reference's get the same."""

import json

import torch

from benchmark.harness import common
from benchmark.harness.weights import seeded_state_dict


def _tiny(model):
    return dict(model, enc_n_channels=32, enc_filter_channels=64, enc_filter_channels_dp=32,
                enc_n_layers=1, dec_channels=(32, 32), dec_attention_head_dim=16,
                dec_num_mid_blocks=1)


def test_system_and_reference_get_the_same_weights():
    from matcha_tpu_torch.models.hifigan import Generator as SysGen
    from matcha_tpu_torch.models.hifigan import HiFiGANConfig as SysCfg
    from matcha_tpu_torch.models.matcha import MatchaTTS as SysMatcha

    from benchmark.reference.models.hifigan import Generator, HiFiGANConfig
    from benchmark.reference.models.matcha import MatchaTTS

    cfg = json.loads((common.BENCH / "configs" / "matcha-vctk.json").read_text())
    kw = _tiny(cfg["model"])
    torch.manual_seed(1)
    a = seeded_state_dict(SysMatcha(**kw), 2**31 + 5)
    torch.manual_seed(2)  # the default init is overwritten wherever it is random
    b = seeded_state_dict(MatchaTTS(**kw), 2**31 + 5)
    assert a.keys() == b.keys()
    assert all(torch.equal(a[k], b[k]) for k in a)
    c = seeded_state_dict(MatchaTTS(**kw), 2**31 + 6)
    assert not torch.equal(a["encoder.emb.weight"], c["encoder.emb.weight"])
    ga = seeded_state_dict(SysGen(SysCfg(upsample_initial_channel=64)), 9)
    gb = seeded_state_dict(Generator(HiFiGANConfig(upsample_initial_channel=64)), 9)
    assert all(torch.equal(ga[k], gb[k]) for k in ga)
    # the default scale: U(-1/sqrt(fan_in), 1/sqrt(fan_in)) for a conv
    w = gb["conv_pre.weight"]
    assert w.abs().max() <= 1 / (80 * 7) ** 0.5 and w.std() > 0.5 / (3 * 80 * 7) ** 0.5
