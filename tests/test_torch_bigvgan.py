"""BigVGAN-v2 in the port (``models/bigvgan.py``, ``ops/aa_snake.py``) on the
CPU, against the plain reference the benchmark holds it to
(``benchmark/reference/models/bigvgan.py``, written from the published
code, which imports nothing of the port): the generator, the
anti-aliased SnakeBeta and its edges, the arithmetic K4 computes, every
``TTSPipeline`` path with BigVGAN as its vocoder, the loader, and the
published widths on ``meta``. No JAX: the JAX package has no BigVGAN.

The generator is small (initial channel 32, rates (4, 2), kernels (8, 4),
AMP blocks of kernels 3, 7, 11 at dilations 1, 3, 5, 8 mel bands), its
snake parameters drawn away from their zero start.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from benchmark.reference.models import bigvgan as ref
from matcha_tpu_torch import cli as port_cli
from matcha_tpu_torch.models import bigvgan
from matcha_tpu_torch.models.matcha import MatchaTTS
from matcha_tpu_torch.ops import aa_snake as K4
from matcha_tpu_torch.utils import tracing

torch.set_num_threads(2)

SMALL = dict(upsample_initial_channel=32, upsample_rates=(4, 2), upsample_kernel_sizes=(8, 4),
             num_mels=8)
HOP = 8
MODEL = dict(n_vocab=20, n_feats=8, enc_n_channels=16, enc_filter_channels=24,
             enc_filter_channels_dp=12, enc_n_heads=2, enc_n_layers=2, dec_channels=(16, 16),
             dec_num_mid_blocks=1, dec_num_heads=1, dec_attention_head_dim=8,
             enc_p_dropout=0.0, dec_dropout=0.0, spk_emb_dim=8)
STEPS, TEMPERATURE = 2, 0.667
#: the 12 taps of the Kaiser-windowed sinc (cutoff 0.25, half-width 0.3),
#: as float32 values
PINNED_H = [float.fromhex(v) for v in (
    "0x1.09f0c2p-9", "0x1.33ac8cp-7", "-0x1.a28108p-6", "-0x1.d8544cp-5", "0x1.075110p-3",
    "0x1.c5d8cap-2", "0x1.c5d8cap-2", "0x1.075110p-3", "-0x1.d8544cp-5", "-0x1.a28108p-6",
    "0x1.33ac8cp-7", "0x1.09f0c2p-9")]
#: the port's plain path and the reference run the same torch operations
#: in the same order on the CPU (measured bit-equal); the tolerance leaves
#: room only for a library's choice of algorithm per call
TOL = 1e-6


def _seeded_pair():
    """(port generator, reference generator) on one state dict: PyTorch's
    default conv init from seed 1, snake parameters N(0, 0.5)."""
    torch.manual_seed(1)
    port = bigvgan.Generator(bigvgan.BigVGANConfig(**SMALL)).eval()
    g = torch.Generator().manual_seed(2)
    with torch.no_grad():
        for a in port.activations():
            a.act.alpha.copy_(0.5 * torch.randn(a.act.alpha.shape, generator=g))
            a.act.beta.copy_(0.5 * torch.randn(a.act.beta.shape, generator=g))
    reference = ref.Generator(ref.BigVGANConfig(**SMALL)).eval()
    reference.load_state_dict(port.state_dict())
    return port, reference


@pytest.fixture(scope="module")
def pair():
    return _seeded_pair()


def _close(got, want, tol=TOL):
    scale = want.abs().max().item()
    assert scale > 0
    assert (got - want).abs().max().item() <= tol * scale


def test_generator_equals_reference(pair):
    port, reference = pair
    mel = torch.randn(2, 37, SMALL["num_mels"], generator=torch.Generator().manual_seed(3))
    with torch.inference_mode():
        want = reference(mel)
    got = port(mel)
    assert got.shape == (2, 37 * HOP, 1)
    assert 0.05 < want.abs().max().item() < 1.0  # neither silent nor clamped throughout
    _close(got, want)
    _close(port.prepare()(mel), want)  # the terms computed once give the same


def test_filter_is_the_pinned_kaiser_sinc():
    h = K4.kaiser_sinc_filter()
    assert h.shape == (1, 1, 12) and h.dtype == torch.float32 and h.device.type == "cpu"
    assert h.flatten().tolist() == PINNED_H
    port = bigvgan.Generator(bigvgan.BigVGANConfig(**SMALL))
    for name, buf in port.named_buffers():
        assert name.endswith(("upsample.filter", "downsample.lowpass.filter")), name
        assert torch.equal(buf, h)


def _reference_activation(C, g):
    act = ref.Activation1d(ref.SnakeBeta(C, alpha_logscale=True))
    with torch.no_grad():
        act.act.alpha.copy_(torch.randn(C, generator=g))
        act.act.beta.copy_(torch.randn(C, generator=g))
    return act


@pytest.mark.parametrize("L", [1, 2, 3, 5, 17, 600])
def test_aa_snake_plain_equals_reference_activation(L):
    """Including L = 1, 2, 3, where the replicate padding decides every
    sample; a variant that zero-pads must fail there."""
    g = torch.Generator().manual_seed(L)
    act = _reference_activation(6, g)
    x = 2.0 * torch.randn(2, 6, L, generator=g)
    with torch.no_grad():
        want = act(x)
    freq, inv_mag = K4.snake_terms(act.act.alpha, act.act.beta)
    h = act.upsample.filter
    got = K4.aa_snake(x, freq, inv_mag, h, act.downsample.lowpass.filter)
    assert got.shape == x.shape
    _close(got, want)
    if L <= 3:
        with torch.no_grad():
            u = K4.RATIO * F.conv_transpose1d(F.pad(x, (K4.PAD, K4.PAD)), h.expand(6, -1, -1),
                                              stride=2, groups=6)[..., K4.UP_CROP:-K4.UP_CROP]
            v = u + inv_mag[None, :, None] * torch.sin(u * freq[None, :, None]) ** 2
            zero = F.conv1d(F.pad(v, K4.DOWN_PAD), h.expand(6, -1, -1), stride=2, groups=6)
        assert (zero - want).abs().max().item() > 100 * TOL * want.abs().max().item()


def _polyphase(x, freq, inv_mag, h_up, h_down, tile):
    """What csrc/aa_snake.cu computes, tile by tile: the inputs x[q0 - 6 ..]
    clamped at the row's ends; per pair i (input sample p = q0 - 3 + i) the
    two Up dots on x[p - 3 .. p + 3] and the snake, E[i] and O[i] the
    activated samples at 2p and 2p + 1, a pair outside the row standing for
    v[0] (p < 0) or v[2L - 1] (p > L - 1); then each output's Down dot over
    O[t + j] and E[t + j + 1]."""
    B, C, L = x.shape
    hu, hd = 2 * h_up.flatten(), h_down.flatten()
    y = torch.empty_like(x)
    xoff = K4.PAD + 1
    for q0 in range(0, L, tile):
        p = q0 - 3 + torch.arange(tile + 8)
        pc = p.clamp(0, L - 1)
        start = pc - 3  # x[p - 3 .. p + 3], through the clamp of the loaded row
        win = torch.stack([x[..., (start + d).clamp(0, L - 1)] for d in range(7)], -1)
        assert int((pc - q0 + xoff - 3).min()) >= 0  # inside the block's loaded inputs
        ue = sum(hu[11 - 2 * j] * win[..., j] for j in range(6))
        uo = sum(hu[10 - 2 * j] * win[..., j + 1] for j in range(6))
        ve = ue + inv_mag[:, None] * torch.sin(ue * freq[:, None]) ** 2
        vo = uo + inv_mag[:, None] * torch.sin(uo * freq[:, None]) ** 2
        E = torch.where(p > L - 1, vo, ve)
        O = torch.where(p < 0, ve, vo)
        t = torch.arange(min(tile, L - q0))
        y[..., q0:q0 + len(t)] = sum(hd[2 * j] * O[..., t + j] + hd[2 * j + 1] * E[..., t + j + 1]
                                     for j in range(6))
    return y


@pytest.mark.parametrize("L,tile", [(1, 4), (2, 4), (3, 4), (4, 4), (7, 4), (13, 8), (40, 1024)])
def test_kernel_arithmetic_equals_plain(L, tile):
    """K4's index arithmetic in float64 (where the orders of the sums do not
    matter at 1e-12): every tile edge and both row ends."""
    g = torch.Generator().manual_seed(100 + L)
    x = 3.0 * torch.randn(2, 3, L, generator=g, dtype=torch.float64)
    freq = torch.exp(torch.randn(3, generator=g, dtype=torch.float64))
    inv_mag = 1.0 / (torch.exp(torch.randn(3, generator=g, dtype=torch.float64)) + 1e-9)
    h = K4.kaiser_sinc_filter().double()
    want = K4.aa_snake_reference(x, freq, inv_mag, h, h)
    assert (_polyphase(x, freq, inv_mag, h, h, tile) - want).abs().max().item() < 1e-12


@pytest.mark.parametrize("n_tiles,C,rows,grid", [(1, 3, 12, 5), (5, 768, 6144, 528),
                                                  (288, 24, 192, 528), (2, 4, 6, 100)])
def test_kernel_tile_walk_equals_division(n_tiles, C, rows, grid):
    """K4's blocks walk tiles b, b + grid, ... and advance each tile's (row,
    channel, tile in the row) by carries (csrc/aa_snake.cu ``advance``):
    the same places as dividing."""
    n_total = rows * n_tiles
    step = (grid // n_tiles, (grid // n_tiles) % C, grid % n_tiles)
    for b in range(min(grid, n_total)):
        row, c, tq = b // n_tiles, (b // n_tiles) % C, b % n_tiles
        for tile in range(b, n_total, grid):
            assert (row, c, tq) == (tile // n_tiles, (tile // n_tiles) % C, tile % n_tiles)
            tq += step[2]
            carry = int(tq >= n_tiles)
            tq -= carry * n_tiles
            row += step[0] + carry
            c += step[1] + carry
            c -= int(c >= C) * C


def test_kernel_constants_agree_with_the_wrapper():
    src = (Path(K4.__file__).parents[1] / "csrc" / "aa_snake.cu").read_text()

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))

    assert (const("TQ"), const("TAPS"), const("PAD")) == (K4.TILE, K4.TAPS, K4.PAD)
    assert const("TQ") % const("R") == 0 and const("THREADS") * const("R") == const("TQ")
    assert len(re.findall(r"__global__[^(]*\b(\w+)\(", src)) == 1
    assert "aa_snake_kernel(" in src


# --------------------------------------------------------------------------
# the pipeline


@pytest.fixture(scope="module")
def model():
    torch.manual_seed(0)
    return MatchaTTS(**MODEL).eval()


def _ids(seed, lengths):
    g = np.random.default_rng(seed)
    x = np.zeros((len(lengths), max(lengths)), np.int64)
    for i, n in enumerate(lengths):
        x[i, :n] = g.integers(1, MODEL["n_vocab"], n)
    return x, np.asarray(lengths, np.int32)


def _reference_wav(reference, mel_bft, T_voc):
    with torch.inference_mode():
        return torch.clamp(reference(mel_bft.transpose(1, 2)[:, :T_voc])[..., 0], -1.0, 1.0)


@pytest.mark.parametrize("path", ["dynamic", "fused_graph"])
def test_pipeline_batch_paths_vocode_as_the_reference(model, pair, path):
    port, reference = pair
    pipe = port_cli.TTSPipeline(model, port, None, device="cpu")
    assert pipe.vocoder is port and pipe.vocoder_weights is None
    x, xl = _ids(4, (15, 9))
    kw = {"fixed_y_bucket": 64} if path == "fused_graph" else {}
    out = pipe.synthesise_batch(x, xl, n_timesteps=STEPS, temperature=TEMPERATURE,
                                generator=torch.Generator().manual_seed(5), **kw)
    wav = out["waveform"]
    T_voc = wav.shape[1] // HOP
    _close(wav, _reference_wav(reference, out["mel"], T_voc))


@pytest.mark.parametrize("fuse_stages", [False, True], ids=["split", "fused_stage"])
def test_pipeline_corpus_paths_vocode_as_the_reference(model, pair, fuse_stages):
    port, reference = pair
    pipe = port_cli.TTSPipeline(model, port, None, device="cpu")
    x, xl = _ids(6, (12, 20, 7))
    utts = [x[i, :xl[i]] for i in range(len(xl))]
    n = 0
    for chunk, out in pipe.synthesise_corpus(utts, n_timesteps=STEPS, temperature=TEMPERATURE,
                                             batch_size=2, fuse_stages=fuse_stages,
                                             generator=torch.Generator().manual_seed(7)):
        wav = out["waveform"]
        _close(wav, _reference_wav(reference, out["mel"], wav.shape[1] // HOP))
        n += len(chunk)
    assert n == 3


def test_vocode_span_names_the_architecture(pair):
    port, _ = pair
    pipe = port_cli.TTSPipeline(MatchaTTS(**MODEL).eval(), port, None, device="cpu")
    tracing.reset()
    tracing.enable()
    try:
        pipe.vocode(torch.randn(3, 16, SMALL["num_mels"]))
    finally:
        tracing.disable()
    (s,) = [s for s in tracing.spans() if s.name == "models.vocode"]
    assert s.attrs == {"arch": "bigvgan", "B": 3, "T_voc": 16}
    tracing.reset()


@pytest.mark.parametrize("kw", [{"vocoder_bf16": True}, {"bf16_latency": True},
                                {"vocoder_chunk": 64}])
def test_bf16_and_chunk_raise(model, pair, kw):
    with pytest.raises(ValueError, match="BigVGAN"):
        port_cli.TTSPipeline(model, pair[0], None, device="cpu", **kw)


def _weight_normed(sd):
    """A folded state dict in the published training layout: every conv's
    weight as weight_g (norm over the non-output dims) and weight_v."""
    out, g = {}, torch.Generator().manual_seed(9)
    for k, w in sd.items():
        if k.endswith(".weight") and w.dim() == 3:
            stem = k[:-len(".weight")]
            v = w * (1.0 + torch.rand(w.shape[0], 1, 1, generator=g))
            out[f"{stem}.weight_v"] = v
            out[f"{stem}.weight_g"] = torch.sqrt((w * w).sum(dim=(1, 2), keepdim=True))
        else:
            out[k] = w
    return out


def test_load_vocoder_folds_the_published_layout(tmp_path, monkeypatch, pair):
    port, reference = pair
    name = "bigvgan_v2_22khz_80band_fmax8k_256x"
    assert port_cli.VOCODER_URLS[name].endswith(
        "nvidia/bigvgan_v2_22khz_80band_fmax8k_256x/resolve/main/bigvgan_generator.pt")
    with pytest.raises(FileNotFoundError, match="bigvgan_generator.pt"):
        port_cli._checked(tmp_path / name, port_cli.VOCODER_URLS[name])
    monkeypatch.setitem(port_cli.BIGVGAN_VOCODERS, name, bigvgan.BigVGANConfig(**SMALL))
    sd = port.state_dict()
    published = _weight_normed(sd)
    assert "conv_post.weight_g" in published and "conv_post.bias" not in published
    assert "ups.1.0.weight_v" in published and "resblocks.5.activations.5.act.beta" in published
    torch.save({"generator": published}, tmp_path / name)
    vocoder, bias = port_cli.load_vocoder(tmp_path / name, "cpu", name=name)
    assert isinstance(vocoder, bigvgan.Generator) and bias is None
    for k, w in vocoder.state_dict().items():
        torch.testing.assert_close(w, sd[k], rtol=1e-6, atol=1e-7)
    mel = torch.randn(1, 11, SMALL["num_mels"], generator=torch.Generator().manual_seed(8))
    with torch.inference_mode():
        _close(vocoder(mel), reference(mel), tol=1e-5)


@pytest.mark.parametrize("key,value", [("resblock", "2"), ("activation", "snake"),
                                       ("snake_logscale", False), ("use_tanh_at_final", True),
                                       ("use_bias_at_final", True)])
def test_other_forms_are_refused(key, value):
    with pytest.raises(ValueError, match=key):
        bigvgan.Generator(bigvgan.BigVGANConfig(**SMALL, **{key: value}))


def test_published_widths_on_meta():
    with torch.device("meta"):
        port = bigvgan.Generator()
        reference = ref.Generator()
    assert sum(p.numel() for p in port.parameters()) == 112_199_472
    assert sum(p.numel() for p in reference.parameters()) == 112_199_472
    assert list(port.state_dict()) == list(reference.state_dict())
    assert len(port.activations()) == 18 * 6 + 1
    assert [up[0].out_channels for up in port.ups] == [768, 384, 192, 96, 48, 24]
    assert port.conv_post.bias is None
    assert all(t.device.type == "meta" for t in port.state_dict().values())
