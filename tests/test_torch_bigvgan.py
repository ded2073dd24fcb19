"""BigVGAN-v2 in the port (``models/bigvgan.py``, ``ops/aa_snake.py``) on the
CPU, against the plain reference the benchmark holds it to
(``benchmark/reference/models/bigvgan.py``, written from the published
code, which imports nothing of the port): the generator, the
anti-aliased SnakeBeta and its edges, K4's walk over channels-last rows
and its work split, the channels-last layout of every layer, every
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
from matcha_tpu_torch import pipeline as port_pipeline
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


def _walk(x, freq, inv_mag, h_up, h_down, run):
    """What csrc/aa_snake.cu computes, run by run (every row and channel of
    a run at once): a run's halo, pairs q0 - 3 .. q0 + 2 from the inputs
    x[q0 - 6 .. q0 + 5] (each clamped to the row), then the pairs past the
    row's end and, in the row's first run, the pairs before its start; then
    steps of STEP outputs, each loading the STEP inputs it has not seen,
    computing the STEP new pairs (those past the row's end after), writing
    the outputs inside the row and carrying the last 6 inputs and pairs.
    Pair p gives E = v[2p] and O = v[2p + 1]."""
    B, C, L = x.shape
    hu, hd = 2 * h_up.flatten(), h_down.flatten()
    rows = x.transpose(1, 2)  # (B, L, C): one time step of every channel
    y = torch.full_like(rows, float("nan"))
    H, S = 6, K4.STEP

    def load(q):
        return rows[:, min(max(q, 0), L - 1)]

    def snake(u):
        return u + inv_mag * torch.sin(u * freq) ** 2

    def pair(w):  # the inputs p - 3 .. p + 3
        return (snake(sum(hu[11 - 2 * j] * w[j] for j in range(6))),
                snake(sum(hu[10 - 2 * j] * w[j + 1] for j in range(6))))

    def past_end(E, O, i):
        E[i], O[i] = O[i - 1], O[i - 1]

    for q0 in range(0, L, run):
        t = [load(q0 - H + k) for k in range(2 * H)]
        E, O = (list(v) for v in zip(*(pair(t[i:i + 7]) for i in range(H))))
        xw = t[H:]
        for i in range(1, H):
            if q0 - 3 + i > L - 1:
                past_end(E, O, i)
        if q0 == 0:
            for i in range(3):
                E[i] = O[i] = E[3]
        for q in range(q0, min(q0 + run, L), S):
            xw += [load(q + H + k) for k in range(S)]
            for i in range(H, H + S):
                e, o = pair(xw[i - H:i + 1])
                E.append(e)
                O.append(o)
            for i in range(H, H + S):
                if q - 3 + i > L - 1:
                    past_end(E, O, i)
            for s in range(S):
                if q + s < L:
                    y[:, q + s] = sum(hd[2 * j] * O[s + j] + hd[2 * j + 1] * E[s + j + 1]
                                      for j in range(6))
            xw, E, O = xw[S:], E[S:], O[S:]
    return y.transpose(1, 2)


def _f64_problem(seed, B, C, L):
    g = torch.Generator().manual_seed(seed)
    x = 3.0 * torch.randn(B, C, L, generator=g, dtype=torch.float64)
    freq = torch.exp(torch.randn(C, generator=g, dtype=torch.float64))
    inv_mag = 1.0 / (torch.exp(torch.randn(C, generator=g, dtype=torch.float64)) + 1e-9)
    return x, freq, inv_mag, K4.kaiser_sinc_filter().double()


@pytest.mark.parametrize("L,run", [(1, 8), (2, 8), (3, 8), (4, 4), (5, 8), (7, 4), (9, 8),
                                   (13, 8), (17, 16), (40, 8), (64, 32), (600, 128)])
def test_kernel_walk_equals_plain(L, run):
    """K4's sliding window in float64 (where the orders of the sums do not
    matter at 1e-12): a run's halo, run edges inside a row, both row ends,
    a last run cut short and rows shorter than one step or than the halo."""
    x, freq, inv_mag, h = _f64_problem(100 + L, 2, 3, L)
    want = K4.aa_snake_reference(x, freq, inv_mag, h, h)
    assert (_walk(x, freq, inv_mag, h, h, run) - want).abs().max().item() < 1e-12


def _task_places(B, C, L, V, run):
    """(b, q0, c0) of every thread of K4's grid that has a task, in thread
    order, as the kernel derives them from blockIdx * THREADS + threadIdx."""
    runs_per_row = -(-L // run)
    nv = C // V
    n_tasks = nv * B * runs_per_row
    task = torch.arange(-(-n_tasks // K4.THREADS) * K4.THREADS)
    task = task[task < n_tasks]
    r = task // nv
    b = r // runs_per_row
    return b, (r - b * runs_per_row) * run, (task - r * nv) * V


@pytest.mark.parametrize("C", [24, 48, 96, 5])
def test_kernel_tasks_cover_every_sample_once(C):
    """C not a multiple of a block's threads (nor of 2, at C = 5): the grid's
    tasks write every (row, sample, channel) once, neighbouring threads of
    a run take neighbouring channel vectors (coalesced loads), and the walk
    at that C equals the plain version."""
    B, L, run = 3, 37, 8
    V = K4.vector_width(C, 0)
    assert V == (2 if C % 2 == 0 else 1) and K4.vector_width(C, 4) == 1
    b, q0, c0 = _task_places(B, C, L, V, run)
    hits = torch.zeros(B, L, C, dtype=torch.int64)
    for bi, qi, ci in zip(b.tolist(), q0.tolist(), c0.tolist()):
        hits[bi, qi:min(qi + run, L), ci:ci + V] += 1
    assert bool((hits == 1).all())
    same_run = (b[1:] == b[:-1]) & (q0[1:] == q0[:-1])
    assert bool(((c0[1:] == c0[:-1] + V) | (~same_run & (c0[1:] == 0))).all())
    x, freq, inv_mag, h = _f64_problem(C, B, C, L)
    want = K4.aa_snake_reference(x, freq, inv_mag, h, h)
    assert (_walk(x, freq, inv_mag, h, h, run) - want).abs().max().item() < 1e-12


def _published_activation_shapes():
    """(C, upsampling) of each of the published generator's activations:
    the six stages' AMP blocks, then activation_post."""
    h = bigvgan.BigVGANConfig()
    out, up = [], 1
    for i, u in enumerate(h.upsample_rates):
        up *= u
        out.append((h.upsample_initial_channel // 2 ** (i + 1), up))
    return out + [out[-1]]


@pytest.mark.parametrize("C,up", _published_activation_shapes(),
                         ids=[f"stage{i + 1}" for i in range(6)] + ["post"])
def test_kernel_plan_at_published_stages(C, up):
    """The run rule at every published activation's shape, B = 8 and every
    vocoder bucket, on an H100's 132 SMs: 8-byte vectors, the longest run
    that still gives each SM TASKS_PER_SM threads (the shortest where none
    does), and a grid that covers the shape."""
    sms, B = 132, 8
    for T_voc in port_pipeline.VOC_BUCKETS:
        L = T_voc * up
        V = K4.vector_width(C, 0)
        run, runs_per_row, n_tasks = K4.plan(B, C, L, V, sms)
        assert V == 2 and run in K4.RUNS and run % K4.STEP == 0
        assert runs_per_row * run >= L > (runs_per_row - 1) * run
        assert n_tasks == C // V * B * runs_per_row
        enough = n_tasks >= K4.TASKS_PER_SM * sms
        assert enough or run == K4.RUNS[-1]
        longer = K4.RUNS[:K4.RUNS.index(run)]
        assert all(C // V * B * -(-L // r) < K4.TASKS_PER_SM * sms for r in longer)


def test_kernel_constants_agree_with_the_wrapper():
    src = (Path(K4.__file__).parents[1] / "csrc" / "aa_snake.cu").read_text()

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))

    assert (const("R"), const("THREADS"), const("TAPS")) == (K4.STEP, K4.THREADS, K4.TAPS)
    assert const("HALO") == 6 and all(run % const("R") == 0 for run in K4.RUNS)
    assert len(re.findall(r"__global__", src)) == 1
    assert re.search(r"__global__ void __launch_bounds__\(THREADS\)\naa_snake_kernel\(", src)


# --------------------------------------------------------------------------
# the channels-last layout


@pytest.mark.parametrize("entry", ["forward", "generate_channels_first",
                                   "generate_channels_last"])
def test_channels_last_generator_equals_channels_first(entry):
    """The prepared generator, channels-last throughout, against the plain
    reference, channels-first throughout (the port's own form before it
    went channels-last), on one state dict: within 1e-5 of the output's
    scale, through ``forward`` and through ``generate`` on a mel of
    either layout."""
    port, reference = _seeded_pair()
    port.prepare()
    mel = torch.randn(2, 29, SMALL["num_mels"], generator=torch.Generator().manual_seed(13))
    with torch.inference_mode():
        want = reference(mel)
        if entry == "forward":
            got = port(mel)
        else:
            m = mel.transpose(1, 2)
            m = m.contiguous() if entry == "generate_channels_first" else m
            assert K4.is_channels_last(m) == (entry == "generate_channels_last")
            got = port.generate(m).transpose(1, 2)
    assert got.shape == want.shape == (2, 29 * HOP, 1)
    _close(got, want, tol=1e-5)


def _layer_layouts(port, mel):
    """(module class name, input channels-last, output channels-last) for
    every Conv1d, ConvTranspose1d and Activation1d call of a forward."""
    seen = []

    def hook(module, args, out):
        seen.append((type(module).__name__, K4.is_channels_last(args[0]),
                     K4.is_channels_last(out)))

    kinds = (torch.nn.Conv1d, torch.nn.ConvTranspose1d, bigvgan.Activation1d)
    handles = [m.register_forward_hook(hook) for m in port.modules() if isinstance(m, kinds)]
    try:
        port(mel)
    finally:
        for h in handles:
            h.remove()
    return seen


def test_every_layer_reads_and_writes_channels_last(pair):
    port = pair[0].prepare()
    mel = torch.randn(2, 21, SMALL["num_mels"], generator=torch.Generator().manual_seed(14))
    seen = _layer_layouts(port, mel)
    n_act = len(port.activations())
    assert [k for k, _, _ in seen].count("Activation1d") == n_act == 2 * 18 + 1
    assert [k for k, _, _ in seen].count("ConvTranspose1d") == 2
    assert [k for k, _, _ in seen].count("Conv1d") == 2 * 18 + 2
    bad = [s for s in seen if not (s[1] and s[2])]
    assert not bad, bad


def test_relayout_rule_reads_the_strides_alone(pair):
    """K4's wrapper copies a channels-first input to channels-last and
    counts it (``LAUNCHES["aa_snake_relayout"]``); over a forward, the rule
    says no copy for every activation's input."""
    port = pair[0].prepare()
    inputs = []
    handles = [a.register_forward_pre_hook(lambda m, args: inputs.append(args[0]))
               for a in port.activations()]
    try:
        port(torch.randn(1, 19, SMALL["num_mels"], generator=torch.Generator().manual_seed(15)))
    finally:
        for h in handles:
            h.remove()
    assert len(inputs) == len(port.activations())
    assert not any(K4.needs_relayout(x) for x in inputs)
    x = torch.randn(2, 8, 30)
    assert K4.needs_relayout(x) and not K4.needs_relayout(K4.channels_last(x))
    assert not K4.needs_relayout(torch.randn(2, 1, 30))  # one channel: both layouts at once
    with pytest.raises(ValueError, match="channels-last or channels-first"):
        K4.needs_relayout(x[..., ::2])


@pytest.mark.parametrize("L", [1, 2, 3, 5, 17, 600])
def test_aa_snake_reference_either_layout(L):
    """The plain version gives the same values on a channels-first and a
    channels-last x, and the wrapper's output is channels-last on both."""
    g = torch.Generator().manual_seed(200 + L)
    x = 2.0 * torch.randn(2, 12, L, generator=g)
    freq, inv_mag = K4.snake_terms(torch.randn(12, generator=g), torch.randn(12, generator=g))
    h = K4.kaiser_sinc_filter()
    want = K4.aa_snake_reference(x, freq, inv_mag, h, h)
    xl = K4.channels_last(x)
    assert L == 1 or xl.stride() != x.stride()
    assert torch.equal(K4.aa_snake_reference(xl, freq, inv_mag, h, h), want)
    for inp in (x, xl):
        got = K4.aa_snake(inp, freq, inv_mag, h)
        assert K4.is_channels_last(got) and torch.equal(got, want)


def _conv_weights(port):
    return {n: m.weight for n, m in port.named_modules()
            if isinstance(m, (torch.nn.Conv1d, torch.nn.ConvTranspose1d))}


@pytest.mark.parametrize("then", ["load_state_dict", "to"])
def test_prepare_lays_the_weights_out_channels_last(then):
    """``prepare`` makes every conv weight channels-last in place (the same
    parameters, the same values); after ``load_state_dict`` of a
    channels-first state dict, or ``.to()``, ``prepare`` leaves them so
    again, with the snake terms computed anew."""
    port, _ = _seeded_pair()
    before = {n: w.detach().clone() for n, w in _conv_weights(port).items()}
    params = {n: w for n, w in _conv_weights(port).items()}
    assert not any(K4.is_channels_last(w) for w in params.values())
    port.prepare()
    assert len(params) == 2 * 18 + 4
    for n, w in _conv_weights(port).items():
        assert w is params[n] and K4.is_channels_last(w) and torch.equal(w, before[n])
    if then == "load_state_dict":
        port.load_state_dict({k: v.contiguous() for k, v in port.state_dict().items()})
    else:
        port.to(torch.float64).to(torch.float32)
    assert all(a.terms is None for a in port.activations())
    port.prepare()
    assert all(K4.is_channels_last(w) for w in _conv_weights(port).values())
    assert all(a.terms is not None for a in port.activations())
    for n, w in _conv_weights(port).items():
        torch.testing.assert_close(w, before[n], rtol=0, atol=0)


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
    pipe = port_pipeline.TTSPipeline(model, port, None, device="cpu")
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
    pipe = port_pipeline.TTSPipeline(model, port, None, device="cpu")
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
    pipe = port_pipeline.TTSPipeline(MatchaTTS(**MODEL).eval(), port, None, device="cpu")
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
        port_pipeline.TTSPipeline(model, pair[0], None, device="cpu", **kw)


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
