"""The port's CUDA kernels against their plain PyTorch versions, on a GPU.

Every test is marked ``cuda`` and skips without a CUDA device. The file
imports neither JAX nor the test configuration that does, so it runs on
a machine that has only PyTorch:

    python -m pytest tests/test_torch_kernels_cuda.py -m cuda --noconftest -q
"""

import pytest
import torch

from matcha_tpu_torch.models.hifigan import Generator, HiFiGANConfig
from matcha_tpu_torch.models.hifigan_fused import generator_apply_fused
from matcha_tpu_torch.ops import cuda_build, mas, mrf, mrf_phase

KS, DILS = (3, 7, 11), ((1, 3, 5),) * 3


@pytest.fixture()
def cuda_f32():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    saved = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    yield torch.device("cuda")
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved


@pytest.mark.cuda
@pytest.mark.parametrize("C,B,T", [(32, 2, 700), (32, 1, 100), (64, 1, 100), (64, 3, 1000),
                                   (64, 1, 8192), (16, 1, 100), (16, 3, 1000), (48, 3, 1000),
                                   (48, 1, 8192), (80, 1, 100), (80, 3, 1000)])
def test_fused_mrf_kernel_matches_plain(cuda_f32, C, B, T):
    """atol 1e-4: 3xTF32 tensor-core products summed in f32 over up to
    1,408 terms per conv, in another order than cuDNN's (measured up to
    ~3e-6 on an H100 at C = 16-128)."""
    g = torch.Generator().manual_seed(C * 1000 + T)
    x = torch.randn(B, C, T, generator=g).to(cuda_f32)
    weights = mrf.pack_mrf_weights([
        (torch.randn(shape, generator=g) * (0.3 / (k * C) ** 0.5)).to(cuda_f32)
        for k in KS for shape in ((3, k, C, C), (3, C), (3, k, C, C), (3, C))])
    before = mrf.LAUNCHES["mrf_stage"]
    got = mrf.fused_mrf_stage(x, weights, KS, DILS)
    want = mrf.fused_mrf_stage_reference(x, weights, KS, DILS)
    torch.cuda.synchronize()
    assert mrf.LAUNCHES["mrf_stage"] == before + 1
    assert (got - want).abs().max().item() < 1e-4


@pytest.mark.cuda
def test_fused_mrf_kernel_one_chain_one_dilation(cuda_f32):
    """The smallest stage, one ResBlock1 chain of one (k = 3, d = 1) pair:
    the conv pass alone, without the chain sum; atol 1e-4."""
    g = torch.Generator().manual_seed(5)
    x = torch.randn(2, 64, 300, generator=g).to(cuda_f32)
    weights = mrf.pack_mrf_weights([(torch.randn(shape, generator=g) * 0.1).to(cuda_f32)
                                    for shape in ((1, 3, 64, 64), (1, 64), (1, 3, 64, 64), (1, 64))])
    got = mrf.fused_mrf_stage(x, weights, (3,), ((1,),))
    want = mrf.fused_mrf_stage_reference(x, weights, (3,), ((1,),))
    torch.cuda.synchronize()
    assert (got - want).abs().max().item() < 1e-4


@pytest.mark.cuda
@pytest.mark.parametrize("C,t_tile", [(64, 16), (64, 64), (64, 240), (32, 608), (128, 224),
                                      (64, 256), (128, 1024)])
def test_fused_mrf_kernel_explicit_tiles(cuda_f32, C, t_tile):
    """An explicit tile, down to one m16 tile and up to the largest that
    fits (a larger one is clamped to it), on a T that is not a multiple of
    it; atol 1e-4."""
    g = torch.Generator().manual_seed(C + t_tile)
    x = torch.randn(2, C, 3 * t_tile + 37, generator=g).to(cuda_f32)
    weights = _stage_weights(g, C, cuda_f32)
    got = mrf.fused_mrf_stage(x, weights, KS, DILS, t_tile=t_tile)
    want = mrf.fused_mrf_stage_reference(x, weights, KS, DILS)
    torch.cuda.synchronize()
    assert (got - want).abs().max().item() < 1e-4


@pytest.mark.cuda
@pytest.mark.parametrize("C,T_mel", [(64, 384), (32, 384), (64, 768), (32, 768)])
def test_fused_mrf_kernel_at_the_corpus_shapes(cuda_f32, C, T_mel):
    """K1 at the staged corpus's own shapes (B = 8, T = 128 x a mel bucket
    at C = 64, 256 x at C = 32; its tiles cross passes over the weights):
    atol 1e-4 against its plain version (the old mma.sync pass read up to
    6.9e-6 at the corpus's shapes on an H100), in one launch of a kernel
    whose name holds ``mrf_stage_kernel``, the events k1_roofline.corpus
    counts, a name no kernel of K3's library holds."""
    g = torch.Generator().manual_seed(C + T_mel)
    T = T_mel * (128 if C == 64 else 256)
    x = torch.randn(8, C, T, generator=g).to(cuda_f32)
    weights = _stage_weights(g, C, cuda_f32)
    before = mrf.LAUNCHES["mrf_stage"]
    got = mrf.fused_mrf_stage(x, weights, KS, DILS)
    torch.cuda.synchronize()
    assert mrf.LAUNCHES["mrf_stage"] == before + 1
    want = mrf.fused_mrf_stage_reference(x, weights, KS, DILS)
    assert (got - want).abs().max().item() < 1e-4
    mrf_phase.fused_mrf_stage_phase(torch.zeros(1, 64, 32, device=cuda_f32),
                                    _stage_weights(g, 32, cuda_f32))  # K3's library built
    assert b"mrf_stage_kernel" in cuda_build.library_path("mrf_stage").read_bytes()
    assert b"mrf_stage_kernel" not in cuda_build.library_path("mrf_phase").read_bytes()


@pytest.mark.cuda
def test_fused_generator_matches_plain_on_cuda(cuda_f32):
    """Full-width HiFi-GAN v1, seed weights: the hybrid (two K1 launches)
    against the plain generator, atol 1e-5 on the tanh output."""
    torch.manual_seed(0)
    gen = Generator(HiFiGANConfig()).to(cuda_f32).eval()
    mel = torch.randn(2, 37, 80, device=cuda_f32)
    before = mrf.LAUNCHES["mrf_stage"]
    got = generator_apply_fused(gen, mel)
    want = gen(mel)
    torch.cuda.synchronize()
    assert mrf.LAUNCHES["mrf_stage"] == before + 2
    assert got.shape == (2, 37 * 256, 1)
    assert (got - want).abs().max().item() < 1e-5


def _stage_weights(g, C, device):
    return mrf.pack_mrf_weights([
        (torch.randn(shape, generator=g) * (0.3 / (k * C) ** 0.5)).to(device)
        for k in KS for shape in ((3, k, C, C), (3, C), (3, k, C, C), (3, C))])


@pytest.mark.cuda
@pytest.mark.parametrize("C,B,T", [(96, 1, 100), (96, 2, 1000), (128, 1, 100), (128, 3, 1000),
                                   (128, 1, 8192)])
def test_wide_fused_mrf_kernel_matches_plain(cuda_f32, C, B, T):
    """K1 above C = 80, its conv-1 buffer in global scratch; atol 1e-4."""
    g = torch.Generator().manual_seed(C * 1000 + T)
    x = torch.randn(B, C, T, generator=g).to(cuda_f32)
    weights = _stage_weights(g, C, cuda_f32)
    before = mrf.LAUNCHES["mrf_stage"]
    got = mrf.fused_mrf_stage(x, weights, KS, DILS)
    want = mrf.fused_mrf_stage_reference(x, weights, KS, DILS)
    torch.cuda.synchronize()
    assert mrf.LAUNCHES["mrf_stage"] == before + 1
    assert (got - want).abs().max().item() < 1e-4


@pytest.mark.cuda
@pytest.mark.parametrize("C", [16, 32, 48, 64])
@pytest.mark.parametrize("B,T,t_tile", [(1, 100, None), (3, 700, None), (1, "ragged", None),
                                        (3, "ragged", None), (3, 8192, None),
                                        (2, "ragged", 2048)])
def test_phase_kernel_matches_plain(cuda_f32, C, B, T, t_tile):
    """K3 against its plain version (the phase-packed products), atol
    1e-4, and against K1 on the transposed input, EQUAL (the same conv
    pass and sum order): T shorter than one tile, not a multiple of it
    (two of the batch's tiles + 37), B > 1, and an explicit tile above the
    largest that fits (clamped)."""
    if T == "ragged":
        T = 2 * mrf.pick_t_tile(C, 10**6, B=B) + 37
    g = torch.Generator().manual_seed(C * 1000 + T)
    x = torch.randn(B, T, C, generator=g).to(cuda_f32)
    weights = _stage_weights(g, C, cuda_f32)
    before = mrf_phase.LAUNCHES["mrf_stage_phase"], mrf.LAUNCHES["mrf_stage"]
    got = mrf_phase.fused_mrf_stage_phase(x, weights, KS, DILS, t_tile=t_tile)
    torch.cuda.synchronize()
    assert (mrf_phase.LAUNCHES["mrf_stage_phase"], mrf.LAUNCHES["mrf_stage"]) == \
        (before[0] + 1, before[1])
    want = mrf_phase.fused_mrf_stage_phase_reference(x, weights, KS, DILS)
    k1 = mrf.fused_mrf_stage(x.transpose(1, 2).contiguous(), weights, KS, DILS).transpose(1, 2)
    assert got.shape == x.shape
    assert (got - want).abs().max().item() < 1e-4
    assert torch.equal(got, k1)


@pytest.mark.cuda
def test_phase_generator_matches_plain_on_cuda(cuda_f32):
    """Full-width HiFi-GAN v1, seed weights: narrow_impl="phase" (two K3
    launches), then with the cap at 128 (one K1 at C = 128, two K3),
    against the plain generator, atol 1e-5 on the tanh output; with the
    cap at 128 and JAX's default tile of 2048, clamped in each kernel,
    EQUAL to the default tile (no output depends on the tile)."""
    torch.manual_seed(0)
    gen = Generator(HiFiGANConfig()).to(cuda_f32).eval()
    mel = torch.randn(2, 37, 80, device=cuda_f32)
    want = gen(mel)
    for cap, k1, k3 in ((64, 0, 2), (128, 1, 2)):
        before = mrf.LAUNCHES["mrf_stage"], mrf_phase.LAUNCHES["mrf_stage_phase"]
        got = generator_apply_fused(gen, mel, max_fused_channels=cap, narrow_impl="phase")
        torch.cuda.synchronize()
        assert (mrf.LAUNCHES["mrf_stage"] - before[0],
                mrf_phase.LAUNCHES["mrf_stage_phase"] - before[1]) == (k1, k3)
        assert got.shape == (2, 37 * 256, 1)
        assert (got - want).abs().max().item() < 1e-5
    assert torch.equal(generator_apply_fused(gen, mel, max_fused_channels=128,
                                             narrow_impl="phase", t_tile=2048), got)


@pytest.mark.cuda
def test_phase_kernel_refuses_what_it_cannot_take(cuda_f32):
    weights = _stage_weights(torch.Generator().manual_seed(0), 32, cuda_f32)
    with pytest.raises(ValueError, match="multiple of 16"):
        mrf_phase.fused_mrf_stage_phase(torch.zeros(1, 64, 24, device=cuda_f32), weights)
    with pytest.raises(ValueError, match="float32"):
        mrf_phase.fused_mrf_stage_phase(
            torch.zeros(1, 64, 32, device=cuda_f32, dtype=torch.float64), weights)
    with pytest.raises(ValueError, match="contiguous"):
        mrf_phase.fused_mrf_stage_phase(torch.zeros(1, 128, 32, device=cuda_f32)[:, ::2],
                                        weights)
    loose = tuple(w.clone() for w in weights)
    with pytest.raises(ValueError, match="pack_mrf_weights"):
        mrf_phase.fused_mrf_stage_phase(torch.zeros(1, 64, 32, device=cuda_f32), loose)
    with pytest.raises(ValueError, match="16 bytes"):
        mrf_phase.fused_mrf_stage_phase(torch.zeros(64 * 32 + 1, device=cuda_f32)[1:]
                                        .view(1, 64, 32), weights)
    with pytest.raises(ValueError, match="too wide"):  # P = 1: K1 refuses C = 256
        mrf_phase.fused_mrf_stage_phase(torch.zeros(1, 64, 256, device=cuda_f32), weights)


@pytest.mark.cuda
def test_kernel_refuses_what_it_cannot_take(cuda_f32):
    x = torch.zeros(1, 24, 64, device=cuda_f32)
    with pytest.raises(ValueError, match="multiple of 16"):
        mrf.fused_mrf_stage(x, (), KS, DILS)
    x = torch.zeros(1, 32, 64, device=cuda_f32, dtype=torch.float64)
    with pytest.raises(ValueError, match="float32"):
        mrf.fused_mrf_stage(x, (), KS, DILS)
    x = torch.zeros(1, 32, 64, device=cuda_f32)
    with pytest.raises(ValueError, match="built for"):
        mrf.fused_mrf_stage(x, (), (3, 5, 11), DILS)
    loose = tuple(torch.zeros(shape, device=cuda_f32)
                  for k in KS for shape in ((3, k, 32, 32), (3, 32), (3, k, 32, 32), (3, 32)))
    with pytest.raises(ValueError, match="pack_mrf_weights"):
        mrf.fused_mrf_stage(x, loose, KS, DILS)


def _mas_problem(seed, B, T_x, T_y, t_xs, t_ys, values):
    """(value, mask) on the CPU: ragged lengths, values normal, all zero or
    small integers (ties everywhere)."""
    g = torch.Generator().manual_seed(seed)
    if values == "normal":
        value = torch.randn(B, T_x, T_y, generator=g) * 3
    elif values == "zeros":
        value = torch.zeros(B, T_x, T_y)
    else:
        value = torch.randint(-2, 3, (B, T_x, T_y), generator=g).float()
    t_xs, t_ys = torch.tensor(t_xs), torch.tensor(t_ys)
    mask = ((torch.arange(T_x)[None, :, None] < t_xs[:, None, None])
            & (torch.arange(T_y)[None, None, :] < t_ys[:, None, None])).float()
    return value, mask


@pytest.mark.cuda
@pytest.mark.parametrize("B,T_x,T_y,t_xs,t_ys,values,bool_mask", [
    (1, 1, 8, [1], [8], "normal", False),
    (3, 37, 901, [37, 20, 1], [901, 400, 60], "normal", False),
    (3, 37, 901, [37, 20, 1], [901, 400, 60], "zeros", True),
    (2, 384, 901, [384, 300], [901, 777], "ints", False),
    (2, 700, 2048, [700, 513], [2048, 1500], "normal", True),
    (2, 1500, 300, [1500, 40], [300, 300], "normal", False),  # t_x > t_y, 2 chunks per thread
    (2, 12, 16, [9, 0], [4, 6], "normal", False),  # infeasible and empty rows
    # the edges of the kernel's instances (ops/mas.py::mas_layout): 1 and 2
    # cells per lane (T_x 31-33), float4 and scalar tile reads (1024, 1025),
    # the widest (4096); T_y 1, 7 and 33 (shorter than a tile, T_y % 4 != 0)
    # and 2051 (many tiles)
    (3, 31, 33, [31, 20, 0], [33, 33, 5], "ints", True),  # an empty row
    (3, 32, 7, [32, 7, 1], [7, 7, 7], "normal", False),  # t_x > t_y
    (3, 33, 1, [33, 1, 1], [1, 1, 1], "normal", True),
    (2, 33, 2051, [33, 17], [2051, 40], "ints", False),
    (2, 1024, 33, [1024, 33], [33, 33], "zeros", True),
    (2, 1024, 2051, [1024, 700], [2051, 1500], "normal", False),
    (2, 1025, 2051, [1025, 3], [2051, 2051], "ints", True),
    (2, 1025, 7, [1025, 7], [7, 7], "normal", False),
    (2, 4096, 2051, [4096, 2000], [2051, 2051], "normal", False),  # row 0: t_x > t_y
    (2, 4096, 1, [4096, 1], [1, 1], "ints", True),
])
def test_mas_kernel_equals_plain(cuda_f32, B, T_x, T_y, t_xs, t_ys, values, bool_mask):
    """The kernel's path is EQUAL to the plain version's, ties included."""
    value, mask = _mas_problem(T_x * 7 + T_y, B, T_x, T_y, t_xs, t_ys, values)
    if bool_mask:
        mask = mask.bool()
    want = mas.maximum_path(value, mask)  # the plain version on the CPU
    before = mas.LAUNCHES["maximum_path"]
    got = mas.maximum_path(value.to(cuda_f32), mask.to(cuda_f32))
    torch.cuda.synchronize()
    assert mas.LAUNCHES["maximum_path"] == before + 1
    assert got.dtype == mask.dtype and got.device.type == "cuda"
    assert torch.equal(got.cpu(), want)
    assert torch.equal(mas.maximum_path_reference(value.to(cuda_f32), mask.to(cuda_f32)).cpu(),
                       want)


@pytest.mark.cuda
def test_mas_layout_agrees_with_the_kernel(cuda_f32):
    """Each instance's shared memory as csrc/mas.cu computes it equals
    mas_layout's, at every T_x where the instance changes and at short,
    ragged and long T_y; the kernel refuses a cell count it was not built
    for."""
    lib = mas._library()
    edges = sorted({1} | {32 * c + d for c in mas.CPL_INSTANCES for d in (0, 1)} - {mas.MAX_T_X + 1})
    for T_x in edges:
        for T_y in (1, 7, 33, 832, 2051):
            cpl, _, rows, smem = mas.mas_layout(T_x, T_y)
            assert lib.mas_smem_bytes(cpl, rows) == smem, (T_x, T_y)
    assert lib.mas_smem_bytes(5, 8) == -1


@pytest.mark.cuda
def test_mas_kernel_refuses_what_it_cannot_take(cuda_f32):
    with pytest.raises(ValueError, match="one \\(B, T_x, T_y\\) shape"):
        mas.maximum_path(torch.zeros(1, 4, 8, device=cuda_f32),
                         torch.zeros(1, 4, 9, device=cuda_f32))
    big = torch.zeros(1, mas.MAX_T_X + 1, 2, device=cuda_f32)
    with pytest.raises(ValueError, match="at most"):
        mas.maximum_path(big, big)


def _tiny_pipeline(device, **kw):
    """A small Matcha (seed weights) with the full-width HiFi-GAN v1 and its
    denoiser, so that the fixed-bucket body runs K1 twice; ``kw`` go to the
    ``TTSPipeline``."""
    from matcha_tpu_torch.pipeline import TTSPipeline
    from matcha_tpu_torch.models.denoiser import compute_bias_spec
    from matcha_tpu_torch.models.matcha import MatchaTTS

    torch.manual_seed(3)
    model = MatchaTTS(enc_n_channels=32, enc_filter_channels=64, enc_filter_channels_dp=32,
                      enc_n_heads=2, enc_n_layers=2, dec_channels=(32, 32),
                      dec_attention_head_dim=16, dec_num_heads=2)
    vocoder = Generator(HiFiGANConfig()).to(device).eval()
    bias = compute_bias_spec(lambda m: generator_apply_fused(vocoder, m), device=device)
    return TTSPipeline(model, vocoder, bias, device=device, **kw)


def _ids(seed, n):
    x = torch.randint(1, 178, (1, n), generator=torch.Generator().manual_seed(seed)).numpy()
    return x, x.shape[1] * torch.ones(1, dtype=torch.int32).numpy()


def _unit_noise(seed, T_y, device):
    return torch.randn(1, T_y, 80, generator=torch.Generator().manual_seed(seed)).to(device)


@pytest.mark.cuda
def test_fused_graph_replay_equals_eager(cuda_f32):
    """One bucket's CUDA graph, replayed twice, against the same body run
    eagerly on the card on the same noise: equal mel lengths, the
    waveform and the packed bytes within 1e-5 / equal; K1 ran inside the
    capture, and a replay reuses the graph."""
    pipe = _tiny_pipeline(cuda_f32)
    x, xl = _ids(1, 40)
    z = _unit_noise(2, 256, cuda_f32)
    before = mrf.LAUNCHES["mrf_stage"]
    got = pipe.synthesise_batch(x, xl, n_timesteps=2, z=z, fixed_y_bucket=256)
    captured = mrf.LAUNCHES["mrf_stage"] - before
    again = pipe.synthesise_batch(x, xl, n_timesteps=2, z=z, fixed_y_bucket=256)
    want = pipe.synthesise_batch(x, xl, n_timesteps=2, z=z, fixed_y_bucket=256, cuda_graph=False)
    torch.cuda.synchronize()
    graphs = [g for g in pipe._graphs.values() if g.graph is not None]
    assert len(graphs) == 1 and len(pipe._graphs) == 2
    assert captured == 4  # two stages, in the warm-up and in the capture
    assert mrf.LAUNCHES["mrf_stage"] - before == 6  # the replay launched nothing
    assert torch.equal(got["mel_lengths"], want["mel_lengths"])
    assert got["waveform"].shape == (1, 256 * 256)
    for out in (got, again):
        assert (out["waveform"] - want["waveform"]).abs().max().item() <= 1e-5
        assert (out["mel"] - want["mel"]).abs().max().item() <= 1e-5
    assert torch.equal(got["waveform"], again["waveform"])


@pytest.mark.cuda
def test_fused_graphs_sharing_a_pool_keep_their_results(cuda_f32):
    """Two buckets' graphs in one memory pool, replayed in turns: the
    results each call returned stay as they were after the other graph
    (and the same one) replayed, and equal their eager bodies."""
    pipe = _tiny_pipeline(cuda_f32)
    inputs = {128: (_ids(4, 30), _unit_noise(5, 128, cuda_f32)),
              256: (_ids(6, 70), _unit_noise(7, 256, cuda_f32))}
    kept = {}
    for _ in range(2):
        for T_y, ((x, xl), z) in inputs.items():
            out = pipe.synthesise_batch(x, xl, n_timesteps=2, z=z, fixed_y_bucket=T_y)
            kept.setdefault(T_y, []).append((out, {k: v.clone() for k, v in out.items()}))
    torch.cuda.synchronize()
    assert pipe._graph_pool is not None
    assert {g.graph.pool() for g in pipe._graphs.values()} == {pipe._graph_pool}
    for T_y, ((x, xl), z) in inputs.items():
        want = pipe.synthesise_batch(x, xl, n_timesteps=2, z=z, fixed_y_bucket=T_y,
                                     cuda_graph=False)
        for out, snapshot in kept[T_y]:
            for k, v in snapshot.items():
                assert torch.equal(out[k], v), (T_y, k)
            assert (out["waveform"] - want["waveform"]).abs().max().item() <= 1e-5


@pytest.mark.cuda
def test_fused_graph_replay_survives_other_lengths(cuda_f32):
    """A replay after the denoiser's STFT has run at 100 other lengths and
    the allocator has handed out that memory again still equals the eager
    body: the constants the graph captured (the window and the ISTFT
    normaliser) stay allocated."""
    from matcha_tpu_torch.audio import stft

    pipe = _tiny_pipeline(cuda_f32)
    x, xl = _ids(10, 30)
    z = _unit_noise(11, 128, cuda_f32)
    pipe.synthesise_batch(x, xl, n_timesteps=2, z=z, fixed_y_bucket=128)
    for n in range(200, 300):
        stft.istft(torch.ones(513, n, device=cuda_f32), torch.zeros(513, n, device=cuda_f32))
    litter = [torch.full((1024 + 256 * n,), 7.0, device=cuda_f32) for n in range(200, 300)]
    got = pipe.synthesise_batch(x, xl, n_timesteps=2, z=z, fixed_y_bucket=128)
    want = pipe.synthesise_batch(x, xl, n_timesteps=2, z=z, fixed_y_bucket=128, cuda_graph=False)
    torch.cuda.synchronize()
    del litter
    assert torch.equal(got["mel_lengths"], want["mel_lengths"])
    assert (got["waveform"] - want["waveform"]).abs().max().item() <= 1e-5


@pytest.mark.cuda
def test_fused_graph_capture_failure_raises(cuda_f32, monkeypatch):
    """A body that cannot be captured (a host sync inside it) raises; it
    is never run eagerly in the graph's place."""
    from matcha_tpu_torch import fused

    pipe = _tiny_pipeline(cuda_f32)
    body = fused.FusedGraph.body

    def syncing_body(self):
        out = body(self)
        out["peak"] = torch.full((1,), float(out["waveform"].abs().max().item()), device=cuda_f32)
        return out

    monkeypatch.setattr(fused.FusedGraph, "body", syncing_body)
    x, xl = _ids(8, 20)
    with pytest.raises(RuntimeError, match="capturing the fused graph"):
        pipe.synthesise_batch(x, xl, n_timesteps=2, z=_unit_noise(9, 128, cuda_f32),
                              fixed_y_bucket=128)
    assert all(g.graph is None for g in pipe._graphs.values())
    torch.cuda.synchronize()


def _corpus(seed, n):
    g = torch.Generator().manual_seed(seed)
    lengths = torch.randint(20, 60, (n,), generator=g).tolist()
    return [torch.randint(1, 178, (k,), generator=g).numpy() for k in lengths]


@pytest.mark.cuda
def test_stage_graph_replay_equals_eager(cuda_f32):
    """Staged corpus synthesis with the fused stage as CUDA graphs (each
    triple captured at its first batch, replayed after) against the same
    stage run eagerly on the card, on generators seeded alike: the same
    batches and lengths, the mel within 1e-6 and the waveform within 1e-5;
    K1 ran inside the captures and not in a replay."""
    pipe = _tiny_pipeline(cuda_f32)
    utts = _corpus(12, 7)
    runs = {}
    for mode in (None, False, None):
        before = mrf.LAUNCHES["mrf_stage"]
        outs = list(pipe.synthesise_corpus(utts, n_timesteps=2, batch_size=2, fuse_stages=True,
                                           cuda_graph=mode,
                                           generator=torch.Generator(cuda_f32).manual_seed(5)))
        runs.setdefault(mode, []).append((outs, mrf.LAUNCHES["mrf_stage"] - before))
    torch.cuda.synchronize()
    graphs = [g for k, g in pipe._graphs.items() if k[0] == "stage" and g.cuda_graph]
    assert graphs and all(g.graph is not None for g in graphs)
    assert runs[None][0][1] == 4 * len(graphs)  # warm-up and capture, two stages each
    assert runs[None][1][1] == 0 and sum(g.replays for g in graphs) == 2 * len(runs[False][0][0])
    eager = runs[False][0][0]
    for outs, _ in runs[None]:
        assert [c for c, _ in outs] == [c for c, _ in eager]
        for (_, a), (_, b) in zip(outs, eager):
            assert (a["mel_lengths_host"] == b["mel_lengths_host"]).all()
            assert (a["mel"] - b["mel"]).abs().max().item() <= 1e-6
            assert (a["waveform"] - b["waveform"]).abs().max().item() <= 1e-5
            assert a["first_sample"].item() == a["waveform"][0, 0].item()


@pytest.mark.cuda
def test_decode_graph_replay_equals_eager(cuda_f32):
    """The split corpus path with the flow as CUDA graphs (one per (B,
    T_y), captured at its first batch) against the same body run eagerly
    on the card, on generators seeded alike: the same batches and
    lengths, the mel within 1e-6 and the waveform within 1e-5; a second
    run replays with no new capture, and the captures are the distinct
    (B, T_y)."""
    pipe = _tiny_pipeline(cuda_f32)
    utts = _corpus(13, 9)
    runs = {}
    for mode in (None, False, None):
        outs = list(pipe.synthesise_corpus(utts, n_timesteps=2, batch_size=2, cuda_graph=mode,
                                           generator=torch.Generator(cuda_f32).manual_seed(5)))
        runs.setdefault(mode, []).append((outs, pipe.corpus_decode_captures,
                                          pipe.corpus_decode_replays))
    torch.cuda.synchronize()
    eager = runs[False][0][0]
    keys = {(len(c), o["mel"].shape[-1]) for c, o in eager}
    graphs = {k[1:3]: g for k, g in pipe._graphs.items() if k[0] == "decode" and g.cuda_graph}
    assert set(graphs) == keys and all(g.graph is not None for g in graphs.values())
    assert sum(g.replays for g in graphs.values()) == 2 * len(eager)
    (first, captures, replays), (second, captures2, replays2) = runs[None]
    assert captures == len(keys) and replays == len(eager) - len(keys)
    assert captures2 == captures + len(keys)  # the eager run's bodies count as new
    assert replays2 == replays + 2 * len(eager) - len(keys)
    assert runs[False][0][1] == captures + len(keys)
    for outs in (first, second):
        assert [c for c, _ in outs] == [c for c, _ in eager]
        for (_, a), (_, b) in zip(outs, eager):
            assert (a["mel_lengths_host"] == b["mel_lengths_host"]).all()
            assert torch.equal(a["attn"], b["attn"])
            assert (a["mel"] - b["mel"]).abs().max().item() <= 1e-6
            assert (a["waveform"] - b["waveform"]).abs().max().item() <= 1e-5


@pytest.mark.cuda
def test_daemon_replays_only_warmed_graphs(cuda_f32):
    """After warmup a lone request replays a warmed graph from the
    batcher thread and equals the eager body on its call's generator; a
    capture of any other bucket raises."""
    import numpy as np

    from matcha_tpu_torch.serve import BatchingServer

    pipe = _tiny_pipeline(cuda_f32)
    pipe.cleaner = "english_cleaners_no_espeak"
    server = BatchingServer(pipe, max_batch=2, n_timesteps=2, default_rate=1.0)
    try:
        server.warmup([(64, 256)])
        warmed = {k: g for k, g in pipe._graphs.items() if getattr(g, "graph", None) is not None}
        assert sorted(g.T_y for g in warmed.values()) == [128, 256]
        replays = sum(g.replays for g in warmed.values())  # one after each capture
        r = server.submit("hello there, general kenobi", timeout_s=120)
        assert r.error is None and server.n_fast == 1
        assert sum(g.replays for g in warmed.values()) == replays + 1
        T_y = next(g.T_y for g in warmed.values() if g.replays == 2)
        x1 = np.zeros((1, 64), np.int32)
        x1[0, :len(r.seq)] = r.seq
        want = pipe.synthesise_batch(x1, np.asarray([len(r.seq)], np.int32), n_timesteps=2,
                                     fixed_y_bucket=T_y, cuda_graph=False,
                                     generator=server.call_generator(1))
        n = int(want["mel_lengths"][0])
        assert r.n_frames == n
        ref = want["waveform"][0, :n * 256].clamp(-1, 1).cpu().numpy()
        assert np.abs(r.wav - ref).max() <= 1e-5 + 2.0 / (2**23 - 1)
        with pytest.raises(RuntimeError, match="closed captures"):
            pipe.synthesise_batch(x1, np.asarray([len(r.seq)], np.int32), n_timesteps=2,
                                  fixed_y_bucket=512, generator=server.call_generator(9))
        assert all(g.graph is None for k, g in pipe._graphs.items() if k not in warmed)
    finally:
        server.shutdown()


@pytest.mark.cuda
def test_chunked_vocoder_on_cuda(cuda_f32):
    """``vocoder_chunk`` on the card, 5 windows of a (2, 300) mel, against
    the whole utterance (no denoiser), as numpy's allclose at 1e-5; K1
    launched twice per window."""
    from matcha_tpu_torch.pipeline import TTSPipeline

    pipe = _tiny_pipeline(cuda_f32)
    mel = torch.randn(2, 300, 80, generator=torch.Generator().manual_seed(4)).to(cuda_f32)
    whole = TTSPipeline(pipe.model, pipe.vocoder, None, device=cuda_f32).vocode(mel)
    before = mrf.LAUNCHES["mrf_stage"]
    chunked = TTSPipeline(pipe.model, pipe.vocoder, None, device=cuda_f32,
                          vocoder_chunk=64).vocode(mel)
    torch.cuda.synchronize()
    assert mrf.LAUNCHES["mrf_stage"] - before == 2 * 5
    assert chunked.shape == whole.shape == (2, 300 * 256)
    assert ((chunked - whole).abs() <= 1e-5 + 1e-5 * whole.abs()).all()


@pytest.mark.cuda
@pytest.mark.parametrize("C", [16, 32, 48, 64, 80, 96, 112, 128])
@pytest.mark.parametrize("B", [1, 3])
def test_fused_mrf_bf16_kernel_matches_plain(cuda_f32, C, B):
    """K1's bf16-product instance at every width, on T = two of its tiles
    + 37 (not a multiple of the tile), against its plain version (the
    operands of each conv rounded to bf16, f32 sums), as fractions of the
    bf16 rounding's own effect (the plain bf16 stage against the plain f32
    one): the max below it, the mean below 0.2 of it (``chip_smoke.py``'s
    K1_BF16_TOL: sums in another order, and the tensor cores' bf16 sums,
    less exact than f32's, flip a few roundings of the next conv's
    operands; measured up to 1.3e-4 / 1.1e-5 against an effect of ~7e-4 /
    1.2e-4 on an H100)."""
    T = 2 * mrf.pick_t_tile(C, 10**6, B=B) + 37
    g = torch.Generator().manual_seed(C * 10 + B)
    x = torch.randn(B, C, T, generator=g).to(cuda_f32)
    weights = _stage_weights(g, C, cuda_f32)
    before = dict(mrf.LAUNCHES)
    got = mrf.fused_mrf_stage(x, weights, KS, DILS, compute_dtype=torch.bfloat16)
    want = mrf.fused_mrf_stage_reference(x, weights, KS, DILS, compute_dtype=torch.bfloat16)
    f32 = mrf.fused_mrf_stage_reference(x, weights, KS, DILS)
    torch.cuda.synchronize()
    assert mrf.LAUNCHES == {**before, "mrf_stage_bf16": before["mrf_stage_bf16"] + 1}
    err, effect = (got - want).abs(), (want - f32).abs()
    assert err.max().item() < effect.max().item()
    assert err.mean().item() < 0.2 * effect.mean().item()


@pytest.mark.cuda
def test_fused_graph_bf16_latency_replay_equals_eager(cuda_f32):
    """``bf16_latency``: the bucket's graph (the Euler loop on the bf16
    decoder copy, the vocoder in bf16) replayed against the same body run
    eagerly on the card on the same noise: bit-equal waveform and mel, and
    the mel lengths those of the f32 body."""
    pipe = _tiny_pipeline(cuda_f32, bf16_latency=True)
    x, xl = _ids(1, 40)
    z = _unit_noise(2, 256, cuda_f32)
    got = pipe.synthesise_batch(x, xl, n_timesteps=2, z=z, fixed_y_bucket=256)
    want = pipe.synthesise_batch(x, xl, n_timesteps=2, z=z, fixed_y_bucket=256, cuda_graph=False)
    f32 = _tiny_pipeline(cuda_f32).synthesise_batch(x, xl, n_timesteps=2, z=z, fixed_y_bucket=256,
                                                    cuda_graph=False)
    torch.cuda.synchronize()
    assert [g.graph is not None for g in pipe._graphs.values()] == [True, False]
    assert torch.equal(got["waveform"], want["waveform"]) and torch.equal(got["mel"], want["mel"])
    assert torch.equal(got["mel_lengths"], f32["mel_lengths"])
    assert got["waveform"].dtype == torch.float32 and bool(torch.isfinite(got["waveform"]).all())


def _bf16_log_prior(seed, B, T_x, T_y, t_xs, t_ys):
    """A Gaussian log-prior of LJSpeech's magnitude (~ -1e3, a few units
    between neighbours) rounded to bf16, where the spacing is 4-8: whole
    runs of cells tie. Returns (value f32, mask) on the CPU and the tied
    neighbour pairs along x."""
    g = torch.Generator().manual_seed(seed)
    value = (-900.0 - 40.0 * torch.rand(B, 1, T_y, generator=g)
             - 6.0 * torch.randn(B, T_x, T_y, generator=g)).to(torch.bfloat16).float()
    t_xs, t_ys = torch.tensor(t_xs), torch.tensor(t_ys)
    mask = ((torch.arange(T_x)[None, :, None] < t_xs[:, None, None])
            & (torch.arange(T_y)[None, None, :] < t_ys[:, None, None])).float()
    ties = int((value[:, 1:] == value[:, :-1]).sum())
    return value, mask, ties


@pytest.mark.cuda
@pytest.mark.parametrize("B,T_x,T_y,t_xs,t_ys", [
    # the multi-speaker (and LJSpeech) training batch: 32 rows, T_x 304, T_y 896
    (32, 304, 896, [304 - 7 * i for i in range(32)], [896 - 19 * i for i in range(32)]),
    (3, 31, 33, [31, 20, 1], [33, 33, 5]),
    (3, 33, 7, [33, 7, 1], [7, 7, 7]),
    (2, 1024, 2051, [1024, 700], [2051, 1500]),
    (2, 1025, 1027, [1025, 3], [1027, 1027]),
])
def test_mas_kernel_equals_plain_on_bf16_log_priors(cuda_f32, B, T_x, T_y, t_xs, t_ys):
    """bf16 training hands K2 a log-prior rounded to bf16 and cast back
    (as JAX's kernel takes it f32): ties are everywhere, and the kernel's
    path must still be EQUAL to the plain version's."""
    value, mask, ties = _bf16_log_prior(T_x + T_y, B, T_x, T_y, t_xs, t_ys)
    assert ties > B * T_y  # the input is built to tie
    want = mas.maximum_path(value, mask)
    got = mas.maximum_path(value.to(cuda_f32), mask.to(cuda_f32))
    assert torch.equal(got.cpu(), want)
    assert torch.equal(
        mas.maximum_path_reference(value.to(cuda_f32), mask.to(cuda_f32)).cpu(), want)


def _tiny_ms_pipeline(device):
    """A small 4-speaker Matcha (seed weights) with the full-width
    HiFi-GAN v1."""
    from matcha_tpu_torch.pipeline import TTSPipeline
    from matcha_tpu_torch.models.denoiser import compute_bias_spec
    from matcha_tpu_torch.models.matcha import MatchaTTS

    torch.manual_seed(5)
    model = MatchaTTS(n_spks=4, spk_emb_dim=16, enc_n_channels=32, enc_filter_channels=64,
                      enc_filter_channels_dp=32, enc_n_heads=2, enc_n_layers=2,
                      dec_channels=(32, 32), dec_attention_head_dim=16, dec_num_heads=2)
    vocoder = Generator(HiFiGANConfig()).to(device).eval()
    bias = compute_bias_spec(lambda m: generator_apply_fused(vocoder, m), device=device)
    return TTSPipeline(model, vocoder, bias, device=device)


@pytest.mark.cuda
def test_multispeaker_fused_graph_serves_two_speakers_from_one_capture(cuda_f32):
    """A multi-speaker fixed-bucket graph reads the speaker from its static
    buffer: one capture, replayed at speakers 0 and 2, each replay
    bit-equal to the eager body at that speaker on the same noise, and
    the two speakers' mels differ."""
    pipe = _tiny_ms_pipeline(cuda_f32)
    x, xl = _ids(4, 40)
    z = _unit_noise(5, 256, cuda_f32)
    outs = {}
    for spk in (0, 2):
        got = pipe.synthesise_batch(x, xl, n_timesteps=2, z=z, fixed_y_bucket=256, spks=[spk])
        want = pipe.synthesise_batch(x, xl, n_timesteps=2, z=z, fixed_y_bucket=256,
                                     cuda_graph=False, spks=[spk])
        torch.cuda.synchronize()
        assert torch.equal(got["mel_lengths"], want["mel_lengths"])
        assert torch.equal(got["waveform"], want["waveform"])
        assert torch.equal(got["mel"], want["mel"])
        outs[spk] = got
    graphs = [g for g in pipe._graphs.values() if g.graph is not None]
    assert len(graphs) == 1 and graphs[0].replays == 2 and graphs[0].spks is not None
    assert not torch.equal(outs[0]["mel"], outs[2]["mel"])
    with pytest.raises(ValueError, match="out of range"):
        pipe.synthesise_batch(x, xl, n_timesteps=2, z=z, fixed_y_bucket=256, spks=[4])


@pytest.mark.cuda
def test_conformer_decode_builds_no_relative_embedding_tensor(cuda_f32):
    """An all-conformer decoder step at B = 1, T = 2,048 (the top fixed
    bucket), LJSpeech width (U-Net 256, 2 heads of 64), peaks less than
    256 MiB above the all-transformer decoder's peak at the same shape:
    the (T, T, 64) relative-embedding tensor alone would be 1 GiB."""
    from matcha_tpu_torch.models.matcha import MatchaTTS

    peaks = {}
    T = 2048
    for block in ("transformer", "conformer"):
        torch.manual_seed(0)
        model = MatchaTTS(dec_down_block_type=block, dec_mid_block_type=block,
                          dec_up_block_type=block).to(cuda_f32).eval()
        est = model.decoder.estimator
        x = torch.randn(1, T, 80, device=cuda_f32)
        mask = torch.ones(1, T, 1, device=cuda_f32)
        t = torch.full((1,), 0.5, device=cuda_f32)
        with torch.inference_mode():
            est(x, mask, x, t)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            out = est(x, mask, x, t)
            torch.cuda.synchronize()
        assert out.shape == (1, T, 80) and bool(torch.isfinite(out).all())
        peaks[block] = torch.cuda.max_memory_allocated() - base
        del model, est, out
        torch.cuda.empty_cache()
    assert peaks["conformer"] - peaks["transformer"] < 256 * 2**20, peaks


# the tiny vocoder of the CPU tests (tests/test_deploy_and_vocoder.py's TINY_HIFI)
VOC_TINY = dict(upsample_rates=(4, 2), upsample_kernel_sizes=(8, 4), upsample_initial_channel=16,
                resblock_kernel_sizes=(3,), resblock_dilation_sizes=((1, 2),), hop_size=8,
                n_fft=32, win_size=32, fmax=4000.0, segment_size=128)


@pytest.mark.cuda
def test_vocoder_gan_step_on_cuda_matches_cpu(cuda_f32):
    """One GAN step of the tiny vocoder on the card and on the CPU from the
    same state and batch: the losses to rtol 1e-4; the weights within 1e-5
    but for at most 1e-4 of them, which Adam's first update (about +-lr
    where a gradient is near zero) may move by up to 2 lr (scale 0's u
    among them). K1 is never launched: the training generator runs plain convs."""
    from matcha_tpu_torch.training import vocoder_trainer as vt

    h = HiFiGANConfig(**VOC_TINY)
    cpu = vt.init_vocoder_state(h, "cpu", steps_per_epoch=1)
    gpu = vt.init_vocoder_state(h, cuda_f32, steps_per_epoch=1)
    for name in ("gen", "mpd", "msd"):
        getattr(gpu, name).load_state_dict(getattr(cpu, name).state_dict())
    g = torch.Generator().manual_seed(3)
    batch = {"mel": torch.randn(2, 80, 16, generator=g),
             "mel_loss": torch.randn(2, 80, 16, generator=g),
             "audio": torch.rand(2, 1, 128, generator=g) - 0.5}
    before = mrf.LAUNCHES["mrf_stage"]
    m_gpu = vt.vocoder_train_step(gpu, {k: v.to(cuda_f32) for k, v in batch.items()})
    m_cpu = vt.vocoder_train_step(cpu, batch)
    torch.cuda.synchronize()
    assert mrf.LAUNCHES["mrf_stage"] == before
    for k in m_cpu:
        assert abs(float(m_gpu[k]) - float(m_cpu[k])) <= 1e-4 * abs(float(m_cpu[k])), k
    beyond = total = 0
    for name in ("gen", "mpd", "msd"):
        want = getattr(cpu, name).state_dict()
        for k, v in getattr(gpu, name).state_dict().items():
            d = (v.cpu() - want[k]).abs()
            assert float(d.max()) <= 2 * h.learning_rate + 1e-6, k
            beyond += int((d > 1e-5).sum())
            total += d.numel()
    assert beyond <= 1e-4 * total


@pytest.mark.cuda
def test_device_mel_on_cuda_matches_cpu_with_gradient(cuda_f32):
    """The differentiable log-mel on the card against the CPU: values to
    2e-5, the gradient of a weighted sum to 1e-5 of its largest element."""
    from matcha_tpu_torch.audio.mel import mel_spectrogram

    g = torch.Generator().manual_seed(4)
    y = torch.rand(3, 8192, generator=g) * 1.6 - 0.8
    w = torch.randn(3, 80, 32, generator=g)
    out = {}
    for dev in ("cpu", cuda_f32):
        yd = y.detach().to(dev).requires_grad_()
        mel = mel_spectrogram(yd)
        (mel * w.to(dev)).sum().backward()
        out[str(dev)] = (mel.detach().cpu(), yd.grad.cpu())
    (m_c, g_c), (m_g, g_g) = out["cpu"], out["cuda"]
    assert (m_g - m_c).abs().max().item() < 2e-5
    assert (g_g - g_c).abs().max().item() < 1e-5 * g_c.abs().max().item()


@pytest.mark.cuda
def test_remat_gradients_on_cuda_equal_those_without(cuda_f32):
    """``MatchaTTS(remat=True)``: one loss + backward at a small width
    gives the same gradients as without (atol 1e-6; bit-equal so far)."""
    from matcha_tpu_torch.models.matcha import MatchaTTS

    kw = dict(n_feats=16, enc_n_channels=16, enc_filter_channels=32, enc_filter_channels_dp=16,
              enc_n_layers=1, dec_channels=(16, 16), dec_num_mid_blocks=1, dec_num_heads=1,
              dec_attention_head_dim=16, dec_dropout=0.3)
    torch.manual_seed(0)
    plain = MatchaTTS(**kw).to(cuda_f32)
    remat = MatchaTTS(**kw, remat=True).to(cuda_f32)
    remat.load_state_dict(plain.state_dict())
    g = torch.Generator().manual_seed(1)
    x = torch.randint(1, 100, (2, 12), generator=g).to(cuda_f32)
    x_lengths = torch.tensor([12, 9], device=cuda_f32)
    y = torch.randn(2, 40, 16, generator=g).to(cuda_f32)
    y_lengths = torch.tensor([40, 31], device=cuda_f32)
    grads = []
    for model in (plain, remat):
        model.train()
        torch.manual_seed(2)
        loss = sum(model.losses(x, x_lengths, y, y_lengths,
                                generator=torch.Generator(cuda_f32).manual_seed(3))[:3])
        loss.backward()
        grads.append({n: p.grad for n, p in model.named_parameters() if p.grad is not None})
    assert grads[0].keys() == grads[1].keys()
    for n in grads[0]:
        assert (grads[0][n] - grads[1][n]).abs().max().item() <= 1e-6, n


def _tiny_matcha_and_vocoder(device):
    """A small Matcha and a two-stage HiFi-GAN (hop 8), seed weights."""
    from matcha_tpu_torch.models.matcha import MatchaTTS

    torch.manual_seed(11)
    model = MatchaTTS(enc_n_channels=32, enc_filter_channels=64, enc_filter_channels_dp=32,
                      enc_n_layers=2, dec_channels=(32, 32), dec_attention_head_dim=16,
                      dec_num_heads=2).to(device).eval()
    vocoder = Generator(HiFiGANConfig(upsample_rates=(4, 2), upsample_kernel_sizes=(8, 4),
                                      upsample_initial_channel=32)).to(device).eval()
    return model, vocoder


@pytest.mark.cuda
@pytest.mark.parametrize("with_vocoder", [False, True], ids=["mel", "wav"])
def test_exported_artifact_on_cuda_matches_eager_wrapper(cuda_f32, tmp_path, with_vocoder):
    """``deploy/export.py`` on the card: the artifact, saved and reloaded,
    against the un-exported wrapper on the same z: lengths EQUAL, the mel
    or the wav within 1e-5 (the same kernels; cuDNN may pick another
    algorithm in the exported graph)."""
    from matcha_tpu_torch.deploy.export import export_graph, get_exportable_fn

    model, vocoder = _tiny_matcha_and_vocoder(cuda_f32)
    voc = vocoder if with_vocoder else None
    path = str(tmp_path / "a.pt2")
    export_graph(model, path, 2, 48, 128, 2, voc)
    module = torch.export.load(path).module()
    g = torch.Generator().manual_seed(3)
    x = torch.randint(1, 178, (2, 48), generator=g).to(cuda_f32)
    xl = torch.tensor([48, 30]).to(cuda_f32)
    scales = torch.tensor([0.667, 1.0]).to(cuda_f32)
    z = torch.randn(2, 128, 80, generator=g).to(cuda_f32)
    got, got_len = module(x, xl, scales, z)
    with torch.no_grad():
        want, want_len = get_exportable_fn(model, voc, 2, 128)(x, xl, scales, z)
    assert got.device.type == "cuda" and torch.equal(got_len, want_len)
    assert (got - want).abs().max().item() <= 1e-5


@pytest.mark.cuda
def test_eval_step_mas_kernel_equals_plain(cuda_f32, monkeypatch):
    """``trainer.eval_step`` on the card launches K2 once, and its path on
    the step's own log-prior is EQUAL to the plain version's."""
    from matcha_tpu_torch.models import matcha as matcha_mod
    from matcha_tpu_torch.training.trainer import eval_step

    model, _ = _tiny_matcha_and_vocoder(cuda_f32)
    seen = []
    real = matcha_mod.maximum_path
    monkeypatch.setattr(matcha_mod, "maximum_path",
                        lambda v, m: seen.append((v, m, real(v, m))) or seen[-1][2])
    g = torch.Generator().manual_seed(4)
    B, T_x, T_y = 3, 40, 150
    batch = {"x": torch.randint(1, 178, (B, T_x), generator=g),
             "x_lengths": torch.tensor([40, 33, 12]),
             "y": torch.randn(B, T_y, 80, generator=g),
             "y_lengths": torch.tensor([150, 120, 61])}
    batch = {k: v.to(cuda_f32) for k, v in batch.items()}
    before = mas.LAUNCHES["maximum_path"]
    metrics = eval_step(model, batch)
    torch.cuda.synchronize()
    assert mas.LAUNCHES["maximum_path"] == before + 1 and len(seen) == 1
    value, mask, path = seen[0]
    assert torch.equal(path, mas.maximum_path_reference(value, mask))
    assert all(torch.isfinite(v) for v in metrics.values())


@pytest.mark.cuda
def test_ddp_nccl_world_one_step_equals_plain(cuda_f32, tmp_path):
    """Three steps of a small Matcha through ``DistributedDataParallel`` over
    NCCL at world size 1 (the global-batch scaling is exactly 1, the noise
    drawn at the batch's own shape) against the plain step on the same
    batches and seed: the losses within 1e-6 and the weights within 1e-6
    after each step, but for at most 1e-4 of them, which Adam may move by
    up to 2 lr where a gradient is near zero (cuDNN's backward may sum in
    another order); K2 once per step and path."""
    from matcha_tpu_torch.models.matcha import MatchaTTS
    from matcha_tpu_torch.parallel import dist
    from matcha_tpu_torch.training import trainer as T

    torch.manual_seed(5)
    kw = dict(enc_n_channels=32, enc_filter_channels=64, enc_filter_channels_dp=32,
              enc_n_heads=2, enc_n_layers=2, dec_channels=(32, 32), dec_attention_head_dim=16,
              dec_num_heads=2)
    plain, ddp_model = MatchaTTS(**kw).to(cuda_f32), MatchaTTS(**kw).to(cuda_f32)
    ddp_model.load_state_dict(plain.state_dict())
    g = torch.Generator().manual_seed(6)
    B, T_x, T_y = 4, 48, 192
    xl = torch.tensor([48, 31, 40, 22], dtype=torch.int32)
    yl = torch.tensor([192, 120, 160, 90], dtype=torch.int32)
    batch = {"x": torch.randint(1, 178, (B, T_x), generator=g), "x_lengths": xl,
             "y": torch.randn(B, T_y, 80, generator=g), "y_lengths": yl}
    for i in range(B):
        batch["x"][i, xl[i]:] = 0
        batch["y"][i, yl[i]:] = 0
    torch.cuda.set_device(0)
    dist.initialize("nccl", f"file://{tmp_path / 'store'}", 0, 1)
    try:
        wrapped = T.make_ddp(ddp_model, cuda_f32)
        opts = [T.make_optimizer(m, lr=1e-3) for m in (plain, ddp_model)]
        before = mas.LAUNCHES["maximum_path"]
        for step in range(3):
            a = T.train_step(plain, *opts[0], T.to_device(batch, cuda_f32), step, 7)
            host, share = T.share_batch({**batch, "rows": torch.tensor([0, B, 1])})
            b = T.train_step(ddp_model, *opts[1], T.to_device(host, cuda_f32), step, 7,
                             ddp=wrapped, share=share)
            for k in a:
                assert abs(float(a[k]) - float(b[k])) <= 1e-6 * abs(float(a[k])), k
            n = far = 0
            for (k, p), q in zip(plain.named_parameters(), ddp_model.parameters()):
                d = (p - q).abs()
                assert d.max().item() <= 2e-3 + 1e-6, k  # Adam: at most a flipped update
                n, far = n + d.numel(), far + int((d > 1e-6).sum())
            assert far <= 1e-4 * n, (far, n)
        assert mas.LAUNCHES["maximum_path"] - before == 6
    finally:
        dist.destroy()


@pytest.mark.cuda
def test_replica_pipeline_k1_matches_plain(cuda_f32, monkeypatch):
    """``TTSPipeline(devices=[cuda:0, cuda:0])`` at B = 2: K1 launches twice
    per replica chunk, and the waveform is the one the same replicas give
    with each stage on K1's plain version (within 1e-5), and the
    one-device pipeline's (lengths equal, within 1e-5)."""
    from matcha_tpu_torch.models import hifigan_fused

    d0 = torch.device("cuda", 0)
    two = _tiny_pipeline(d0, devices=[d0, d0])
    one = _tiny_pipeline(d0)
    x = torch.randint(1, 178, (2, 40), generator=torch.Generator().manual_seed(1)).numpy()
    xl = torch.tensor([40, 29], dtype=torch.int32).numpy()
    x[1, 29:] = 0
    before = mrf.LAUNCHES["mrf_stage"]
    got = two.synthesise_batch(x, xl, n_timesteps=2, generator=torch.Generator(d0).manual_seed(2))
    assert mrf.LAUNCHES["mrf_stage"] - before == 4
    want = one.synthesise_batch(x, xl, n_timesteps=2, generator=torch.Generator(d0).manual_seed(2))
    monkeypatch.setattr(hifigan_fused, "fused_mrf_stage",
                        lambda x, w, ks, dils, t_tile=None, compute_dtype=torch.float32:
                        mrf.fused_mrf_stage_reference(x, w, ks, dils, compute_dtype))
    plain = two.synthesise_batch(x, xl, n_timesteps=2,
                                 generator=torch.Generator(d0).manual_seed(2))
    assert torch.equal(got["mel_lengths"], want["mel_lengths"])
    assert torch.equal(got["mel_lengths"], plain["mel_lengths"])
    assert (got["waveform"] - plain["waveform"]).abs().max().item() <= 1e-5
    assert (got["waveform"] - want["waveform"]).abs().max().item() <= 1e-5


@pytest.fixture()
def traced():
    """The port's tracing on, on an empty ring, for one test."""
    from matcha_tpu_torch.utils import tracing

    tracing.reset()
    tracing.enable()
    yield tracing
    tracing.disable()
    tracing.reset()


@pytest.mark.cuda
def test_fused_graph_capture_with_tracing_on(cuda_f32, traced):
    """A capture and a replay with tracing on: the same results as the
    eager body, one ``pipeline.capture`` span, a ``pipeline.replay`` per
    graph call; the vocoder's spans come from the capture's eager warm-up
    and the eager call only, none from the pass the graph captured."""
    pipe = _tiny_pipeline(cuda_f32)
    x, xl = _ids(1, 40)
    z = _unit_noise(2, 256, cuda_f32)
    got = pipe.synthesise_batch(x, xl, n_timesteps=2, z=z, fixed_y_bucket=256)
    again = pipe.synthesise_batch(x, xl, n_timesteps=2, z=z, fixed_y_bucket=256)
    want = pipe.synthesise_batch(x, xl, n_timesteps=2, z=z, fixed_y_bucket=256, cuda_graph=False)
    torch.cuda.synchronize()
    spans = traced.spans()
    names = [s.name for s in spans]
    assert names.count("pipeline.capture") == 1 and names.count("pipeline.replay") == 2
    assert set(names) == {"pipeline.capture", "pipeline.replay", "pipeline.stage_inputs",
                          "pipeline.synthesise_batch", "models.vocode", "models.denoise"}
    (cap,) = [s for s in spans if s.name == "pipeline.capture"]
    assert cap.attrs == {"graph": "fused", "shapes": "B, T_x = (1, 64), T_y = 256"}
    eager = max((s for s in spans if s.name == "pipeline.synthesise_batch"), key=lambda s: s.t0_ns)
    vocode = [s for s in spans if s.name == "models.vocode"]
    assert sorted(s.parent for s in vocode) == sorted([cap.sid, eager.sid])
    for out in (got, again):
        assert torch.equal(out["mel_lengths"], want["mel_lengths"])
        assert (out["waveform"] - want["waveform"]).abs().max().item() <= 1e-5


@pytest.mark.cuda
def test_program_span_lands_over_its_kernel_in_the_trace(cuda_f32, traced):
    """A program span around ``torch.cuda._sleep`` and its synchronise,
    read on the clock of a ``torch.profiler`` trace tied to the host's by
    the benchmark's marker kernel (``benchmark/harness/trace.py``): the
    spin kernel starts and ends within 0.1 ms of the span."""
    import time

    from benchmark.harness import trace

    torch.cuda._sleep(1000)  # the spin kernel's first launch, outside the trace
    torch.cuda.synchronize()
    with trace.Trace() as tr:
        tr.mark_start(time.perf_counter())
        with traced.span("probe"):
            torch.cuda._sleep(2_000_000)  # about a millisecond
            torch.cuda.synchronize()
        tr.mark_end(time.perf_counter())
    (probe,) = traced.spans()
    spins = sorted((e for e in tr.prof.profiler.kineto_results.events()
                    if "spin_kernel" in e.name()), key=lambda e: e.start_ns())
    assert len(spins) == 2  # the trace's marker, then the probe's kernel
    offset_ns = spins[0].start_ns() - tr.t_mark * 1e9  # as Trace.device_events ties them
    k0 = spins[1].start_ns() - offset_ns
    k1 = k0 + spins[1].duration_ns()
    assert spins[1].duration_ns() > 5e5
    assert abs(k0 - probe.t0_ns) <= 1e5 and abs(k1 - probe.t1_ns) <= 1e5, (
        k0 - probe.t0_ns, k1 - probe.t1_ns)


# --------------------------------------------------------------------------
# K4: BigVGAN's anti-aliased SnakeBeta (ops/aa_snake.py, csrc/aa_snake.cu)

#: K4 against the plain sequence (cuDNN's depthwise convs, TF32 off), as a
#: share of the plain output's largest magnitude: the sums run in another
#: order, and a rounding of the snake's argument u e^alpha (up to ~50 here)
#: by one ulp moves sin^2 by ~1e-5 of the output's scale at most; a bf16
#: instance of the same arithmetic errs by ~4e-3
K4_TOL = 1e-4
#: (B, C, L) of the published BigVGAN's six stages and activation_post at
#: 128 mel frames and B = 8, and odd lengths, where the clamps at both ends
#: and a partial last tile decide
K4_SHAPES = [(8, 768, 512), (8, 384, 2048), (8, 192, 4096), (8, 96, 8192), (8, 48, 16384),
             (8, 24, 32768), (1, 3, 1), (2, 5, 2), (1, 7, 3), (3, 16, 511), (2, 8, 513),
             (1, 4, 1025)]


def _k4_problem(seed, B, C, L, device):
    from matcha_tpu_torch.ops import aa_snake

    g = torch.Generator().manual_seed(seed)
    x = torch.randn(B, C, L, generator=g).to(device)
    freq, inv_mag = aa_snake.snake_terms((0.5 * torch.randn(C, generator=g)).to(device),
                                         (0.5 * torch.randn(C, generator=g)).to(device))
    return x, freq, inv_mag, aa_snake.kaiser_sinc_filter().to(device)


@pytest.mark.cuda
@pytest.mark.parametrize("B,C,L", K4_SHAPES)
def test_aa_snake_kernel_matches_plain(cuda_f32, B, C, L):
    from matcha_tpu_torch.ops import aa_snake

    x, freq, inv_mag, h = _k4_problem(B * C + L, B, C, L, cuda_f32)
    before = aa_snake.LAUNCHES["aa_snake"]
    got = aa_snake.aa_snake(x, freq, inv_mag, h)
    want = aa_snake.aa_snake(x, freq, inv_mag, h, fused=False)
    torch.cuda.synchronize()
    assert aa_snake.LAUNCHES["aa_snake"] == before + 1
    scale = want.abs().max().item()
    assert (got - want).abs().max().item() <= K4_TOL * scale
    # the same arithmetic on bf16-rounded input misses the tolerance
    rounded = aa_snake.aa_snake(x.bfloat16().float(), freq, inv_mag, h)
    if L > 2:
        assert (rounded - want).abs().max().item() > K4_TOL * scale


@pytest.mark.cuda
def test_aa_snake_kernel_refuses_what_it_cannot_take(cuda_f32):
    from matcha_tpu_torch.ops import aa_snake

    x, freq, inv_mag, h = _k4_problem(1, 1, 4, 64, cuda_f32)
    with pytest.raises(ValueError):
        aa_snake.aa_snake(x.double(), freq.double(), inv_mag.double(), h.double())
    with pytest.raises(ValueError):
        aa_snake.aa_snake(x[..., ::2], freq, inv_mag, h)
    with pytest.raises(ValueError):
        aa_snake.aa_snake(x, freq[:3], inv_mag, h)
    with pytest.raises(ValueError):
        aa_snake.aa_snake(x, freq.cpu(), inv_mag, h)


def _small_bigvgan(device):
    from matcha_tpu_torch.models.bigvgan import BigVGANConfig
    from matcha_tpu_torch.models.bigvgan import Generator as BigVGAN

    torch.manual_seed(4)
    gen = BigVGAN(BigVGANConfig(upsample_initial_channel=64, upsample_rates=(4, 4, 2),
                                upsample_kernel_sizes=(8, 8, 4)))
    with torch.no_grad():
        for a in gen.activations():
            a.act.alpha.normal_(0.0, 0.5)
            a.act.beta.normal_(0.0, 0.5)
    return gen.to(device).eval()


@pytest.mark.cuda
def test_bigvgan_generator_launches_k4_per_activation(cuda_f32):
    """3 stages x 18 + 1 launches a call; the output within 1e-4 of the
    plain generator's (the clamp's range)."""
    from matcha_tpu_torch.ops import aa_snake

    gen = _small_bigvgan(cuda_f32).prepare()
    mel = torch.randn(2, 50, 80, generator=torch.Generator().manual_seed(6)).to(cuda_f32)
    before = aa_snake.LAUNCHES["aa_snake"]
    got = gen(mel)
    torch.cuda.synchronize()
    assert aa_snake.LAUNCHES["aa_snake"] - before == 3 * 18 + 1
    want = gen(mel, fused=False)
    assert aa_snake.LAUNCHES["aa_snake"] - before == 3 * 18 + 1
    assert got.shape == (2, 50 * 32, 1)
    assert (got - want).abs().max().item() <= 1e-4


@pytest.mark.cuda
def test_bigvgan_in_a_captured_cuda_graph(cuda_f32):
    """The generator captured as a CUDA graph (K4 launches on the capture
    stream, the snake terms computed before the capture): a replay on new
    input equals the eager call, and launches nothing the counter sees."""
    from matcha_tpu_torch.ops import aa_snake

    gen = _small_bigvgan(cuda_f32).prepare()
    g = torch.Generator().manual_seed(7)
    static = torch.randn(1, 40, 80, generator=g).to(cuda_f32)
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        gen(static)  # warm-up on the capture stream
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    before = aa_snake.LAUNCHES["aa_snake"]
    with torch.cuda.graph(graph):
        out = gen(static)
    assert aa_snake.LAUNCHES["aa_snake"] - before == 3 * 18 + 1
    new = torch.randn(1, 40, 80, generator=g).to(cuda_f32)
    static.copy_(new)
    graph.replay()
    torch.cuda.synchronize()
    assert aa_snake.LAUNCHES["aa_snake"] - before == 3 * 18 + 1
    assert (out - gen(new)).abs().max().item() <= 1e-6


@pytest.mark.cuda
def test_bigvgan_pipeline_paths_on_cuda(cuda_f32):
    """``TTSPipeline`` with the small BigVGAN: the split corpus path (K4
    per activation), the fused stage as CUDA graphs and the fixed-bucket
    graph against the plain generator (``vocoder_pallas=False``) on the
    same noise."""
    from matcha_tpu_torch.pipeline import TTSPipeline
    from matcha_tpu_torch.models.matcha import MatchaTTS
    from matcha_tpu_torch.ops import aa_snake

    torch.manual_seed(3)
    model = MatchaTTS(enc_n_channels=32, enc_filter_channels=64, enc_filter_channels_dp=32,
                      enc_n_heads=2, enc_n_layers=2, dec_channels=(32, 32),
                      dec_attention_head_dim=16, dec_num_heads=2)
    gen = _small_bigvgan(cuda_f32)
    pipe, plain = (TTSPipeline(model, gen, None, device=cuda_f32, vocoder_pallas=p)
                   for p in (True, False))
    utts = _corpus(13, 5)

    def corpus(p, fuse):
        return list(p.synthesise_corpus(utts, n_timesteps=2, batch_size=2, fuse_stages=fuse,
                                        generator=torch.Generator(cuda_f32).manual_seed(5)))

    want = corpus(plain, False)
    before = aa_snake.LAUNCHES["aa_snake"]
    split = corpus(pipe, False)
    assert aa_snake.LAUNCHES["aa_snake"] - before == (3 * 18 + 1) * len(want)
    fused = corpus(pipe, True)
    for outs in (split, fused):
        for (_, a), (_, b) in zip(outs, want):
            assert (a["mel_lengths_host"] == b["mel_lengths_host"]).all()
            assert (a["waveform"] - b["waveform"]).abs().max().item() <= 1e-4
    x, xl = _ids(1, 40)
    z = torch.randn(1, 256, 80, generator=torch.Generator().manual_seed(2)).to(cuda_f32)
    got = pipe.synthesise_batch(x, xl, n_timesteps=2, z=z, fixed_y_bucket=256)
    ref = plain.synthesise_batch(x, xl, n_timesteps=2, z=z, fixed_y_bucket=256, cuda_graph=False)
    assert (got["waveform"] - ref["waveform"]).abs().max().item() <= 1e-4
