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
from matcha_tpu_torch.ops import mas, mrf, mrf_phase

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


def _tiny_pipeline(device):
    """A small Matcha (seed weights) with the full-width HiFi-GAN v1 and its
    denoiser, so that the fixed-bucket body runs K1 twice."""
    from matcha_tpu_torch.cli import TTSPipeline
    from matcha_tpu_torch.models.denoiser import compute_bias_spec
    from matcha_tpu_torch.models.matcha import MatchaTTS

    torch.manual_seed(3)
    model = MatchaTTS(enc_n_channels=32, enc_filter_channels=64, enc_filter_channels_dp=32,
                      enc_n_heads=2, enc_n_layers=2, dec_channels=(32, 32),
                      dec_attention_head_dim=16, dec_num_heads=2)
    vocoder = Generator(HiFiGANConfig()).to(device).eval()
    bias = compute_bias_spec(lambda m: generator_apply_fused(vocoder, m), device=device)
    return TTSPipeline(model, vocoder, bias, device=device)


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
