"""The split corpus path's decode graph on the CPU: ``MatchaTTS.align``
then ``MatchaTTS.flow`` is ``decode``, the eager body of
``fused.py::DecodeGraph`` is ``decode``'s flow, and ``synthesise_corpus``'s
split path (the alignment eagerly, the flow through one ``DecodeGraph``
per (B, T_y), the vocoder eagerly) gives what a direct ``decode`` and
``vocode`` per batch give, bit for bit, on a generator seeded alike.

The models are tiny and seeded (no JAX): a single-speaker Matcha and a
4-speaker one, each with a tiny HiFi-GAN; 2 Euler steps.
"""

import numpy as np
import pytest
import torch

from matcha_tpu_torch import pipeline as port_pipeline
from matcha_tpu_torch.models.hifigan import Generator, HiFiGANConfig
from matcha_tpu_torch.models.matcha import MatchaTTS

MODEL = dict(n_vocab=20, n_feats=8, enc_n_channels=16, enc_filter_channels=24,
             enc_filter_channels_dp=12, enc_n_heads=2, enc_n_layers=2, dec_channels=(16, 16),
             dec_num_mid_blocks=1, dec_num_heads=1, dec_attention_head_dim=8,
             enc_p_dropout=0.0, dec_dropout=0.0, spk_emb_dim=8)
VOC = dict(upsample_rates=(4, 2), upsample_kernel_sizes=(8, 4), upsample_initial_channel=16,
           resblock_kernel_sizes=(3,), resblock_dilation_sizes=((1, 2),), num_mels=8)
STEPS, TEMPERATURE = 2, 0.667
DECODE_KEYS = ("encoder_outputs", "decoder_outputs", "attn", "mel", "mel_lengths")
# sorted into batches of 2: x buckets 32, 32, 64, 64 and 96, so that one
# mel bucket serves two x buckets
LENGTHS = (60, 5, 36, 12, 70, 8, 28, 45, 20)


@pytest.fixture(scope="module", params=[1, 4], ids=["single", "multi"])
def model(request):
    torch.manual_seed(0)
    return MatchaTTS(**MODEL, n_spks=request.param).eval()


@pytest.fixture(scope="module")
def vocoder():
    torch.manual_seed(1)
    return Generator(HiFiGANConfig(**VOC)).eval()


def _encoded(model):
    """A batch of 3 encoded (one row clipped at the mel bucket of 32):
    (x_lengths, speaker ids or None, mu_x, w_ceil, y_lengths)."""
    g = torch.Generator().manual_seed(1)
    xl = torch.tensor([24, 17, 9], dtype=torch.int32)
    x = torch.randint(1, MODEL["n_vocab"], (3, 24), generator=g)
    x = x * (torch.arange(24)[None, :] < xl[:, None])
    spks = torch.tensor([0, 3, 1]) if model.n_spks > 1 else None
    return (xl, spks, *model.encode(x, xl, 1.0, spks))


def test_align_then_flow_equals_decode(model):
    xl, spks, mu_x, w_ceil, y_lengths = _encoded(model)
    T_y = 32
    assert int(y_lengths.max()) > T_y  # a row is clipped
    want = model.decode(mu_x, w_ceil, xl, y_lengths, STEPS, TEMPERATURE, y_max_length=T_y,
                        generator=torch.Generator().manual_seed(3), spks=spks)
    with torch.inference_mode():
        attn, mu_y, y_mask, y_clip = model.align(mu_x, w_ceil, xl, y_lengths, T_y)
        decoder_outputs, mel = model.flow(mu_y, y_mask, STEPS, TEMPERATURE,
                                          generator=torch.Generator().manual_seed(3),
                                          spk_emb=model._speaker(spks))
    got = dict(zip(DECODE_KEYS, (mu_y.transpose(1, 2), decoder_outputs, attn, mel, y_clip)))
    assert y_clip.dtype == torch.int32 and int(y_clip.max()) == T_y
    assert y_mask.shape == (3, T_y, 1)
    for k in DECODE_KEYS:
        assert torch.equal(got[k], want[k]), k


@pytest.mark.parametrize("noise", ["generator", "z"])
def test_decode_graph_body_equals_decode(model, noise):
    """The eager body (a CUDA graph's plain version) on ``align``'s
    outputs against ``model.decode`` on the same noise: drawn from a
    generator into the static buffer, or handed in."""
    xl, spks, mu_x, w_ceil, y_lengths = _encoded(model)
    T_y = 32
    pipe = port_pipeline.TTSPipeline(model, device="cpu")
    graph = pipe.decode_graph(3, T_y, STEPS, TEMPERATURE, has_spk=spks is not None)
    assert not graph.cuda_graph and graph.calls == 0
    z = torch.randn(3, T_y, MODEL["n_feats"], generator=torch.Generator().manual_seed(4))
    kw = dict(generator=torch.Generator().manual_seed(3)) if noise == "generator" else dict(z=z)
    want = model.decode(mu_x, w_ceil, xl, y_lengths, STEPS, TEMPERATURE, y_max_length=T_y,
                        spks=spks, **kw)
    with torch.inference_mode():
        _, mu_y, y_mask, _ = model.align(mu_x, w_ceil, xl, y_lengths, T_y)
    kw = dict(generator=torch.Generator().manual_seed(3)) if noise == "generator" else dict(z=z)
    got = graph(mu_y, y_mask, spks=None if spks is None else spks.numpy(), **kw)
    assert graph.calls == 1 and graph.graph is None and graph.replays == 0
    assert set(got) == {"decoder_outputs", "mel"}
    for k in got:
        assert torch.equal(got[k], want[k]), k
    assert pipe.decode_graph(3, T_y, STEPS, TEMPERATURE, has_spk=spks is not None) is graph


def _utterances():
    rng = np.random.default_rng(7)
    return [rng.integers(1, MODEL["n_vocab"], size=n).astype(np.int32) for n in LENGTHS]


def _split_corpus(pipe, spk, seed=5):
    return list(pipe.synthesise_corpus(_utterances(), n_timesteps=STEPS, temperature=TEMPERATURE,
                                       batch_size=2, stage_window=3, spk=spk,
                                       generator=torch.Generator().manual_seed(seed)))


def _spk(model):
    return 2 if model.n_spks > 1 else None


def test_split_corpus_equals_direct_decode(model, vocoder):
    """Each batch of the split path against the encoder, ``model.decode``
    and ``vocode`` run directly on the same sorted batch, the noise drawn
    batch after batch from one generator seeded alike: every output equal."""
    pipe = port_pipeline.TTSPipeline(model, vocoder, device="cpu")
    spk = _spk(model)
    got = _split_corpus(pipe, spk)
    utts = _utterances()
    order = sorted(range(len(utts)), key=lambda i: len(utts[i]))
    gen = torch.Generator().manual_seed(5)
    assert len(got) == 5
    with torch.inference_mode():
        for bi, (chunk, out) in enumerate(got):
            assert chunk == order[2 * bi:2 * bi + 2]
            T_x = port_pipeline.pick_bucket(max(len(utts[i]) for i in chunk), port_pipeline.X_BUCKETS)
            x = torch.zeros((len(chunk), T_x), dtype=torch.int64)
            for row, i in enumerate(chunk):
                x[row, :len(utts[i])] = torch.from_numpy(utts[i])
            xl = torch.tensor([len(utts[i]) for i in chunk], dtype=torch.int32)
            spks = None if spk is None else torch.full((len(chunk),), spk)
            mu_x, w_ceil, y_lengths = model.encode(x, xl, 1.0, spks)
            max_y = int(y_lengths.max())
            T_y = port_pipeline.pick_bucket(max_y, port_pipeline.Y_BUCKETS)
            T_voc = min(T_y, port_pipeline.pick_bucket(min(max_y, T_y), port_pipeline.VOC_BUCKETS))
            want = model.decode(mu_x, w_ceil, xl, y_lengths, STEPS, TEMPERATURE, y_max_length=T_y,
                                generator=gen, spks=spks)
            want["waveform"] = pipe.vocode(want["mel"].transpose(1, 2)[:, :T_voc])
            for k in DECODE_KEYS + ("waveform",):
                assert torch.equal(out[k], want[k]), (bi, k)
            np.testing.assert_array_equal(out["mel_lengths_host"], want["mel_lengths"].numpy())


def test_one_decode_graph_per_batch_and_mel_bucket(model, vocoder):
    """``_graphs`` holds one decode body per distinct (B, T_y), none per x
    or vocoder bucket; each batch counts one capture (its key new) or one
    replay, and a second pass only replays."""
    pipe = port_pipeline.TTSPipeline(model, vocoder, device="cpu")
    spk = _spk(model)
    outs = _split_corpus(pipe, spk)
    keys = {(len(c), o["mel"].shape[-1]) for c, o in outs}
    by_x = {(len(c), o["attn"].shape[1], o["mel"].shape[-1]) for c, o in outs}
    assert len(by_x) > len(keys)  # a mel bucket reached from two x buckets
    want = {("decode", B, T_y, STEPS, TEMPERATURE, spk is not None, None) for B, T_y in keys}
    assert set(pipe._graphs) == want
    assert sum(g.calls for g in pipe._graphs.values()) == len(outs)
    assert pipe.corpus_decode_captures == len(keys)
    assert pipe.corpus_decode_captures + pipe.corpus_decode_replays == len(outs)
    again = _split_corpus(pipe, spk, seed=6)
    assert set(pipe._graphs) == want and len(again) == len(outs)
    assert pipe.corpus_decode_captures == len(keys)
    assert pipe.corpus_decode_replays == 2 * len(outs) - len(keys)
    assert pipe.corpus_frames_decoded == 2 * sum(B * T_y for B, T_y in
                                                 ((len(c), o["mel"].shape[-1]) for c, o in outs))


def test_fused_stage_counts_no_decode_graph(model, vocoder):
    """``fuse_stages=True`` runs the stage body: no decode body is built
    and the decode counters stay at 0."""
    pipe = port_pipeline.TTSPipeline(model, vocoder, device="cpu")
    outs = list(pipe.synthesise_corpus(_utterances()[:4], n_timesteps=1, batch_size=2,
                                       fuse_stages=True, spk=_spk(model),
                                       generator=torch.Generator().manual_seed(1)))
    assert len(outs) == 2 and all(k[0] == "stage" for k in pipe._graphs)
    assert pipe.corpus_decode_captures == pipe.corpus_decode_replays == 0
