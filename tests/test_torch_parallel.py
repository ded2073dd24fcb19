"""The port's data axis (``parallel/mesh.py``, ``parallel/dist.py``), its
global-batch losses and its data-parallel serving, on the CPU, against
the JAX package where JAX has the counterpart.

* the node shard against JAX's ``_process_shard`` (``jax.process_index``
  and ``jax.process_count`` patched) and the gcd rule against the data
  axis of JAX's ``Trainer`` on the 8 virtual CPU devices;
* the global-batch loss scaling (``trainer.share_batch``) on two parts of
  unequal lengths, the ranks emulated in one process: the scaled losses
  sum to the whole batch's, their mean gradient is the whole batch's;
* ``TTSPipeline(devices=["cpu", "cpu"])`` against ``device="cpu"`` on the
  dynamic path at B = 2, 3 (3 does not divide: the first replica runs
  it), 4, the fixed-bucket path and ``synthesise_corpus`` (split and
  staged): lengths equal, outputs within 1e-5. Not bit-equal where the
  batch splits: a part runs the CPU's convs and products on fewer rows,
  which round differently (measured: the mel within 9.6e-7, the waveform
  within 1.4e-6, the alignment equal); bit-equal at B = 3. And the
  replicas against JAX's pipeline at B = 2;
* ``--data-parallel`` in the CLI, a no-op with one device, and the daemon
  serving from two replicas.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from matcha_tpu import cli as jax_cli
from matcha_tpu.models.hifigan import Generator as JaxGenerator
from matcha_tpu.models.hifigan import HiFiGANConfig as JaxHiFiGANConfig
from matcha_tpu.training import data as jax_data
from matcha_tpu.training import trainer as jax_trainer
from matcha_tpu_torch import cli as port_cli
from matcha_tpu_torch import pipeline as port_pipeline
from matcha_tpu_torch import serve
from matcha_tpu_torch.convert import hifigan_state_dict
from matcha_tpu_torch.models.hifigan import Generator, HiFiGANConfig
from matcha_tpu_torch.parallel import dist, mesh
from matcha_tpu_torch.training import trainer as port_trainer
from matcha_tpu_torch.training.data import TextMelDataModule
from matcha_tpu_torch.utils.utils import PCM24_SCALE, unpack_pcm24
from tests.test_cli_e2e import fabricated_ckpts  # noqa: F401  (module fixture)
from tests.test_convert import TINY
from tests.test_torch_losses import jax_noise, tiny_pair

torch.set_num_threads(2)

CLEANER = "english_cleaners_no_espeak"
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-7
SERVE_ATOL = 1e-5
VOC = dict(upsample_rates=(4, 2), upsample_kernel_sizes=(8, 4), upsample_initial_channel=16,
           resblock_kernel_sizes=(3,), resblock_dilation_sizes=((1, 2),),
           num_mels=TINY["n_feats"])


@pytest.fixture()
def topology(monkeypatch):
    """Set the port's process topology without a process group."""

    def set_(**kw):
        world = kw.get("world_size", 1)
        local_world = kw.get("local_world_size", 1)
        monkeypatch.setattr(dist, "_topology", {
            "rank": kw.get("rank", 0), "world_size": world,
            "local_rank": kw.get("local_rank", 0), "local_world_size": local_world,
            "node_rank": kw.get("rank", 0) // local_world, "n_nodes": world // local_world})
    return set_


# ---------------------------------------------------------------------------
# the node shard, the gcd rule, the splits
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n,nodes", [(10, 1), (10, 3), (7, 2), (5, 4)])
def test_node_shard_matches_jax(monkeypatch, topology, n, nodes):
    """Node i of N reads JAX process i's items: n // N each, the remainder
    dropped."""
    for pid in range(nodes):
        monkeypatch.setattr(jax, "process_index", lambda pid=pid: pid)
        monkeypatch.setattr(jax, "process_count", lambda: nodes)
        want = jax_data.TextMelDataModule._process_shard(None, n)
        topology(rank=pid, world_size=nodes)
        assert TextMelDataModule._process_shard(n) == want


@pytest.mark.parametrize("n_dev,bs", [(8, 32), (8, 6), (3, 32), (4, 2), (8, 3)])
def test_gcd_rule_matches_jax(n_dev, bs, tmp_path):
    """The data axis JAX's ``Trainer`` builds over ``devices=n_dev`` for a
    batch of ``bs`` (its gcd rule, idle devices included) is
    ``n_data_local``."""
    from matcha_tpu.models import MatchaTTS as JaxMatchaTTS

    t = jax_trainer.Trainer(JaxMatchaTTS(**TINY), types.SimpleNamespace(batch_size=bs),
                            devices=n_dev, output_dir=str(tmp_path), loggers={})
    assert mesh.n_data_local(n_dev, bs) == t.mesh.shape["data"]


@pytest.mark.parametrize("B,world,bs,want", [
    (8, 2, 8, [(0, 4, 1), (4, 8, 1)]),
    (6, 4, 6, [(0, 3, 1), (3, 6, 1), (0, 3, 0), (0, 3, 0)]),  # gcd(4, 6) = 2
    (3, 2, 3, [(0, 3, 1), (0, 3, 0)]),                        # gcd(2, 3) = 1
    (3, 2, 4, [(0, 2, 1), (2, 3, 1)]),                        # a short last batch of 3
    (1, 2, 4, [(0, 1, 1), (0, 1, 0)]),                        # an empty part: weight 0
])
def test_rank_rows(B, world, bs, want):
    assert [mesh.rank_rows(B, i, world, bs) for i in range(world)] == want


def test_split_helpers():
    assert mesh.split_bounds(7, 3) == [(0, 3), (3, 5), (5, 7)]
    assert mesh.replica_rows(6, 3) == [slice(0, 2), slice(2, 4), slice(4, 6)]
    assert mesh.replica_rows(5, 2) is None
    batch = {"x": np.arange(12).reshape(6, 2), "spks": None}
    np.testing.assert_array_equal(mesh.row_slice(batch, 1, 3)["x"], [[4, 5], [6, 7]])
    assert mesh.row_slice(batch, 0, 3)["spks"] is None
    with pytest.raises(ValueError):
        mesh.row_slice(batch["x"], 0, 4)
    assert mesh.is_trivial(["cpu"]) and not mesh.is_trivial(["cpu", "cpu"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            mesh.local_devices("all")


def test_dist_helpers_without_a_group(tmp_path):
    """Without a process group: rank 0 of 1, reductions return their input,
    a barrier returns, and nothing joins a group unless the environment
    says so."""
    assert not dist.is_initialized()
    assert (dist.rank(), dist.world_size(), dist.local_rank(), dist.local_world_size(),
            dist.node_rank(), dist.n_nodes()) == (0, 1, 0, 1, 0, 1)
    t = torch.ones(3)
    assert dist.all_reduce_sum(t) is t
    dist.barrier()
    assert dist.host_all_gather([4, 5]).tolist() == [[4, 5]]
    assert dist.maybe_initialize_distributed() is False and not dist.is_initialized()


@pytest.mark.parametrize("env,want", [
    ({"MATCHA_COORDINATOR_ADDRESS": "10.0.0.1:1234", "MATCHA_NUM_PROCESSES": "4",
      "MATCHA_PROCESS_ID": "2"}, ("gloo", "tcp://10.0.0.1:1234", 2, 4, 0, 1)),
    ({"MATCHA_DIST": "1", "RANK": "5", "WORLD_SIZE": "8", "LOCAL_RANK": "1",
      "LOCAL_WORLD_SIZE": "4"}, ("gloo", "env://", 5, 8, 1, 4)),
    ({"TORCHELASTIC_RUN_ID": "x", "RANK": "0", "WORLD_SIZE": "2", "LOCAL_RANK": "0",
      "LOCAL_WORLD_SIZE": "2"}, ("gloo", "env://", 0, 2, 0, 2)),
    ({}, None),
])
def test_env_contract(monkeypatch, env, want):
    """JAX's ``MATCHA_*`` variables (each process its own node) and
    torchrun's environment (``MATCHA_DIST=1`` or a torchrun launch) reach
    ``initialize`` as JAX's contract says; without them nothing joins,
    and ``train.main`` takes the launcher's group only when one is set."""
    from matcha_tpu_torch import train

    for k in ("MATCHA_COORDINATOR_ADDRESS", "MATCHA_NUM_PROCESSES", "MATCHA_PROCESS_ID",
              "MATCHA_DIST", "TORCHELASTIC_RUN_ID", "RANK", "WORLD_SIZE", "LOCAL_RANK",
              "LOCAL_WORLD_SIZE"):
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    seen = []
    monkeypatch.setattr(dist, "initialize", lambda *a: seen.append(a))
    joined = dist.maybe_initialize_distributed(backend="gloo")
    assert seen == ([want] if want else [])
    assert joined is (want is not None and want[3] > 1)
    assert train._launcher_env() is bool(env)


def test_train_main_starts_one_worker_per_selected_gpu(monkeypatch):
    """Without a launcher, ``train.main`` with ``trainer.devices`` selecting
    two GPUs starts one NCCL worker per selected GPU (``launch_local``,
    faked here: this host has no GPU) and returns rank 0's metric."""
    import json

    from matcha_tpu_torch import train

    for k in ("MATCHA_COORDINATOR_ADDRESS", "MATCHA_DIST", "TORCHELASTIC_RUN_ID"):
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setattr(train, "_selected_gpus",
                        lambda cfg: [torch.device("cuda", int(i)) for i in cfg.trainer.devices])
    seen = {}

    def launch(fn, args, nprocs, backend, store_dir, timeout_s=600.0, threads=None,
               cuda_devices=None):
        seen.update(fn=fn, nprocs=nprocs, backend=backend, cuda_devices=cuda_devices,
                    timeout_s=timeout_s)
        with open(args[1], "w", encoding="utf-8") as f:
            json.dump({"metric": 1.5}, f)

    monkeypatch.setattr(dist, "launch_local", launch)
    assert train.main(["trainer.devices=[2,3]"]) == 1.5
    assert seen == {"fn": train._worker, "nprocs": 2, "backend": "nccl", "cuda_devices": [2, 3],
                    "timeout_s": None}


# ---------------------------------------------------------------------------
# global-batch losses
# ---------------------------------------------------------------------------


def _parts_of(batch: dict, bounds):
    """Each part's rows cropped to its own longest row, with ``rows``."""
    parts = []
    for s, e in bounds:
        p = {k: v[s:e] for k, v in batch.items()}
        p["x"] = p["x"][:, :int(p["x_lengths"].max())]
        p["y"] = p["y"][:, :int(p["y_lengths"].max())]
        p["rows"] = np.asarray([s, e, 1], np.int64)
        parts.append(p)
    return parts


def _shares(monkeypatch, parts, out_size):
    """``share_batch`` of every part as the rank of that index, the
    all-gather answered from the parts' own values."""
    table = {}

    def record(rank):
        def gather(values):
            table[rank] = list(values)
            raise StopIteration
        return gather

    for r, p in enumerate(parts):
        monkeypatch.setattr(dist, "host_all_gather", record(r))
        with pytest.raises(StopIteration):
            port_trainer.share_batch(dict(p), out_size)
    every = torch.tensor([table[r] for r in range(len(parts))])
    monkeypatch.setattr(dist, "host_all_gather", lambda values: every)
    out = []
    for r, p in enumerate(parts):
        monkeypatch.setattr(dist, "rank", lambda r=r: r)
        out.append(port_trainer.share_batch(dict(p), out_size))
    return out


@pytest.mark.parametrize("out_size", [None, 32])
def test_global_batch_loss_scaling(monkeypatch, out_size):
    """Rows of unequal lengths split 1 + 3 over two emulated ranks: the
    parts padded back to the batch's shapes, each part's losses scaled by
    world x its denominator / the global one; their sum over the ranks /
    world is the whole batch's losses (which ``test_torch_losses.py``
    holds against JAX's), and the mean of their gradients (what DDP
    computes) is the whole batch's gradient."""
    from tests.test_torch_ddp import global_batch

    _, _, port = tiny_pair(prenet=False)
    batch = global_batch(4)
    noise = jax_noise(jax.random.PRNGKey(11), batch, out_size)
    whole = port_trainer.batch_losses(port, port_trainer.to_device(batch, "cpu"), out_size,
                                      noise=noise)
    sum(whole).backward()
    want_grads = {k: p.grad.clone() for k, p in port.named_parameters()}
    shares = _shares(monkeypatch, _parts_of(batch, [(0, 1), (1, 4)]), out_size)
    assert [s.n_rows for _, s in shares] == [1, 3] and shares[1][1].lo == 1
    total = torch.zeros(3)
    grads = {k: torch.zeros_like(g) for k, g in want_grads.items()}
    for part, share in shares:
        assert part["y"].shape[1:] == batch["y"].shape[1:]
        assert part["x"].shape[1] == batch["x"].shape[1]
        port.zero_grad()
        losses = port_trainer._global_losses(
            port_trainer.BatchLoss(port, out_size)(
                port_trainer.to_device(part, "cpu"), None,
                port_trainer.share_noise(share, part, out_size, None, noise)), share)
        sum(losses).backward()
        total += torch.stack([v.detach() for v in losses]) / 2
        for k, p in port.named_parameters():
            grads[k] += p.grad / 2
    np.testing.assert_allclose(total.numpy(), torch.stack(whole).detach().numpy(), rtol=1e-6)
    for k, g in want_grads.items():
        np.testing.assert_allclose(grads[k].numpy(), g.numpy(), rtol=GRAD_RTOL, atol=GRAD_ATOL,
                                   err_msg=k)


def test_global_noise_draws_what_one_process_draws():
    """``share_noise`` at world 1 draws the segment starts, t and z from the
    step's generator exactly as ``MatchaTTS.losses`` does: the step's
    losses equal the plain step's bit for bit."""
    from tests.test_torch_ddp import global_batch

    _, _, port = tiny_pair(prenet=False)
    batch = port_trainer.to_device(global_batch(3), "cpu")
    for out_size in (None, 32):
        share = port_trainer.Share(lo=0, n_global=3, n_rows=3, dur_scale=1.0, mel_scale=1.0,
                                   world=1)
        a = port_trainer.batch_losses(port, batch, out_size, torch.Generator().manual_seed(5))
        b = port_trainer.batch_losses(port, batch, out_size, None, port_trainer.share_noise(
            share, batch, out_size, torch.Generator().manual_seed(5)))
        assert [v.item() for v in a] == [v.item() for v in b]


# ---------------------------------------------------------------------------
# serving replicas
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def pipelines():
    """The JAX pipeline and the port's one-device and two-replica
    pipelines, on the same weights (the tiny Matcha, a tiny HiFi-GAN), no
    denoiser."""
    jm, variables, port = tiny_pair(prenet=True)
    jvoc = JaxGenerator(JaxHiFiGANConfig(**VOC))
    voc_params = jax.jit(jvoc.init)(jax.random.PRNGKey(2), jnp.zeros((1, 16, TINY["n_feats"])))
    pvoc = Generator(HiFiGANConfig(**VOC))
    pvoc.load_state_dict(hifigan_state_dict(voc_params))
    jax_pipe = jax_cli.TTSPipeline(jm, variables, jvoc, voc_params, None, CLEANER)
    one = port_pipeline.TTSPipeline(port.eval(), pvoc.eval(), None, CLEANER, device="cpu")
    two = port_pipeline.TTSPipeline(port, pvoc, None, CLEANER, devices=["cpu", "cpu"])
    return {"jax": jax_pipe, "one": one, "two": two}


def _ids(B: int, seed: int = 0):
    rng = np.random.default_rng(seed)
    xl = np.array([20, 13, 17, 9][:B], np.int32)
    x = rng.integers(1, TINY["n_vocab"], size=(B, 20)).astype(np.int32)
    for i in range(B):
        x[i, xl[i]:] = 0
    return x, xl


def _same(got: dict, want: dict, keys=("mel", "waveform")) -> None:
    """Lengths equal, the outputs within SERVE_ATOL."""
    np.testing.assert_array_equal(got["mel_lengths"].numpy(), want["mel_lengths"].numpy())
    for k in keys:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), atol=SERVE_ATOL, err_msg=k)


def test_replicas_hold_copies_on_their_devices(pipelines):
    two = pipelines["two"]
    assert [r.device for r in two.replicas] == [torch.device("cpu")] * 2
    a, b = (r.model for r in two.replicas)
    assert a is not b and all(torch.equal(p, q) for p, q in zip(a.parameters(),
                                                                  b.parameters()))
    two.denoiser_strength = 0.001
    two.capture_allowed = False
    assert [(r.denoiser_strength, r.capture_allowed) for r in two.replicas] == [(0.001, False)] * 2
    two.denoiser_strength, two.capture_allowed = 0.00025, True
    assert two._parts(4) == [(two, slice(0, 2)), (two.replicas[1], slice(2, 4))]
    assert two._parts(3) == [(two, slice(0, 3))]  # by rule: all on the first replica
    with pytest.raises(ValueError, match="devices="):
        port_pipeline.TTSPipeline(a, None, devices=[])


@pytest.mark.parametrize("B", [2, 3, 4])
def test_replicas_match_one_device_dynamic(pipelines, B):
    """The dynamic path on the same generator seed: the replicas draw the
    whole batch's noise on the first device and take their rows."""
    x, xl = _ids(B)
    kw = dict(n_timesteps=2, temperature=0.667)
    want = pipelines["one"].synthesise_batch(x, xl, generator=torch.Generator().manual_seed(3),
                                             **kw)
    got = pipelines["two"].synthesise_batch(x, xl, generator=torch.Generator().manual_seed(3),
                                            **kw)
    _same(got, want, ("mel", "waveform", "attn", "encoder_outputs"))
    packed = pipelines["two"].synthesise_batch(
        x, xl, generator=torch.Generator().manual_seed(3), pack_wav=True, **kw)["wav_pcm24"]
    wav, ml = unpack_pcm24(packed.numpy())
    np.testing.assert_array_equal(ml, want["mel_lengths"].numpy())
    np.testing.assert_allclose(wav, np.clip(want["waveform"].numpy(), -1, 1),
                               atol=SERVE_ATOL + 2.0 / PCM24_SCALE)


def test_replicas_match_one_device_fixed_bucket(pipelines):
    """The fixed-bucket body (eager on the CPU) per replica, over its rows,
    with the rows of one noise draw, and the ``"auto"`` bucket."""
    x, xl = _ids(4)
    for bucket in (128, "auto"):
        outs = [p.synthesise_batch(x, xl, n_timesteps=2, fixed_y_bucket=bucket,
                                   generator=torch.Generator().manual_seed(9))
                for p in (pipelines["one"], pipelines["two"])]
        _same(outs[1], outs[0])
        (wav1, ml1), (wav0, ml0) = (port_pipeline.fetch_fused_host(o) for o in outs[::-1])
        np.testing.assert_array_equal(ml1, ml0)
        np.testing.assert_allclose(wav1, wav0, atol=SERVE_ATOL + 2.0 / PCM24_SCALE)
    assert set(pipelines["two"].replicas[1]._graphs) and set(pipelines["two"]._graphs)


@pytest.mark.parametrize("fuse", [False, True], ids=["split", "staged"])
def test_replicas_match_one_device_corpus(pipelines, fuse):
    """``synthesise_corpus`` over 7 utterances in batches of 4 and 3 (the
    3 on the first replica), split stages or one body per replica."""
    rng = np.random.default_rng(4)
    utts = [rng.integers(1, TINY["n_vocab"], size=n) for n in (9, 20, 13, 17, 6, 11, 15)]
    kw = dict(n_timesteps=2, batch_size=4, fuse_stages=fuse, stage_window=2)
    got = list(pipelines["two"].synthesise_corpus(utts, generator=torch.Generator().manual_seed(1),
                                                  **kw))
    want = list(pipelines["one"].synthesise_corpus(
        utts, generator=torch.Generator().manual_seed(1), **kw))
    assert [c for c, _ in got] == [c for c, _ in want]
    for (_, g), (_, w) in zip(got, want):
        np.testing.assert_array_equal(g["mel_lengths_host"], w["mel_lengths_host"])
        _same(g, w)


def test_replicas_match_jax_pipeline(pipelines):
    """B = 2 split over the two replicas against JAX's pipeline on the same
    weights and noise: lengths equal, the mel within 1e-5, the waveform
    within 5e-4 (``test_pipeline_matches_jax_dynamic_path``'s bounds)."""
    x, xl = _ids(2)
    key = jax.random.PRNGKey(4)
    want = pipelines["jax"].synthesise_batch(x, xl, key, n_timesteps=2)
    T_y = want["mel"].shape[-1]
    z = np.array(jax.random.normal(key, (2, T_y, TINY["n_feats"]), dtype=jnp.float32))
    got = pipelines["two"].synthesise_batch(x, xl, n_timesteps=2, z=torch.from_numpy(z))
    np.testing.assert_array_equal(got["mel_lengths"].numpy(), np.asarray(want["mel_lengths"]))
    np.testing.assert_allclose(got["mel"].numpy(), np.asarray(want["mel"]), atol=1e-5)
    np.testing.assert_allclose(got["waveform"].numpy(), np.asarray(want["waveform"]), atol=5e-4)


def test_daemon_serves_from_two_replicas(pipelines, monkeypatch):
    """A daemon over the two-replica pipeline warms each replica, takes no
    fast path, and answers a request with what the one-device pipeline
    gives on the call's generator (the tiny model's ids: the text's
    characters mapped into its 20-id vocabulary)."""
    monkeypatch.setattr(serve, "text_to_sequence",
                        lambda text, cleaners: [1 + ord(c) % (TINY["n_vocab"] - 1) for c in text])
    two = pipelines["two"]
    b = serve.BatchingServer(two, max_batch=2, batch_window_ms=1000.0, n_timesteps=1)
    try:
        b.warmup([(32, 128)])
        assert b._fused_warm == {} and b.max_warm_x == 32
        text = "hello there"
        r = b.submit(text, timeout_s=300.0)
        assert r.error is None and b.n_fast == 0
        seq = np.asarray(serve.intersperse(serve.text_to_sequence(text, [CLEANER]), 0), np.int32)
        x = np.zeros((1, 32), np.int32)
        x[0, :len(seq)] = seq
        want = pipelines["one"].synthesise_batch(x, np.asarray([len(seq)], np.int32),
                                                 n_timesteps=1, temperature=b.temperature,
                                                 generator=b.call_generator(1))
        n = int(want["mel_lengths"][0])
        assert r.n_frames == n
        np.testing.assert_allclose(r.wav, want["waveform"][0, :len(r.wav)].numpy(),
                                   atol=2.0 / PCM24_SCALE)
        # two requests in one batch: a row on each replica
        import threading

        n_batches = b.n_batches
        got = [None, None]
        threads = [threading.Thread(target=lambda i=i: got.__setitem__(
            i, b.submit(text, timeout_s=300.0))) for i in range(2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(300.0)
        assert b.n_batches == n_batches + 1 and b.n_fast == 0
        want = pipelines["one"].synthesise_batch(np.concatenate([x, x]),
                                                 np.asarray([len(seq)] * 2, np.int32),
                                                 n_timesteps=1, temperature=b.temperature,
                                                 generator=b.call_generator(2))
        for i, r in enumerate(got):
            assert r.error is None and r.n_frames == int(want["mel_lengths"][i])
            np.testing.assert_allclose(r.wav, want["waveform"][i, :len(r.wav)].numpy(),
                                       atol=SERVE_ATOL + 2.0 / PCM24_SCALE)
    finally:
        b.shutdown()


def test_cli_data_parallel_is_a_no_op_on_one_device(fabricated_ckpts, tmp_path,  # noqa: F811
                                                     monkeypatch):
    """``--data-parallel`` parses in the CLI (JAX's flag) and, with one
    device, builds the one-device pipeline (``devices=None``)."""
    monkeypatch.setenv("MATCHA_HOME", fabricated_ckpts)
    assert port_cli.build_parser().parse_args(["--text", "x", "--data-parallel"]).data_parallel
    seen = {}
    make = port_pipeline.TTSPipeline

    def spy(*a, **kw):
        seen.update(kw)
        return make(*a, **kw)

    monkeypatch.setattr(port_cli, "TTSPipeline", spy)
    port_cli.cli(["--text", "hello", "--cleaner", CLEANER, "--steps", "1", "--cpu",
                  "--data-parallel", "--output_folder", str(tmp_path)])
    assert seen["devices"] is None and seen["device"] == torch.device("cpu")
    assert (tmp_path / "utterance_001.wav").exists()
    assert port_cli.data_parallel_devices(True, torch.device("cpu")) is None
