"""The port's training path against the JAX package, on the CPU.

* data: the port's ``TextMelDataModule`` gives the same batches as the
  JAX one on a synthetic corpus (same ids, same bucketed shapes, EQUAL
  mels: both run the same numpy mel);
* one ``train_step`` against JAX's ``make_train_step`` on the same weights
  and batch, with JAX's noise handed to the port along the step's key
  chain (``fold_in(base_key, step)`` -> ``k_loss``) and dropout at 0: the
  losses and the gradient norm agree to rtol 1e-5;
* global-norm clipping and Adam against optax on the same gradients: the
  clipped gradients to rtol 1e-6, the parameters after three updates to
  1e-5 of the learning rate per update (optax takes Adam's bias
  corrections 1 - beta^t in f32, where 1 - 0.999 keeps only 4 digits:
  its updates are off by ~6e-6 of the rate);
* the bf16 policy (``precision="bf16-mixed"``) against JAX's bf16 step
  on the same weights, batch and bf16 noise: the loss within 2 % of
  JAX's and of the port's own f32 loss (JAX's bound for bf16 against
  f32, tests/test_training.py), with f32 masters and Adam moments; every
  bf16 name trains a step; a multi-speaker batch (``path|spk|text``)
  trains a step too;
* resume from a checkpoint continues bit for bit; ``Trainer.fit`` keeps
  ``last``, the top-k checkpoints and their ledger;
* ``python -m matcha_tpu_torch.train trainer.accelerator=cpu`` trains
  and loads neither JAX nor ``matcha_tpu``.
"""

import csv
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from matcha_tpu.ops import seq as jax_seq
from matcha_tpu.training import data as jax_data
from matcha_tpu.training import trainer as jax_trainer
from matcha_tpu.utils import utils as jax_utils
from matcha_tpu_torch.convert import matcha_state_dict
from matcha_tpu_torch.models.matcha import MatchaTTS
from matcha_tpu_torch.ops import seq as port_seq
from matcha_tpu_torch.training import data as port_data
from matcha_tpu_torch.training import trainer as port_trainer
from matcha_tpu_torch.utils import checkpoints as port_ckpt
from matcha_tpu_torch.utils import utils as port_utils
from tests.test_convert import TINY
from tests.test_torch_losses import jax_noise, tiny_batch, tiny_pair

REPO = Path(__file__).resolve().parents[1]
SR = 22050
CLEANER = "english_cleaners_no_espeak"
TEXTS = ["The birch canoe slid on the smooth planks.", "Glue the sheet to the dark blue background.",
         "It's easy to tell the depth of a well.", "These days a chicken leg is a rare dish.",
         "Rice is often served in round bowls.", "The juice of lemons makes fine punch."]
# a tiny model for the corpus's 16-bin mels
TINY_TRAIN = dict(n_vocab=178, n_feats=16, enc_n_channels=16, enc_filter_channels=32,
                  enc_filter_channels_dp=16, enc_n_heads=2, enc_n_layers=1, enc_prenet=False,
                  dec_channels=(16, 16), dec_num_mid_blocks=1, dec_num_heads=1,
                  dec_attention_head_dim=16)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """Six tone-plus-noise wavs with real sentences, each about 3 mel
    frames per id (blanks included), as in LJSpeech, and their filelists."""
    root = tmp_path_factory.mktemp("corpus")
    rng = np.random.default_rng(0)
    entries = []
    for i, text in enumerate(TEXTS):
        n_ids = 2 * len(text) + 1
        t = np.arange(int(3 * n_ids * 256 * (1 + 0.05 * i))) / SR
        audio = 0.4 * np.sin(2 * np.pi * (180 + 40 * i) * t) + rng.normal(0, 0.02, t.shape)
        path = root / f"utt{i}.wav"
        port_utils.write_wav(path, audio.astype(np.float32), SR)
        entries.append(f"{path}|{text}")
    (root / "train.txt").write_text("\n".join(entries[:4]), encoding="utf-8")
    (root / "val.txt").write_text("\n".join(entries[4:]), encoding="utf-8")
    return {"train": str(root / "train.txt"), "val": str(root / "val.txt"), "root": root}


def dm_args(corpus, **kw):
    return dict(name="test", train_filelist_path=corpus["train"],
                valid_filelist_path=corpus["val"], batch_size=2, cleaners=[CLEANER], n_spks=1,
                n_feats=16, f_max=4000, data_statistics={"mel_mean": -5.5, "mel_std": 2.1},
                seed=1, **kw)


# ---------------------------------------------------------------------------
# helpers and data
# ---------------------------------------------------------------------------


def test_helpers_match_jax(corpus, tmp_path):
    """The small copies: round_up, duration_loss, normalize, the wav I/O
    and get_metric_value."""
    for n, grid in ((1, 16), (16, 16), (17, 16), (700, 64)):
        assert port_seq.round_up(n, grid) == jax_data.round_up(n, grid)
    rng = np.random.default_rng(0)
    logw, logw_ = rng.normal(size=(2, 2, 7, 1)).astype(np.float32)
    lengths = np.array([7, 4], np.int32)
    np.testing.assert_allclose(
        float(port_seq.duration_loss(torch.from_numpy(logw), torch.from_numpy(logw_),
                                     torch.from_numpy(lengths))),
        float(jax_seq.duration_loss(jnp.asarray(logw), jnp.asarray(logw_), jnp.asarray(lengths))),
        rtol=1e-6)
    mel = rng.normal(size=(16, 9)).astype(np.float32)
    np.testing.assert_array_equal(port_seq.normalize(mel, -5.5, 2.1),
                                  np.asarray(jax_seq.normalize(jnp.asarray(mel), -5.5, 2.1)))
    audio = np.clip(rng.normal(0, 0.5, 3000), -1.2, 1.2).astype(np.float32)
    port_utils.write_wav(tmp_path / "a.wav", audio, SR)
    got, sr = port_utils.read_wav(tmp_path / "a.wav")
    want, sr_j = jax_utils.read_wav(tmp_path / "a.wav")
    assert sr == sr_j == SR
    np.testing.assert_array_equal(got, want)
    np.testing.assert_allclose(got, np.clip(audio, -1, 1), atol=2.0 ** -22)
    assert port_utils.get_metric_value({"loss/val": 1.5}, "loss/val") == 1.5
    assert port_utils.get_metric_value({}, None) is None
    with pytest.raises(ValueError, match="not found"):
        port_utils.get_metric_value({}, "loss/val")


def _write_durations(corpus):
    """Per-id frame counts in ``<wav_dir>/durations/<stem>.npy`` that fill
    each clip's mel length, for the supervised-alignment data path."""
    ds = port_data.TextMelDataset(corpus["train"], 1, [CLEANER], n_feats=16, f_max=4000)
    ds_val = port_data.TextMelDataset(corpus["val"], 1, [CLEANER], n_feats=16, f_max=4000)
    (corpus["root"] / "durations").mkdir(exist_ok=True)
    for d in (ds, ds_val):
        for path, text in d.filepaths_and_text:
            n_ids, n_frames = d.get_text(text).shape[-1], d.get_mel(path).shape[-1]
            durs = np.full((n_ids,), n_frames // n_ids, np.float32)
            durs[-1] += n_frames - durs.sum()
            np.save(corpus["root"] / "durations" / (Path(path).stem + ".npy"), durs)


@pytest.mark.parametrize("num_workers,load_durations", [(0, False), (2, False), (0, True)])
def test_batches_equal_jax_datamodule(corpus, num_workers, load_durations):
    if load_durations:
        _write_durations(corpus)
    port_dm = port_data.TextMelDataModule(**dm_args(corpus, num_workers=num_workers,
                                                    load_durations=load_durations))
    jax_dm = jax_data.TextMelDataModule(**dm_args(corpus, load_durations=load_durations))
    for got_it, want_it in ((port_dm.train_batches(0), jax_dm.train_batches(0)),
                            (port_dm.train_batches(1), jax_dm.train_batches(1)),
                            (port_dm.val_batches(), jax_dm.val_batches())):
        got, want = list(got_it), list(want_it)
        assert len(got) == len(want) > 0
        for g, w in zip(got, want):
            assert set(g) == set(w)
            assert g["spks"] is None and w["spks"] is None
            for k in ("x", "x_lengths", "y", "y_lengths") + (("durations",) if load_durations
                                                              else ()):
                assert g[k].dtype == w[k].dtype, k
                np.testing.assert_array_equal(g[k], w[k], err_msg=k)
            if load_durations:
                np.testing.assert_array_equal(g["durations"].sum(axis=1), g["y_lengths"])
    frames_per_id = [b["y_lengths"].sum() / b["x_lengths"].sum() for b in got]
    assert all(2 < r < 4 for r in frames_per_id), frames_per_id


# ---------------------------------------------------------------------------
# one step and the optimizer
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("out_size", [None, 32])
def test_train_step_matches_jax(out_size):
    """Loss, sub-losses and the (unclipped) gradient norm of one step. No
    prenet: its dropout is fixed at 0.5, and the two packages' dropout
    masks cannot agree."""
    jm, variables, port = tiny_pair(prenet=False)
    batch = tiny_batch()
    seed = 3
    tx = jax_trainer.make_optimizer(lr=1e-3, gradient_clip_val=5.0)
    state = jax_trainer.TrainState(step=jnp.asarray(0, jnp.int32), params=variables,
                                   opt_state=tx.init(variables))
    step_fn = jax_trainer.make_train_step(jm, tx, out_size)
    base_key = jax.random.PRNGKey(seed + 17)
    _, want = step_fn(state, {k: jnp.asarray(v) for k, v in batch.items()}, base_key)
    k_loss, _ = jax.random.split(jax.random.fold_in(base_key, 0))

    opt, sched = port_trainer.make_optimizer(port, lr=1e-3)
    got = port_trainer.train_step(port, opt, sched, port_trainer.to_device(batch, "cpu"), step=0,
                                  seed=seed, out_size=out_size, gradient_clip_val=5.0,
                                  noise=jax_noise(k_loss, batch, out_size))
    assert set(got) == set(want)
    for k in got:
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-5, err_msg=k)


def _random_grads(variables, rng, scale):
    return jax.tree.map(
        lambda p: jnp.asarray(rng.normal(size=p.shape).astype(np.float32) * scale), variables)


def _port_layout(tree):
    sd = matcha_state_dict(tree, n_down_blocks=2, num_mid_blocks=TINY["dec_num_mid_blocks"])
    return {k: v for k, v in sd.items() if k not in ("mel_mean", "mel_std")}


@pytest.mark.parametrize("scale", [1e-4, 1.0])
def test_clip_matches_optax(scale):
    """Below the threshold the gradients pass unchanged; above it both
    scale by max_norm / norm (no epsilon)."""
    _, variables, port = tiny_pair()
    grads = _random_grads(variables, np.random.default_rng(1), scale)
    want_norm = float(optax.global_norm(grads))
    assert (want_norm < 5.0) == (scale < 1e-2)
    clipped, _ = optax.clip_by_global_norm(5.0).update(grads, None)
    port_grads = _port_layout(grads)
    names = [k for k, _ in port.named_parameters()]
    got = [port_grads[k].clone() for k in names]
    norm = port_trainer.clip_by_global_norm_(got, 5.0)
    np.testing.assert_allclose(float(norm), want_norm, rtol=1e-6)
    want = _port_layout(clipped)
    for k, g in zip(names, got):
        np.testing.assert_allclose(g.numpy(), want[k].numpy(), rtol=1e-6, atol=1e-12, err_msg=k)


@pytest.mark.parametrize("scheduler", [None, {"name": "exponential", "gamma": 0.5,
                                              "interval_steps": 2},
                                       {"name": "cosine", "decay_steps": 2}])
def test_clip_and_adam_match_optax(scheduler):
    """Three updates of clip + Adam (and the learning-rate schedule) on
    the same gradients, one of them clipped."""
    _, variables, port = tiny_pair()
    rng = np.random.default_rng(2)
    lr = 1e-2
    tx = jax_trainer.make_optimizer(lr=lr, gradient_clip_val=5.0, scheduler=scheduler)
    opt_state, params = tx.init(variables), variables
    opt, sched = port_trainer.make_optimizer(port, lr=lr, scheduler=scheduler)
    assert (sched is None) == (scheduler is None)
    for scale in (1e-3, 1.0, 1e-2):
        grads = _random_grads(variables, rng, scale)
        updates, opt_state = tx.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        port_grads = _port_layout(grads)
        for k, p in port.named_parameters():
            p.grad = port_grads[k].clone()
        port_trainer.clip_by_global_norm_([p.grad for p in port.parameters()], 5.0)
        opt.step()
        if sched is not None:
            sched.step()
    want = _port_layout(params)
    atol = 3 * 1e-5 * lr + 1e-7
    for k, p in port.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[k].numpy(), rtol=0, atol=atol,
                                   err_msg=k)


def test_schedule_factors():
    """optax's exponential_decay (not staircase) and cosine_decay_schedule
    at the update counts the LambdaLR sees."""
    exp = port_trainer.make_schedule({"name": "exponential", "gamma": 0.9, "interval_steps": 4})
    cos = port_trainer.make_schedule({"name": "cosine", "decay_steps": 5})
    want_exp = optax.exponential_decay(1.0, transition_steps=4, decay_rate=0.9)
    want_cos = optax.cosine_decay_schedule(1.0, decay_steps=5)
    for step in range(8):
        np.testing.assert_allclose(exp(step), float(want_exp(step)), rtol=1e-6)
        np.testing.assert_allclose(cos(step), float(want_cos(step)), rtol=1e-6, atol=1e-7)
    assert port_trainer.make_schedule(None) is None
    with pytest.raises(ValueError, match="scheduler"):
        port_trainer.make_schedule({"name": "step"})


# ---------------------------------------------------------------------------
# the trainer, checkpoints and the entry point
# ---------------------------------------------------------------------------


def make_trainer(corpus, out_dir, **kw):
    torch.manual_seed(0)
    args = dict(lr=1e-3, seed=7, output_dir=str(out_dir), loggers={})
    args.update(kw)
    return port_trainer.Trainer(MatchaTTS(**TINY_TRAIN), port_data.TextMelDataModule(
        **dm_args(corpus)), "cpu", **args)


def test_resume_bit_identical(corpus, tmp_path):
    """4 epochs in one run against 2, a checkpoint, and 2 more: weights,
    Adam moments and the step agree bit for bit (dropout on)."""
    kw = dict(check_val_every_n_epoch=100, save_every_n_epochs=0)
    full = make_trainer(corpus, tmp_path / "full", max_epochs=4, **kw)
    full.fit()
    first = make_trainer(corpus, tmp_path / "resume", max_epochs=2, **kw)
    first.fit()
    last = tmp_path / "resume" / "checkpoints" / "last"
    meta = json.loads((tmp_path / "resume" / "checkpoints" / "last.hparams.json").read_text())
    assert meta["epoch"] == 2 and meta["step"] == 4  # 2 batches per epoch
    second = make_trainer(corpus, tmp_path / "resume", max_epochs=4, **kw)
    second.fit(restore_from=str(last))
    assert full.step == second.step == 8
    for (k, a), (_, b) in zip(full.model.state_dict().items(), second.model.state_dict().items()):
        assert torch.equal(a, b), k
    sa, sb = full.optimizer.state_dict()["state"], second.optimizer.state_dict()["state"]
    assert sa.keys() == sb.keys()
    for i in sa:
        for k in ("step", "exp_avg", "exp_avg_sq"):
            assert torch.equal(sa[i][k], sb[i][k]), (i, k)


def test_fit_checkpoints_topk_and_logs(corpus, tmp_path):
    """Two one-step epochs: ``last``, one top-1 checkpoint by val loss and
    its ledger, the CSV with train and val columns; a resumed run keeps
    pruning against the ledger."""
    kw = dict(max_epochs=2, limit_train_batches=2, save_every_n_epochs=1, save_top_k=1,
              monitor="loss/val", monitor_mode="min", log_every_n_steps=1,
              loggers={"csv": {}})
    trainer = make_trainer(corpus, tmp_path, **kw)
    metrics = trainer.fit()
    assert trainer.step == 2
    assert np.isfinite(metrics["loss/train"]) and np.isfinite(metrics["loss/val"])
    ckpt_dir = tmp_path / "checkpoints"
    ledger = json.loads((ckpt_dir / "topk.json").read_text())
    assert len(ledger) == 1
    kept = ckpt_dir / ledger[0][2]
    assert kept.exists() and (ckpt_dir / (ledger[0][2] + ".hparams.json")).exists()
    saved = sorted(p.name for p in ckpt_dir.glob("checkpoint_*") if not p.name.endswith(".json"))
    assert saved == [ledger[0][2]]
    assert port_ckpt.scan_checkpoints(str(ckpt_dir)) == str(kept)
    payload = port_ckpt.load_native_checkpoint(str(ckpt_dir / "last"))
    assert payload["step"] == 2 and payload["epoch"] == 2
    assert set(payload) >= {"model", "optimizer", "hparams"}
    with open(tmp_path / "csv" / "metrics.csv", encoding="utf-8") as f:
        rows = list(csv.DictReader(f))
    assert {"loss/train", "grad_norm/total", "loss/val"} <= set(rows[0])
    assert sum(1 for r in rows if r["loss/train"]) == 2

    resumed = make_trainer(corpus, tmp_path, **dict(kw, max_epochs=3))
    resumed.fit(restore_from=str(ckpt_dir / "last"))
    assert resumed.step == 3
    assert len(json.loads((ckpt_dir / "topk.json").read_text())) == 1
    assert len([p for p in ckpt_dir.glob("checkpoint_*") if not p.name.endswith(".json")]) == 1


def test_precision_modes(corpus, tmp_path):
    """Each of the three bf16 names trains one tiny step with f32 masters
    and f32 Adam moments, and its loss is finite."""
    for precision in port_trainer.BF16_PRECISIONS:
        trainer = make_trainer(corpus, tmp_path / precision, precision=precision, max_steps=1,
                               check_val_every_n_epoch=100, enable_checkpointing=False,
                               log_every_n_steps=1)
        metrics = trainer.fit()
        assert trainer.step == 1 and np.isfinite(metrics["loss/train"]), precision
        assert all(p.dtype == torch.float32 for p in trainer.model.parameters())
        moments = [v for s in trainer.optimizer.state.values() for k, v in s.items()
                   if k in ("exp_avg", "exp_avg_sq")]
        assert moments and all(v.dtype == torch.float32 for v in moments)


def _jax_bf16_noise(key, batch) -> dict:
    """t and z as JAX's bf16 step draws them: t in mu's type (f32), z in
    the bf16 y's type."""
    B, T_y, n_feats = batch["y"].shape
    k_t, k_z = jax.random.split(key)
    return {"t": torch.from_numpy(np.asarray(jax.random.uniform(k_t, (B, 1, 1)))[:, 0, 0]),
            "z": torch.from_numpy(np.asarray(
                jax.random.normal(k_z, (B, T_y, n_feats), dtype=jnp.bfloat16), np.float32))}


def test_bf16_step_matches_jax_and_f32():
    """One ``bf16-mixed`` step against JAX's: the loss within 2 % of JAX's
    bf16 loss and of the port's f32 loss on the same batch and noise;
    after it the masters, their gradients and Adam's moments are f32."""
    jm, variables, port = tiny_pair(prenet=False)
    batch = tiny_batch()
    seed = 3
    tx = jax_trainer.make_optimizer(lr=1e-3, gradient_clip_val=5.0)
    state = jax_trainer.TrainState(step=jnp.asarray(0, jnp.int32), params=variables,
                                   opt_state=tx.init(variables))
    step_fn = jax_trainer.make_train_step(jm, tx, precision="bf16-mixed")
    base_key = jax.random.PRNGKey(seed + 17)
    _, want = step_fn(state, {k: jnp.asarray(v) for k, v in batch.items()}, base_key)
    k_loss, _ = jax.random.split(jax.random.fold_in(base_key, 0))
    noise = _jax_bf16_noise(k_loss, batch)

    tb = port_trainer.to_device(batch, "cpu")
    with torch.no_grad():
        f32 = sum(port_trainer.batch_losses(port.train(), tb, noise=noise))
    opt, sched = port_trainer.make_optimizer(port, lr=1e-3)
    got = port_trainer.train_step(port, opt, sched, tb, step=0, seed=seed,
                                  gradient_clip_val=5.0, noise=noise, precision="bf16-mixed")
    loss = float(got["loss"])
    assert abs(loss - float(want["loss"])) / float(want["loss"]) < 0.02
    assert abs(loss - float(f32)) / float(f32) < 0.02
    assert got["loss"].dtype == torch.float32
    assert all(p.dtype == torch.float32 and p.grad.dtype == torch.float32
               for p in port.parameters())
    moments = [v for s in opt.state.values() for k, v in s.items()
               if k in ("exp_avg", "exp_avg_sq")]
    assert len(moments) == 2 * len(list(port.parameters()))
    assert all(v.dtype == torch.float32 for v in moments)


def test_bf16_losses_run_on_rounded_weights_and_round_the_gradients():
    """The bf16 losses equal the f32 losses of a model whose weights were
    rounded to bf16, on ``y`` rounded to bf16 (where the two differ, only
    the bf16 arithmetic on y: its sum of squares and the flow's target
    ``u``); every gradient reaching an f32 master is a bf16 value (JAX's
    cotangents pass the same cast); the masters are left as they were."""
    _, _, port = tiny_pair(prenet=False)
    batch = port_trainer.to_device(tiny_batch(), "cpu")
    noise = jax_noise(jax.random.PRNGKey(5), tiny_batch())
    before = {n: p.detach().clone() for n, p in port.named_parameters()}
    port.train()
    losses = port_trainer.batch_losses(port, batch, noise=noise, precision="bf16-mixed")
    sum(losses).backward()
    for n, p in port.named_parameters():
        assert p.dtype == torch.float32 and torch.equal(p.detach(), before[n]), n
        assert torch.equal(p.grad, p.grad.to(torch.bfloat16).float()), n
    rounded = MatchaTTS(**dict(TINY, enc_p_dropout=0.0, dec_dropout=0.0, enc_prenet=False))
    rounded.load_state_dict({k: v.to(torch.bfloat16).float() if v.is_floating_point() else v
                             for k, v in port.state_dict().items()})
    with torch.no_grad():
        want = port_trainer.batch_losses(rounded.train(), dict(
            batch, y=batch["y"].to(torch.bfloat16).float()), noise=dict(
            noise, z=noise["z"].to(torch.bfloat16).float()))
    # the duration and prior losses do not see the bf16 arithmetic: EQUAL;
    # the flow's target u = y - (1 - sigma_min) z is rounded to bf16
    # (2^-9 of each element): the CFM loss within 1e-3 (measured 3.3e-4)
    assert [float(v) for v in losses[:2]] == [float(v) for v in want[:2]]
    np.testing.assert_allclose(float(losses[2]), float(want[2]), rtol=1e-3)


def test_multispeaker_batch_trains_a_step(tmp_path):
    """A ``path|spk|text`` filelist: the port's batches equal the JAX data
    module's (``spks`` included); a 3-speaker model trains a step in f32
    and in bf16 on them; a speaker id beyond the table is refused when its
    item is read."""
    root = tmp_path
    entries = []
    for i, text in enumerate(TEXTS[:4]):
        t = np.arange(int(3 * (2 * len(text) + 1) * 256)) / SR
        path = root / f"s{i}.wav"
        port_utils.write_wav(path, (0.3 * np.sin(2 * np.pi * (150 + 30 * i) * t)).astype(
            np.float32), SR)
        entries.append(f"{path}|{i % 3}|{text}")
    (root / "ms.txt").write_text("\n".join(entries), encoding="utf-8")
    args = dict(name="ms", train_filelist_path=str(root / "ms.txt"),
                valid_filelist_path=str(root / "ms.txt"), batch_size=2, cleaners=[CLEANER],
                n_spks=3, n_feats=16, f_max=4000,
                data_statistics={"mel_mean": -5.5, "mel_std": 2.1}, seed=1)
    got = next(port_data.TextMelDataModule(**args).train_batches(0))
    want = next(jax_data.TextMelDataModule(**args).train_batches(0))
    assert got.keys() == want.keys()
    for k in got:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert got["spks"].dtype == np.int32 and set(got["spks"]) <= {0, 1, 2}

    torch.manual_seed(0)
    model = MatchaTTS(**dict(TINY_TRAIN, n_spks=3, spk_emb_dim=8))
    opt, sched = port_trainer.make_optimizer(model, lr=1e-3)
    for step, precision in enumerate(("f32", "bf16-mixed")):
        m = port_trainer.train_step(model, opt, sched, port_trainer.to_device(got, "cpu"), step,
                                    seed=1, precision=precision)
        assert np.isfinite(float(m["loss"])), precision
    assert model.spk_emb.weight.grad is not None

    (root / "bad.txt").write_text(entries[0].replace("|0|", "|3|", 1), encoding="utf-8")
    bad = port_data.TextMelDataModule(**dict(args, train_filelist_path=str(root / "bad.txt"),
                                             batch_size=1))
    with pytest.raises(ValueError, match="speaker id 3"):
        next(bad.train_batches(0))


def test_train_module_on_cpu_loads_no_jax(corpus, tmp_path):
    """``python -m matcha_tpu_torch.train`` with the repo's configs and
    tiny overrides: it trains two steps on the CPU, saves ``last`` and
    the CSV, and its import log names neither JAX nor ``matcha_tpu``."""
    out = tmp_path / "run"
    overrides = [
        "trainer.accelerator=cpu", "trainer.max_steps=2", "trainer.log_every_n_steps=1",
        "logger=csv", f"paths.output_dir={out}",
        f"data.train_filelist_path={corpus['train']}",
        f"data.valid_filelist_path={corpus['val']}", "data.batch_size=2",
        f"data.cleaners=[{CLEANER}]", "data.n_feats=16", "data.f_max=4000", "data.num_workers=0",
        "model.n_feats=16", "model.encoder.encoder_params.n_channels=16",
        "model.encoder.encoder_params.filter_channels=32",
        "model.encoder.encoder_params.filter_channels_dp=16",
        "model.encoder.encoder_params.n_layers=1", "model.decoder.channels=[16,16]",
        "model.decoder.num_mid_blocks=1", "model.decoder.num_heads=1",
        "model.decoder.attention_head_dim=16",
    ]
    res = subprocess.run([sys.executable, "-X", "importtime", "-m", "matcha_tpu_torch.train",
                          *overrides], cwd=REPO, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    imported = {line.rsplit("|", 1)[-1].strip() for line in res.stderr.splitlines()
                if line.startswith("import time:")}
    # the entry module itself runs as __main__ and is not in the log
    assert {"torch", "matcha_tpu_torch.training.trainer"} <= imported
    bad = [m for m in imported if m.split(".")[0] in ("jax", "jaxlib", "flax", "matcha_tpu")]
    assert not bad, bad
    assert (out / "checkpoints" / "last").exists()
    assert (out / "config.yaml").exists()
    with open(out / "csv" / "metrics.csv", encoding="utf-8") as f:
        rows = [r for r in csv.DictReader(f) if r.get("loss/train")]
    assert len(rows) == 2 and all(np.isfinite(float(r["loss/train"])) for r in rows)
    assert os.path.getsize(out / "checkpoints" / "last") > 0


def test_train_without_a_card_raises(corpus, tmp_path):
    """No ``trainer.accelerator=cpu`` and no GPU: the entry point refuses
    instead of training on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from matcha_tpu_torch import train as port_train

    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_train.main([f"paths.output_dir={tmp_path}",
                         f"data.train_filelist_path={corpus['train']}",
                         f"data.valid_filelist_path={corpus['val']}"])
