"""The port's vocoder GAN training against the JAX package, on the CPU.

Weights come from flax init (jitted) of JAX's training models on
``TINY_HIFI`` (segment 128), the MPD at periods (2, 3) (a period that
divides the segment and one that needs the reflect pad; the recipe's
five-period MPD would double the GAN steps' CPU time, so it is held
forward only), and are
bridged with ``convert.py``; inputs are seeded numpy. The port runs on
two threads here, so that the suite's parallel workers do not
oversubscribe the CPU. Held here:

* the torch log-mel against JAX's ``mel_spectrogram``: values to 2e-5
  and the gradient of a weighted sum to 1e-5 of its largest element;
* the weight-norm generator, the MPD and the MSD (running u, and the
  stateless 7-iteration form) against ``apply``: logits and feature maps
  to 1e-5 of their scale, u to 1e-6, and so the recipe's five-period
  MPD's; the three GAN losses to 1e-6;
* ``MelDataset``: segments, mels and batches EQUAL to JAX's for the same
  seed, the padding and fine-tuning branches too;
* two GAN steps from the same state against JAX's jitted
  ``make_vocoder_train_step`` (``steps_per_epoch=1``, so step 2 runs at
  ``lr * 0.999``): the metrics of both steps to rtol 1e-5, scale 0's u
  after step 1 to 1e-6, and every weight after step 2 within 1e-5,
  except for at most 1e-5 of the elements (Adam's first updates are
  about ±lr wherever a gradient is tiny, so rounding can move those by up
  to 2 lr per step);
* a checkpoint restores every tensor, both optimisers and the step
  exactly, and the next step from it equals the unbroken one; the rate
  is a staircase per epoch; the entry point trains, saves and resumes;
* state dicts in the reference layout (torch ``weight_norm`` and
  ``spectral_norm`` names, built from plain torch convs) load into the
  generator, the MPD and the MSD as they are, and a trained generator
  folds into the serving form.
"""

import dataclasses
import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from matcha_tpu.audio import mel as jax_mel
from matcha_tpu.models import hifigan as jax_hifigan
from matcha_tpu.training import vocoder_data as jax_vdata
from matcha_tpu.training import vocoder_trainer as jax_vt
from matcha_tpu.utils import checkpoints as jax_ckpt
from matcha_tpu_torch import convert
from matcha_tpu_torch.audio import mel as port_mel
from matcha_tpu_torch.models import hifigan as port_hifigan
from matcha_tpu_torch.models.components.common import WeightNormConv
from matcha_tpu_torch.training import vocoder_data as port_vdata
from matcha_tpu_torch.training import vocoder_train as port_vtrain
from matcha_tpu_torch.training import vocoder_trainer as port_vt
from matcha_tpu_torch.utils.utils import write_wav
from tests.test_deploy_and_vocoder import TINY_HIFI

SR = 22050
B = 2
T_MEL = TINY_HIFI.segment_size // TINY_HIFI.hop_size
PERIODS = (2, 3)


@pytest.fixture(scope="module", autouse=True)
def two_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def _np(tree):
    return jax.tree.map(lambda a: np.array(a), tree)


def port_config():
    return port_hifigan.HiFiGANConfig(**dataclasses.asdict(TINY_HIFI))


@pytest.fixture(scope="module")
def jax_models():
    """JAX's training models on TINY_HIFI and their initial state (params
    from jitted flax init; eager init compiles op by op)."""
    h = TINY_HIFI
    gen, _, msd = jax_vt.make_models(h)
    mpd = jax_hifigan.MultiPeriodDiscriminator(periods=PERIODS, weight_norm=True)
    mel = jnp.zeros((1, T_MEL, h.num_mels))
    wav = jnp.zeros((1, h.segment_size, 1))
    k1, k2, k3 = jax.random.split(jax.random.PRNGKey(0), 3)
    gen_params = jax.jit(gen.init)(k1, mel)
    mpd_params = jax.jit(mpd.init)(k2, wav, wav)
    msd_vars = jax.jit(msd.init)(k3, wav, wav)
    # numpy copies: JAX's train step donates (deletes) the arrays it is given
    return {"gen": gen, "mpd": mpd, "msd": msd, "gen_params": _np(gen_params),
            "mpd_params": _np(mpd_params), "msd_params": _np({"params": msd_vars["params"]}),
            "spectral": _np(msd_vars["spectral"])}


def port_state(jm, steps_per_epoch=None):
    """The port's training state on the CPU with JAX's initial weights."""
    h = port_config()
    gen, _, msd = port_vt.make_models(h)
    mpd = port_hifigan.MultiPeriodDiscriminator(PERIODS)
    state = port_vt.VocoderTrainState(h, gen, mpd, msd,
                                      *port_vt.make_vocoder_optimizers(h, gen, mpd, msd),
                                      steps_per_epoch=steps_per_epoch)
    state.gen.load_state_dict(convert.hifigan_wn_state_dict(jm["gen_params"]))
    state.mpd.load_state_dict(convert.mpd_state_dict(jm["mpd_params"]))
    state.msd.load_state_dict(convert.msd_state_dict(jm["msd_params"], jm["spectral"]))
    return state


def random_batch(seed=0):
    """Channels-last numpy (JAX's layout) and channels-first torch (the
    port's) views of one batch."""
    rng = np.random.default_rng(seed)
    h = TINY_HIFI
    lay = {"mel": rng.normal(size=(B, T_MEL, h.num_mels)).astype(np.float32),
           "mel_loss": rng.normal(size=(B, T_MEL, h.num_mels)).astype(np.float32),
           "audio": rng.uniform(-0.5, 0.5, size=(B, h.segment_size, 1)).astype(np.float32)}
    return lay, {k: torch.from_numpy(np.ascontiguousarray(v.transpose(0, 2, 1)))
                 for k, v in lay.items()}


def _close(got, want, rel):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * max(1.0, np.abs(want).max()))


# ---------------------------------------------------------------------------
# the differentiable mel
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n_fft,hop,n_mels,fmax", [(1024, 256, 80, 8000.0), (32, 8, 80, 4000.0)])
def test_torch_mel_matches_jax_values_and_gradient(n_fft, hop, n_mels, fmax):
    rng = np.random.default_rng(n_fft)
    y = rng.uniform(-0.8, 0.8, size=(2, 16 * hop)).astype(np.float32)
    weights = rng.normal(size=(2, n_mels, 16)).astype(np.float32)
    args = (n_fft, n_mels, SR, hop, n_fft, 0.0, fmax)

    def jax_fn(a):
        return jnp.sum(jax_mel.mel_spectrogram(a, *args) * weights)

    want = np.asarray(jax_mel.mel_spectrogram(jnp.asarray(y), *args))
    want_grad = np.asarray(jax.grad(jax_fn)(jnp.asarray(y)))
    yt = torch.from_numpy(y).requires_grad_()
    got = port_mel.mel_spectrogram(yt, *args)
    (got * torch.from_numpy(weights)).sum().backward()
    assert got.shape == want.shape == (2, n_mels, 16)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=0, atol=2e-5)
    _close(yt.grad.numpy(), want_grad, 1e-5)
    # the device mel is the host pipeline's function
    np.testing.assert_allclose(got.detach().numpy()[0], port_mel.mel_spectrogram_np(y[0], *args),
                               rtol=0, atol=2e-5)


# ---------------------------------------------------------------------------
# the models and losses
# ---------------------------------------------------------------------------


def test_wn_generator_and_discriminators_match_jax(jax_models):
    jm = jax_models
    state = port_state(jm)
    lay, cf = random_batch(1)
    y_hat_j = np.asarray(jax.jit(jm["gen"].apply)(jm["gen_params"], jnp.asarray(lay["mel"])))
    y_hat_p = state.gen(torch.from_numpy(lay["mel"]))
    assert y_hat_p.requires_grad  # the training form keeps autograd
    _close(y_hat_p.detach().numpy(), y_hat_j, 1e-5)
    y_j, y_hat_j = jnp.asarray(lay["audio"]), jnp.asarray(y_hat_j)
    y_p, y_hat_p = cf["audio"], torch.from_numpy(np.ascontiguousarray(
        np.asarray(y_hat_j).transpose(0, 2, 1)))

    def check(outs_j, outs_p):
        for lj, lp in zip(outs_j[0] + outs_j[1], outs_p[0] + outs_p[1]):
            _close(lp.detach().numpy(), lj, 1e-5)
        for fj, fp in zip(outs_j[2] + outs_j[3], outs_p[2] + outs_p[3]):
            for a, b in zip(fj, fp):
                # flax feature maps are channels-last
                a = np.moveaxis(np.asarray(a), -1, 1)
                _close(b.detach().numpy(), a, 1e-5)

    check(jax.jit(jm["mpd"].apply)(jm["mpd_params"], y_j, y_hat_j), state.mpd(y_p, y_hat_p))
    variables = {**jm["msd_params"], "spectral": jm["spectral"]}
    outs_j, new = jax.jit(functools.partial(jm["msd"].apply, mutable=["spectral"]))(
        variables, y_j, y_hat_j)
    check(outs_j, state.msd(y_p, y_hat_p, update_u=True))
    sd = convert.msd_state_dict(jm["msd_params"], _np(new["spectral"]))
    for k, v in state.msd.state_dict().items():
        if k.endswith("weight_u"):
            np.testing.assert_allclose(v.numpy(), sd[k].numpy(), rtol=0, atol=1e-6)
    # the stateless spectral norm (running_u=False) on the same kernels
    msd_sl = jax_hifigan.MultiScaleDiscriminator(weight_norm=True, running_u=False)
    port_sl = port_hifigan.MultiScaleDiscriminator(running_u=False)
    port_sl.load_state_dict(convert.msd_state_dict(jm["msd_params"]))
    check(jax.jit(msd_sl.apply)(jm["msd_params"], y_j, y_hat_j), port_sl(y_p, y_hat_p))


def test_recipe_mpd_matches_jax():
    """The recipe's five-period MPD (periods 5, 7 and 11 too), forward only:
    logits and feature maps to 1e-5 of their scale."""
    _, mpd_j, _ = jax_vt.make_models(TINY_HIFI)
    lay, cf = random_batch(2)
    y_j = jnp.asarray(lay["audio"])
    y_hat = np.random.default_rng(4).uniform(-0.5, 0.5, lay["audio"].shape).astype(np.float32)
    params = _np(jax.jit(mpd_j.init)(jax.random.PRNGKey(1), y_j, y_j))
    mpd = port_hifigan.MultiPeriodDiscriminator()
    assert tuple(d.period for d in mpd.discriminators) == mpd_j.periods == (2, 3, 5, 7, 11)
    mpd.load_state_dict(convert.mpd_state_dict(params))
    outs_j = jax.jit(mpd_j.apply)(params, y_j, jnp.asarray(y_hat))
    with torch.no_grad():
        outs_p = mpd(cf["audio"], torch.from_numpy(np.ascontiguousarray(y_hat.transpose(0, 2, 1))))
    for lj, lp in zip(outs_j[0] + outs_j[1], outs_p[0] + outs_p[1], strict=True):
        _close(lp.numpy(), lj, 1e-5)
    for fj, fp in zip(outs_j[2] + outs_j[3], outs_p[2] + outs_p[3], strict=True):
        for a, b in zip(fj, fp, strict=True):
            _close(b.numpy(), np.moveaxis(np.asarray(a), -1, 1), 1e-5)


def test_gan_losses_match_jax():
    rng = np.random.default_rng(3)
    real = [rng.normal(size=(2, n)).astype(np.float32) for n in (5, 9)]
    fake = [rng.normal(size=(2, n)).astype(np.float32) for n in (5, 9)]
    fr = [[rng.normal(size=(2, 3, n)).astype(np.float32) for n in (4, 6)] for _ in range(2)]
    fg = [[rng.normal(size=(2, 3, n)).astype(np.float32) for n in (4, 6)] for _ in range(2)]
    t = lambda xs: [torch.from_numpy(x) for x in xs]  # noqa: E731
    d_j, r_j, g_j = jax_hifigan.discriminator_loss(real, fake)
    d_p, r_p, g_p = port_hifigan.discriminator_loss(t(real), t(fake))
    np.testing.assert_allclose(float(d_p), float(d_j), rtol=1e-6)
    np.testing.assert_allclose([float(v) for v in r_p + g_p], [float(v) for v in r_j + g_j],
                               rtol=1e-6)
    np.testing.assert_allclose(float(port_hifigan.generator_loss(t(fake))[0]),
                               float(jax_hifigan.generator_loss(fake)[0]), rtol=1e-6)
    np.testing.assert_allclose(float(port_hifigan.feature_loss([t(f) for f in fr],
                                                               [t(f) for f in fg])),
                               float(jax_hifigan.feature_loss(fr, fg)), rtol=1e-6)


# ---------------------------------------------------------------------------
# the dataset
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def clips(tmp_path_factory):
    """Five clips: three longer than a v1 segment, two shorter (the
    padding branch), and a synthesised mel per clip for fine-tuning."""
    root = tmp_path_factory.mktemp("vocoder_clips")
    rng = np.random.default_rng(5)
    lines = []
    for i, n in enumerate((12000, 9000, 20000, 5000, 700)):
        t = np.arange(n) / SR
        audio = 0.4 * np.sin(2 * np.pi * (150 + 50 * i) * t) + rng.normal(0, 0.01, n)
        path = root / f"c{i}.wav"
        write_wav(path, audio.astype(np.float32), SR)
        lines.append(f"{path}|text {i}")
        os.makedirs(root / "mels", exist_ok=True)
        np.save(root / "mels" / f"c{i}.npy",
                rng.normal(size=(80, n // 256 + 3)).astype(np.float32))
    (root / "train.txt").write_text("\n".join(lines), encoding="utf-8")
    return root


@pytest.mark.parametrize("fine_tuning", [False, True])
def test_mel_dataset_equals_jax(clips, fine_tuning):
    kw = dict(segment_size=8192, seed=77, fine_tuning=fine_tuning,
              base_mels_path=str(clips / "mels") if fine_tuning else None)
    jds = jax_vdata.MelDataset(str(clips / "train.txt"), **kw)
    pds = port_vdata.MelDataset(str(clips / "train.txt"), **kw)
    assert pds.audio_files == jds.audio_files
    for i in range(len(jds)):
        a, b = jds[i], pds[i]
        for key in ("mel", "audio", "mel_loss"):
            np.testing.assert_array_equal(b[key], a[key])
    for epoch in (0, 1):
        for bj, bp in zip(jds.batches(2, epoch), pds.batches(2, epoch), strict=True):
            assert bp["audio"].shape == (2, 1, 8192)
            np.testing.assert_array_equal(bp["audio"].numpy(), bj["audio"].transpose(0, 2, 1))
            for key in ("mel", "mel_loss"):
                np.testing.assert_array_equal(bp[key].numpy(), bj[key].transpose(0, 2, 1))


# ---------------------------------------------------------------------------
# the GAN step
# ---------------------------------------------------------------------------

# Adam's first updates are ~ +-lr wherever a gradient is near zero, so f32
# rounding that differs between the packages can move such an element by
# up to 2 lr per step; at most this share of the elements may.
WEIGHT_ATOL = 1e-5
WEIGHT_SHARE_BEYOND = 1e-5


def test_two_gan_steps_match_jax(jax_models):
    jm = jax_models
    h = TINY_HIFI
    gen_tx, disc_tx = jax_vt.make_vocoder_optimizers(h, steps_per_epoch=1)
    p = {k: jax.tree.map(jnp.asarray, jm[k])
         for k in ("gen_params", "mpd_params", "msd_params", "spectral")}
    jstate = jax_vt.VocoderTrainState(
        step=jnp.asarray(0, jnp.int32), gen_params=p["gen_params"],
        mpd_params=p["mpd_params"], msd_params=p["msd_params"], msd_spectral=p["spectral"],
        gen_opt=gen_tx.init(p["gen_params"]),
        disc_opt=disc_tx.init((p["mpd_params"], p["msd_params"])))
    step_fn = jax_vt.make_vocoder_train_step(jm["gen"], jm["mpd"], jm["msd"], h,
                                             steps_per_epoch=1)
    state = port_state(jm, steps_per_epoch=1)
    u0 = state.msd.discriminators[0].convs[0].weight_u.clone()
    for step in range(2):
        lay, cf = random_batch(10 + step)
        jstate, mj = step_fn(jstate, {k: jnp.asarray(v) for k, v in lay.items()})
        mp = port_vt.vocoder_train_step(state, cf)
        assert state.gen_opt.param_groups[0]["lr"] == pytest.approx(h.learning_rate
                                                                    * h.lr_decay ** step)
        for key in ("disc_loss", "gen_loss", "mel_l1"):
            np.testing.assert_allclose(float(mp[key]), float(mj[key]), rtol=1e-5, err_msg=key)
        if step == 0:
            u = state.msd.discriminators[0].convs[0].weight_u
            assert not torch.allclose(u, u0)
            np.testing.assert_allclose(
                u.numpy(), np.asarray(jstate.msd_spectral["discriminators_0"]["convs_0"]["u"]),
                rtol=0, atol=1e-6)
    assert state.step == int(jstate.step) == 2
    wants = {"gen": convert.hifigan_wn_state_dict(_np(jstate.gen_params)),
             "mpd": convert.mpd_state_dict(_np(jstate.mpd_params)),
             "msd": convert.msd_state_dict(_np(jstate.msd_params), _np(jstate.msd_spectral))}
    lr = h.learning_rate
    for name, want in wants.items():
        got = getattr(state, name).state_dict()
        beyond = total = 0
        for key, w in want.items():
            if name == "msd" and key.endswith("weight_v"):
                continue  # JAX keeps no v; the port's is informational
            d = (got[key] - w).abs()
            assert float(d.max()) <= 2 * 2 * lr + 1e-6, (key, float(d.max()))
            beyond += int((d > WEIGHT_ATOL).sum())
            total += d.numel()
        assert beyond <= WEIGHT_SHARE_BEYOND * total, (name, beyond, total)


def test_checkpoint_restores_exactly_and_rate_is_a_staircase(jax_models, tmp_path):
    state = port_state(jax_models, steps_per_epoch=2)
    port_vt.vocoder_train_step(state, random_batch(20)[1])
    path = port_vtrain.save_vocoder_checkpoint(str(tmp_path), state, epoch=1, tag="last")
    restored = port_state(jax_models, steps_per_epoch=2)
    assert port_vtrain.load_vocoder_checkpoint(path, restored) == 1
    assert restored.step == state.step == 1
    for name in ("gen", "mpd", "msd"):
        a, b = getattr(state, name).state_dict(), getattr(restored, name).state_dict()
        assert a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a)
    for name in ("gen_opt", "disc_opt"):
        a, b = getattr(state, name).state_dict()["state"], getattr(restored, name).state_dict()[
            "state"]
        assert all(torch.equal(a[i][k], b[i][k]) for i in a for k in a[i])
    batch = random_batch(30)[1]
    m_a, m_b = port_vt.vocoder_train_step(state, batch), port_vt.vocoder_train_step(restored, batch)
    assert all(torch.equal(m_a[k], m_b[k]) for k in m_a)
    assert all(torch.equal(p, q) for p, q in zip(state.gen.parameters(),
                                                 restored.gen.parameters()))
    h = port_config()
    assert [port_vt.learning_rate(h, s, 2) for s in range(5)] == [
        h.learning_rate, h.learning_rate, h.learning_rate * h.lr_decay,
        h.learning_rate * h.lr_decay, h.learning_rate * h.lr_decay ** 2]
    assert port_vt.learning_rate(h, 1000, None) == h.learning_rate


def test_entry_point_trains_saves_and_resumes(clips, tmp_path, monkeypatch):
    monkeypatch.setattr(port_vt, "make_models", lambda h: (
        port_hifigan.Generator(h, weight_norm=True),
        port_hifigan.MultiPeriodDiscriminator(PERIODS),
        port_hifigan.MultiScaleDiscriminator(running_u=True)))
    out = tmp_path / "run"
    argv = ["--train-filelist", str(clips / "train.txt"), "--output-dir", str(out),
            "--epochs", "1", "--batch-size", "4", "--segment-size", "128",
            "--log-every-n-steps", "1", "--save-every-n-epochs", "1", "--device", "cpu"]
    last = port_vtrain.train(port_vtrain.parse_args(argv), h=port_config())
    assert set(last) == {"disc_loss", "gen_loss", "mel_l1"}
    assert all(np.isfinite(v) for v in last.values())
    ckpt = out / "checkpoints"
    assert (ckpt / "last").is_file() and (ckpt / "g_00000001").is_file()
    assert (ckpt / "last.meta.json").read_text() == '{"step": 1, "epoch": 1}'
    argv[5], argv[-3] = "2", "2"
    resumed = port_vtrain.train(port_vtrain.parse_args(
        argv + ["--restore-from", str(ckpt / "last")]), h=port_config())
    assert all(np.isfinite(v) for v in resumed.values())
    assert (ckpt / "last.meta.json").read_text() == '{"step": 2, "epoch": 2}'
    assert (ckpt / "g_00000002").is_file()
    rows = [r for r in (out / "csv" / "metrics.csv").read_text().splitlines()
            if not r.startswith("step,")]
    assert [int(r.split(",")[0]) for r in rows] == [1, 2]


def test_entry_point_without_a_card_raises(clips, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_vtrain.main(["--train-filelist", str(clips / "train.txt"),
                          "--output-dir", str(tmp_path)])


# ---------------------------------------------------------------------------
# reference-layout state dicts
# ---------------------------------------------------------------------------


def _weight_norm_all(module: nn.Module, types=(nn.Conv1d, nn.Conv2d, nn.ConvTranspose1d)):
    for m in list(module.modules()):
        if isinstance(m, types):
            torch.nn.utils.weight_norm(m)
    return module


def _reference_twin(conv: nn.Module) -> nn.Module:
    """A plain torch conv of ``conv``'s shape under torch's own
    ``weight_norm`` (``spectral_norm`` for an ``SNConv1d``): that conv in
    the reference checkpoint's layout."""
    if isinstance(conv, port_hifigan.SNConv1d):
        w = conv.weight_orig
        return torch.nn.utils.spectral_norm(nn.Conv1d(
            w.shape[1] * conv.groups, w.shape[0], w.shape[2], conv.stride, conv.padding,
            groups=conv.groups))
    v = conv.weight_v
    cls = {3: nn.Conv1d, 4: nn.Conv2d}[v.dim()]
    return torch.nn.utils.weight_norm(cls(v.shape[1] * conv.groups, v.shape[0],
                                          tuple(v.shape[2:]), conv.stride, conv.padding,
                                          conv.dilation, conv.groups))


def _reference_layout(module: nn.Module):
    """The reference twin of every conv of ``module`` by name, and their
    state dicts under ``module``'s names."""
    twins = {name: _reference_twin(m) for name, m in module.named_modules()
             if isinstance(m, (WeightNormConv, port_hifigan.SNConv1d))}
    return twins, {f"{name}.{k}": v for name, twin in twins.items()
                   for k, v in twin.state_dict().items()}


def test_reference_layout_state_dicts_load(jax_models):
    """State dicts in the reference checkpoint layout (torch's own
    ``weight_norm`` and, on MSD scale 0, ``spectral_norm`` names) load
    into the port's training forms as they are and give the reference's
    weights, and JAX's own converters read them."""
    torch.manual_seed(0)
    h = port_config()
    ref_gen = _weight_norm_all(port_hifigan.Generator(h))
    gen = port_hifigan.Generator(h, weight_norm=True)
    gen.load_state_dict(ref_gen.state_dict())
    with pytest.raises(ValueError, match="weight-norm form"):
        port_hifigan.Generator(h, upsample_impl="subpixel", weight_norm=True)
    mel = torch.randn(1, T_MEL, h.num_mels)
    with torch.no_grad():
        _close(gen(mel).numpy(), ref_gen.generate(mel.transpose(1, 2)).transpose(1, 2).numpy(),
               1e-6)
        folded = port_hifigan.Generator(h)
        folded.load_state_dict(convert.fold_hifigan_state_dict(gen.state_dict()))
        _close(folded(mel).numpy(), gen(mel).numpy(), 1e-6)

    mpd = port_hifigan.MultiPeriodDiscriminator(PERIODS)
    mpd_twins, mpd_sd = _reference_layout(mpd)
    mpd.load_state_dict(mpd_sd)
    msd = port_hifigan.MultiScaleDiscriminator(running_u=True)
    msd_twins, sd = _reference_layout(msd)
    assert {"discriminators.0.convs.0.weight_orig", "discriminators.0.convs.0.weight_u",
            "discriminators.1.convs.3.weight_g", "discriminators.1.conv_post.weight_v"} <= set(sd)
    msd.load_state_dict(sd)
    modules = {**{f"mpd.{k}": v for k, v in mpd.named_modules()},
               **{f"msd.{k}": v for k, v in msd.named_modules()}}
    twins = {**{f"mpd.{k}": v for k, v in mpd_twins.items()},
             **{f"msd.{k}": v for k, v in msd_twins.items()}}
    with torch.no_grad():
        for name, twin in twins.items():
            conv = modules[name]
            if isinstance(conv, port_hifigan.SNConv1d):
                assert torch.equal(conv.weight_orig, twin.weight_orig)
                assert torch.equal(conv.weight_u, twin.weight_u)
            else:
                _close(conv.weight.numpy(), twin.weight.numpy(), 1e-6)
            assert torch.equal(conv.bias, twin.bias)
    y = torch.rand(1, 1, TINY_HIFI.segment_size) - 0.5

    # JAX's converters read the same names
    np_sd = {k: v.numpy() for k, v in mpd_sd.items()}
    jp = jax_ckpt.convert_mpd_state_dict(np_sd)
    yj = jnp.asarray(y.numpy().transpose(0, 2, 1))
    outs = jax.jit(jax_hifigan.MultiPeriodDiscriminator(
        periods=PERIODS, weight_norm=True).apply)(jp, yj, yj)
    for a, b in zip(outs[0], mpd(y, y)[0]):
        _close(b.detach().numpy(), a, 1e-5)
    np_sd = {k: v.numpy() for k, v in sd.items()}
    js = jax_ckpt.convert_msd_scale_state_dict(np_sd, 1)
    yp = torch.nn.functional.avg_pool1d(y, 4, 2, padding=2)
    out_j = jax.jit(jax_hifigan.DiscriminatorS(weight_norm=True).apply)(
        js, jnp.asarray(yp.numpy().transpose(0, 2, 1)))[0]
    _close(msd.discriminators[1](yp)[0].detach().numpy(), out_j, 1e-5)
