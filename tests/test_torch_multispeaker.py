"""Multi-speaker models in the PyTorch port against the JAX package.

The model is ``tests/test_multispeaker.py``'s ``TINY_MS`` (4 speakers,
``spk_emb_dim`` 8) with the VCTK statistics, weights from flax init
bridged through ``matcha_tpu_torch.convert.matcha_state_dict`` (the
speaker table included), scaled by ``WEIGHT_SCALE``, dropout 0.
Tolerances are the single-speaker tests' for the same quantities:
``mu_x`` atol 1e-6 (measured 1.8e-7 on |mu_x| <= 0.83), ``w_ceil`` and
``y_lengths`` EQUAL, the mel atol 1e-5 (measured 2.9e-6 on |mel| <= 13),
the MAS alignment EQUAL, the three losses rtol 1e-5. Noise (z, t) is
drawn with ``jax.random`` and injected.

Then the entry points on a fabricated 4-speaker checkpoint: ``--spk`` on
every CLI path and its defaults, and the host-side range checks.
"""

import functools
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from matcha_tpu.models import MatchaTTS as JaxMatchaTTS
from matcha_tpu_torch import cli as port_cli
from matcha_tpu_torch import pipeline as port_pipeline
from matcha_tpu_torch.convert import matcha_state_dict
from matcha_tpu_torch.models.matcha import MatchaTTS as PortMatchaTTS
from matcha_tpu_torch.models.matcha import check_speakers
from tests.test_cli_e2e import TINY as TINY_CLI
from tests.test_cli_e2e import fabricated_ckpts  # noqa: F401  (fixture reuse)
from tests.test_multispeaker import TINY_MS

KW = dict(TINY_MS, enc_p_dropout=0.0, dec_dropout=0.0, mel_mean=-6.630575, mel_std=2.482914)
MU_ATOL, MEL_ATOL, LOSS_RTOL = 1e-6, 1e-5, 1e-5
SPEAKER_SETS = ([1, 3], [0, 2])
# flax init's weights halved, so that the activations are O(1) as in the
# single-speaker tests, whose bounds apply (at full scale the mel moved by
# 1.4e-5 at |mel| 10-13: f32 sums in another order, amplified)
WEIGHT_SCALE = 0.5


def ms_batch():
    rng = np.random.default_rng(0)
    x = rng.integers(1, TINY_MS["n_vocab"], size=(2, 16)).astype(np.int32)
    xl = np.array([16, 12], np.int32)
    x[1, 12:] = 0
    y = rng.normal(size=(2, 64, TINY_MS["n_feats"])).astype(np.float32)
    yl = np.array([64, 48], np.int32)
    y[1, 48:] = 0
    return {"x": x, "x_lengths": xl, "y": y, "y_lengths": yl,
            "spks": np.array(SPEAKER_SETS[0], np.int32)}


@pytest.fixture(scope="module")
def pair():
    """(jax model, flax variables, port model) with the same weights; the
    flax init (jitted) goes through ``losses`` with given durations (no
    MAS)."""
    jm = JaxMatchaTTS(**KW)
    b = ms_batch()
    init = jax.jit(functools.partial(jm.init, method=JaxMatchaTTS.losses))
    variables = init({"params": jax.random.PRNGKey(1)}, *(jnp.asarray(b[k]) for k in (
        "x", "x_lengths", "y", "y_lengths")), jax.random.PRNGKey(0), jnp.asarray(b["spks"]),
        durations=jnp.ones((2, 16)))
    variables = jax.tree.map(lambda a: a * WEIGHT_SCALE, variables)
    port = PortMatchaTTS(**KW)
    port.load_state_dict(matcha_state_dict(variables, n_down_blocks=2, num_mid_blocks=1,
                                           mel_mean=KW["mel_mean"], mel_std=KW["mel_std"]))
    return jm, variables, port.eval()


def _t(a):
    return torch.from_numpy(np.asarray(a))


def test_bridge_carries_the_speaker_table_and_widths(pair):
    jm, variables, port = pair
    np.testing.assert_array_equal(port.spk_emb.weight.detach().numpy(),
                                  np.asarray(variables["params"]["spk_emb"]["embedding"]))
    width = TINY_MS["enc_n_channels"] + TINY_MS["spk_emb_dim"]
    assert port.encoder.proj_m.weight.shape[1] == width
    assert port.decoder.estimator.down_blocks[0][0].block1.block[0].in_channels == \
        2 * TINY_MS["n_feats"] + TINY_MS["spk_emb_dim"]


@pytest.mark.parametrize("spks", SPEAKER_SETS)
def test_encode_durations_are_equal(pair, spks):
    jm, variables, port = pair
    b = ms_batch()
    s = np.array(spks, np.int32)
    # precondition of the exact comparison: every exp(logw) is more than
    # 1e-4 from an integer, so f32 noise cannot move a ceil
    x_mask = (np.arange(16)[None, :] < b["x_lengths"][:, None]).astype(np.float32)[..., None]
    _, logw = jm.apply(variables, jnp.asarray(b["x"]), jnp.asarray(x_mask), jnp.asarray(s),
                       method=lambda m, x, mask, sp: m.encoder(x, mask, m._speaker(sp)))
    w = np.exp(np.minimum(np.asarray(logw, np.float64), 11.0))[..., 0]
    assert np.abs(w - np.round(w))[x_mask[..., 0] > 0].min() > 1e-4
    mu_j, w_j, yl_j = jm.apply(variables, jnp.asarray(b["x"]), jnp.asarray(b["x_lengths"]),
                               jnp.asarray(s), method=JaxMatchaTTS.encode)
    mu_t, w_t, yl_t = port.encode(_t(b["x"]).long(), _t(b["x_lengths"]), spks=_t(s))
    np.testing.assert_allclose(mu_t.numpy(), np.asarray(mu_j), atol=MU_ATOL)
    np.testing.assert_array_equal(w_t.numpy(), np.asarray(w_j))
    np.testing.assert_array_equal(yl_t.numpy(), np.asarray(yl_j))


def test_synthesise_at_two_speakers_matches_jax(pair):
    """Same text and noise at two speaker sets: each mel is JAX's, and
    the two differ."""
    jm, variables, port = pair
    b = ms_batch()
    key = jax.random.PRNGKey(3)
    kw = dict(n_timesteps=1, temperature=0.667, y_max_length=64)
    z = np.array(jax.random.normal(key, (2, 64, TINY_MS["n_feats"]), dtype=jnp.float32))
    synth = jax.jit(functools.partial(jm.apply, method=JaxMatchaTTS.synthesise, **kw))
    mels = []
    for spks in SPEAKER_SETS:
        s = np.array(spks, np.int32)
        want = synth(variables, jnp.asarray(b["x"]), jnp.asarray(b["x_lengths"]), key,
                     spks=jnp.asarray(s))
        got = port.synthesise(_t(b["x"]).long(), _t(b["x_lengths"]), z=_t(z), spks=_t(s), **kw)
        np.testing.assert_array_equal(got["mel_lengths"].numpy(), np.asarray(want["mel_lengths"]))
        np.testing.assert_allclose(got["mel"].numpy(), np.asarray(want["mel"]), atol=MEL_ATOL)
        mels.append(got["mel"].numpy())
    assert not np.allclose(mels[0], mels[1])


def test_losses_with_mas_match_jax(pair):
    jm, variables, port = pair
    b = ms_batch()
    key = jax.random.PRNGKey(4)
    want = jm.apply(variables, *(jnp.asarray(b[k]) for k in ("x", "x_lengths", "y", "y_lengths")),
                    key, jnp.asarray(b["spks"]), method=JaxMatchaTTS.losses)
    k_t, k_z = jax.random.split(key)
    noise = {"t": _t(np.asarray(jax.random.uniform(k_t, (2, 1, 1)))[:, 0, 0]),
             "z": _t(np.asarray(jax.random.normal(k_z, b["y"].shape)))}
    with torch.no_grad():
        got = port.losses(_t(b["x"]).long(), _t(b["x_lengths"]), _t(b["y"]), _t(b["y_lengths"]),
                          spks=_t(b["spks"]), **noise)
    np.testing.assert_array_equal(got[3].numpy(), np.asarray(want[3]))
    for g, w in zip(got[:3], want[:3]):
        np.testing.assert_allclose(float(g), float(w), rtol=LOSS_RTOL)


def test_speaker_ids_are_checked_on_the_host():
    """An id outside [0, n_spks) raises ValueError before it reaches the
    embedding (on a card that lookup would fire a device-side assert); a
    multi-speaker model needs ids; a single-speaker one ignores them."""
    np.testing.assert_array_equal(check_speakers(4, [0, 3]), [0, 3])
    for bad in ([4], [-1], [0, 7]):
        with pytest.raises(ValueError, match="out of range"):
            check_speakers(4, bad)
    with pytest.raises(ValueError, match="needs speaker ids"):
        check_speakers(4, None)
    with pytest.raises(ValueError, match="integer"):
        check_speakers(4, [1.5])
    assert check_speakers(1, [99]) is None
    with pytest.raises(ValueError, match="needs speaker ids"):
        PortMatchaTTS(**KW).encode(torch.ones(1, 4, dtype=torch.long), torch.tensor([4]))


# ---------------------------------------------------------------------------
# the CLI and the daemon on a fabricated multi-speaker checkpoint
# ---------------------------------------------------------------------------

CLEANER = "english_cleaners_no_espeak"
MS_CKPT = dict(TINY_CLI, n_spks=4, spk_emb_dim=8)


@pytest.fixture(scope="module")
def ms_home(fabricated_ckpts, tmp_path_factory):  # noqa: F811
    """``$MATCHA_HOME`` with a 4-speaker reference-format checkpoint
    (``matcha_vctk.ckpt``, weights from a seed) and the fabricated HiFi-GAN
    v1 as ``hifigan_univ_v1``, the vocoder a custom checkpoint pairs with.
    Returns (home, checkpoint path)."""
    root = tmp_path_factory.mktemp("ms_home")
    home = root / "matcha_tpu"
    home.mkdir()
    ckpt = torch.load(os.path.join(fabricated_ckpts, "matcha_tpu", "matcha_ljspeech.ckpt"),
                      weights_only=False)
    hp = dict(ckpt["hyper_parameters"], n_spks=MS_CKPT["n_spks"],
              spk_emb_dim=MS_CKPT["spk_emb_dim"])
    torch.manual_seed(0)
    model = PortMatchaTTS(**{k: v for k, v in MS_CKPT.items()})
    torch.save({"state_dict": model.state_dict(), "hyper_parameters": hp},
               home / "matcha_vctk.ckpt")
    shutil.copy(os.path.join(fabricated_ckpts, "matcha_tpu", "hifigan_T2_v1"),
                home / "hifigan_univ_v1")
    return str(root), str(home / "matcha_vctk.ckpt")


CLI_MODES = {
    "dynamic": [],
    "fixed_bucket": ["--fixed-y-bucket", "128"],
    "batched": ["--batched", "--batch_size", "2"],
    "staged_fused": ["--batched", "--staged", "--fused-stage", "--batch_size", "2"],
    "long_form": ["--long-form"],
}


@pytest.mark.parametrize("mode", CLI_MODES)
def test_cli_spk_on_every_path(ms_home, tmp_path, monkeypatch, mode):
    """``--spk 3`` reaches the model on every path; the files are named
    ``utterance_<i>_speaker_003`` as JAX names them (the long-form file
    keeps its name)."""
    home, ckpt = ms_home
    monkeypatch.setenv("MATCHA_HOME", home)
    (tmp_path / "in.txt").write_text("Hello world.\nA second line here.\n", encoding="utf-8")
    text = (["--file", str(tmp_path / "in.txt")] if "batched" in mode
            else ["--text", "Hello world. A second sentence."])
    seen = []
    real = port_pipeline.TTSPipeline.synthesise_batch
    monkeypatch.setattr(port_pipeline.TTSPipeline, "synthesise_batch",
                        lambda self, *a, **k: (seen.append(k.get("spks")), real(self, *a, **k))[1])
    real_corpus = port_pipeline.TTSPipeline.synthesise_corpus
    monkeypatch.setattr(port_pipeline.TTSPipeline, "synthesise_corpus",
                        lambda self, *a, **k: (seen.append(k.get("spk")),
                                               real_corpus(self, *a, **k))[1])
    out = tmp_path / "out"
    port_cli.cli(["--checkpoint_path", ckpt, *text, "--spk", "3", "--cleaner", CLEANER,
                  "--steps", "1", "--cpu", "--output_folder", str(out), *CLI_MODES[mode]])
    names = sorted(p.stem for p in out.glob("*.wav"))
    if mode == "long_form":
        assert names == ["utterance_long_form"]
    elif "batched" in mode:
        assert names == ["utterance_000_speaker_003", "utterance_001_speaker_003"]
    else:
        assert names == ["utterance_001_speaker_003"]
    assert seen and all(np.all(np.asarray(s) == 3) for s in seen)


def test_cli_speaker_defaults_and_range(ms_home, fabricated_ckpts, tmp_path,  # noqa: F811
                                        monkeypatch):
    """No ``--spk`` on a multi-speaker model: a warning and speaker 0; an
    id outside [0, n_spks): exit naming the range; ``--spk`` on a
    single-speaker model: a warning, and it is ignored."""
    home, ckpt = ms_home
    monkeypatch.setenv("MATCHA_HOME", home)
    out = tmp_path / "out"
    args = ["--checkpoint_path", ckpt, "--text", "Hi.", "--cleaner", CLEANER, "--steps", "1",
            "--cpu", "--output_folder", str(out)]
    with pytest.warns(UserWarning, match="Speaker ID not provided"):
        port_cli.cli(args)
    assert (out / "utterance_001_speaker_000.wav").exists()
    with pytest.raises(SystemExit, match="out of range"):
        port_cli.cli(args + ["--spk", "4"])
    single = PortMatchaTTS(**TINY_CLI)
    with pytest.warns(UserWarning, match="Ignoring speaker id 5"):
        assert port_cli.resolve_speaker(single, 5) is None
    assert port_cli.resolve_speaker(PortMatchaTTS(**MS_CKPT), 2) == 2


def test_pipeline_refuses_out_of_range_speakers_on_the_host(ms_home):
    """``synthesise_batch`` and ``synthesise_corpus`` check speaker ids
    before anything runs."""
    _, ckpt = ms_home
    pipe = port_pipeline.TTSPipeline(port_cli.load_matcha(ckpt, "cpu"), device="cpu")
    x, xl = np.ones((2, 8), np.int32), np.full((2,), 8, np.int32)
    for kw in ({}, {"fixed_y_bucket": 64}):
        with pytest.raises(ValueError, match="out of range"):
            pipe.synthesise_batch(x, xl, n_timesteps=1, spks=[0, 4], **kw)
        with pytest.raises(ValueError, match="needs speaker ids"):
            pipe.synthesise_batch(x, xl, n_timesteps=1, **kw)
    with pytest.raises(ValueError, match="out of range"):
        next(pipe.synthesise_corpus([np.ones(5, np.int32)], n_timesteps=1, spk=-1))
