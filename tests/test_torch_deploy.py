"""The port's ``torch.export`` deployment (``deploy/export.py``,
``deploy/infer.py``) against the JAX package's export function.

Weights come from flax init (jitted) of the tiny Matcha of
``tests/test_cli_e2e.py`` and the tiny HiFi-GAN of
``tests/test_deploy_and_vocoder.py``, bridged into the port with
``convert.py``. The port's artifact is exported, saved, reloaded and run
on the CPU against JAX's ``get_exportable_fn`` (jitted, not
``jax.export``-ed), with the noise z drawn by JAX from its key and handed
in: mel lengths EQUAL, the mel within 1e-5 and the waveform within 1e-4
(f32 sums in another order through the U-Net and the vocoder).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from matcha_tpu.deploy import export as jax_export
from matcha_tpu.models import MatchaTTS as JaxMatchaTTS
from matcha_tpu.models.hifigan import Generator as JaxGenerator
from matcha_tpu_torch import cli as port_cli
from matcha_tpu_torch.convert import hifigan_state_dict, matcha_state_dict
from matcha_tpu_torch.deploy import export as port_export
from matcha_tpu_torch.deploy import infer as port_infer
from matcha_tpu_torch.models.hifigan import Generator, HiFiGANConfig
from matcha_tpu_torch.models.matcha import MatchaTTS
from matcha_tpu_torch.utils.checkpoints import save_native_checkpoint
from tests.test_cli_e2e import TINY
from tests.test_deploy_and_vocoder import TINY_HIFI

MEL_TOL, WAV_TOL = 1e-5, 1e-4
B, T_X, T_Y, STEPS = 2, 24, 96, 1
CLEANER = "english_cleaners_no_espeak"


@pytest.fixture(scope="module", autouse=True)
def two_threads():
    """torch on 2 threads: the suite runs 6 workers on the host's cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def pair():
    """JAX and port models (Matcha and vocoder) with the same weights."""
    jm = JaxMatchaTTS(**TINY)
    x, xl = jnp.ones((1, 16), jnp.int32), jnp.asarray([16], jnp.int32)
    init = jax.jit(functools.partial(jm.init, n_timesteps=1, y_max_length=32,
                                     method=JaxMatchaTTS.synthesise))
    variables = init({"params": jax.random.PRNGKey(1)}, x, xl, jax.random.PRNGKey(0))
    port = MatchaTTS(**TINY)
    port.load_state_dict(matcha_state_dict(variables, n_down_blocks=2,
                                           num_mid_blocks=TINY["dec_num_mid_blocks"]))
    jvoc = JaxGenerator(TINY_HIFI)
    voc_params = jax.jit(jvoc.init)(jax.random.PRNGKey(2), jnp.zeros((1, 16, 80)))
    pvoc = Generator(HiFiGANConfig(**{k: getattr(TINY_HIFI, k) for k in (
        "upsample_rates", "upsample_kernel_sizes", "upsample_initial_channel",
        "resblock_kernel_sizes", "resblock_dilation_sizes", "num_mels")}))
    pvoc.load_state_dict(hifigan_state_dict(voc_params))
    return {"jax": (jm, variables, jvoc, voc_params), "port": (port.eval(), pvoc.eval())}


def _inputs(seed: int = 0):
    rng = np.random.default_rng(seed)
    x = rng.integers(1, TINY["n_vocab"], size=(B, T_X)).astype(np.int32)
    xl = np.array([T_X, T_X - 9], np.int32)
    x[1, xl[1]:] = 0
    return x, xl


@pytest.mark.parametrize("vocoder", [False, True], ids=["mel", "wav"])
def test_artifact_matches_jax_export_fn(pair, tmp_path, vocoder):
    """The exported, saved and reloaded artifact at B = 2 against JAX's
    export function on the same weights and z: lengths EQUAL; the mel
    within 1e-5, the waveform (TINY_HIFI) within 1e-4."""
    jm, variables, jvoc, voc_params = pair["jax"]
    port, pvoc = pair["port"]
    x, xl = _inputs()
    key = jax.random.PRNGKey(7)
    # a length scale whose products with whole frame counts are exact in
    # f32, so that the two packages' cumsums of the durations agree bit for
    # bit (with 1.1 they round differently and move a frame of the path)
    scales = np.array([0.667, 1.5], np.float32)
    fn = jax_export.get_exportable_fn(jm, (jvoc, voc_params) if vocoder else None,
                                      n_timesteps=STEPS, T_y=T_Y)
    want, want_len = jax.jit(fn)(variables, jnp.asarray(x), jnp.asarray(xl),
                                 jnp.asarray(scales), key)
    z = np.asarray(jax.random.normal(key, (B, T_Y, TINY["n_feats"])))

    path = str(tmp_path / "a.pt2")
    port_export.export_graph(port, path, B, T_X, T_Y, STEPS, pvoc if vocoder else None)
    module = torch.export.load(path).module()
    got, got_len = module(torch.from_numpy(x).long(), torch.from_numpy(xl).long(),
                          torch.from_numpy(scales), torch.from_numpy(z))
    np.testing.assert_array_equal(got_len.numpy(), np.asarray(want_len))
    assert 4 < int(got_len.min()) and int(got_len.max()) < (T_Y * 8 if vocoder else T_Y)
    want = np.asarray(want)
    assert got.shape == want.shape == ((B, T_Y * 8) if vocoder else (B, 80, T_Y))
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=0,
                               atol=WAV_TOL if vocoder else MEL_TOL)


@pytest.fixture(scope="module")
def artifacts(pair, tmp_path_factory):
    """A native checkpoint of the port's weights, a B = 4 mel artifact
    exported through ``main`` (as ``python -m ...deploy.export --cpu``)
    and a B = 4 artifact with the tiny vocoder embedded."""
    root = tmp_path_factory.mktemp("deploy")
    port, pvoc = pair["port"]
    ckpt = save_native_checkpoint(str(root / "ckpt"), port, {"model_kwargs": TINY})
    mel_art, wav_art = str(root / "mel.pt2"), str(root / "wav.pt2")
    port_export.main([ckpt, mel_art, "--cpu", "--batch", "4", "--t-x", "64", "--t-y", "64",
                      "--n-timesteps", str(STEPS)])
    port_export.export_graph(port, wav_art, 4, 64, 64, STEPS, pvoc)
    lines = root / "lines.txt"
    lines.write_text("\n".join(f"hello world number {i}" for i in range(6)), encoding="utf-8")
    return {"root": root, "ckpt": ckpt, "mel": mel_art, "wav": wav_art, "lines": str(lines)}


def _read_wavs(folder):
    from matcha_tpu_torch.utils.utils import read_wav

    return {p.name: read_wav(str(p))[0] for p in sorted(folder.glob("*.wav"))}


def test_infer_three_output_modes(pair, artifacts, tmp_path, monkeypatch):
    """Six lines through B = 4 artifacts (two batches, the second padded):
    ``output_1..6`` as .npy + .png from the mel artifact, as .wav from the
    embedded vocoder and from the external one; the embedded and the
    external vocoder's wavs agree within 1e-6 (the same plain generator on
    the same mel, one inside the exported graph); ``--temperature`` and
    ``--speaking-rate`` reach ``scales``."""
    _, pvoc = pair["port"]
    seen = []
    real = port_infer.with_weights

    def spy(ep, model):
        module = real(ep, model)
        return lambda x, xl, scales, z: (seen.append(scales.tolist()), module(x, xl, scales, z))[1]

    monkeypatch.setattr(port_infer, "with_weights", spy)
    common = [artifacts["ckpt"], "--file", artifacts["lines"], "--cleaner", CLEANER,
              "--temperature", "0.5", "--speaking-rate", "1.25"]
    out_mel, out_wav, out_ext = tmp_path / "mel", tmp_path / "wav", tmp_path / "ext"
    rtfs = port_infer.main([artifacts["mel"], *common, "--output-dir", str(out_mel)])
    assert len(rtfs) == 2 and all(np.isfinite(rtfs))
    names = [f"output_{i + 1}" for i in range(6)]
    assert sorted(p.stem for p in out_mel.glob("*.npy")) == names
    assert sorted(p.stem for p in out_mel.glob("*.png")) == names
    assert not list(out_mel.glob("*.wav"))

    port_infer.main([artifacts["wav"], *common, "--output-dir", str(out_wav)])
    monkeypatch.setattr(port_cli, "load_vocoder", lambda path, device, name: (pvoc, None))
    port_infer.main([artifacts["mel"], *common, "--output-dir", str(out_ext),
                     "--vocoder-name", "hifigan_T2_v1"])
    embedded, external = _read_wavs(out_wav), _read_wavs(out_ext)
    assert sorted(embedded) == sorted(external) == [f"{n}.wav" for n in names]
    for name in embedded:
        mel = np.load(out_mel / name.replace(".wav", ".npy"))
        assert embedded[name].shape == external[name].shape == (mel.shape[1] * 8,)
        np.testing.assert_allclose(embedded[name], external[name], rtol=0, atol=1e-6)
    assert len(seen) == 6 and all(np.allclose(s, [0.5, 1.25]) for s in seen)


def test_infer_refuses_a_checkpoint_of_other_widths(artifacts, tmp_path):
    """The artifact's Matcha weights are replaced by a strict load: a
    checkpoint of other widths raises, naming the mismatch."""
    other = dict(TINY, enc_n_channels=24)
    ckpt = save_native_checkpoint(str(tmp_path / "c"), MatchaTTS(**other),
                                  {"model_kwargs": other})
    with pytest.raises(RuntimeError, match="size mismatch"):
        port_infer.main([artifacts["mel"], ckpt, "--text", "hi", "--cleaner", CLEANER,
                         "--output-dir", str(tmp_path / "o")])


def test_export_without_a_card_raises(artifacts, tmp_path, monkeypatch):
    """No GPU and no ``--cpu``: the export refuses instead of exporting a
    CPU graph."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_export.main([artifacts["ckpt"], str(tmp_path / "x.pt2")])
