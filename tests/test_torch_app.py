"""The port's app backend and its CLI on named and native checkpoints.

On the fabricated reference-format checkpoints of
``tests/test_cli_e2e.py`` (the tiny Matcha with the full-width HiFi-GAN
v1), on the CPU:

* the app's ``main()`` builds its UI on ``tests/test_app_gradio.py``'s
  structural fake of gradio, and its two-stage click chain synthesises;
  the mel lengths equal those of JAX's ``synthesise_mel`` for the same
  text (durations do not depend on the noise): EQUAL;
* without gradio ``main()`` raises JAX's message;
* the CLI loads the port's native checkpoint of the same weights, and
  its mel EQUALS the ``.ckpt`` route's on the same seed (one process,
  the same weights and noise); every CLI mode writes a ``.png`` beside
  each ``.npy`` and ``.wav`` (the dynamic and staged modes here, the
  others in ``tests/test_torch_fused.py``).
"""

import sys

import numpy as np
import pytest
import torch

from matcha_tpu import app as jax_app
from matcha_tpu_torch import app as port_app
from matcha_tpu_torch import cli as port_cli
from matcha_tpu_torch.utils.checkpoints import save_native_checkpoint
from tests.test_app_gradio import make_fake_gradio
from tests.test_cli_e2e import fabricated_ckpts  # noqa: F401 (module fixture)

CLEANER = "english_cleaners_no_espeak"
TEXT = "A short line for the smoke test."


@pytest.fixture(scope="module", autouse=True)
def two_threads():
    """torch on 2 threads: the suite runs 6 workers on the host's cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


@pytest.fixture
def app(fabricated_ckpts, monkeypatch):  # noqa: F811
    """The port's app on the CPU, reading the fabricated checkpoints, its
    phonemiser on the espeak-free cleaner (same id space)."""
    monkeypatch.setenv("MATCHA_HOME", fabricated_ckpts)
    monkeypatch.setattr(port_app.args, "cpu", True)
    monkeypatch.setattr(port_app, "process_text",
                        lambda i, t: port_cli.process_text(i, t, CLEANER))
    monkeypatch.setattr(port_app, "DEFAULT_TEXT", TEXT)
    monkeypatch.setattr(port_app, "EXAMPLE_TEXTS", ["Hello from the cached example."])
    monkeypatch.setattr(port_app, "_pipelines", {})
    return port_app


def test_app_main_builds_ui_and_click_chain_synthesises(app, monkeypatch):
    """The UI graph is built and launched, the cached example renders, the
    click chain (phonemise -> synthesise) gives a finite wav of
    mel_length * 256 samples and a .png, and the model switch is wired (the
    VCTK checkpoint is absent, so it fails naming the file)."""
    record = {}
    monkeypatch.setitem(sys.modules, "gradio", make_fake_gradio(record))
    app.main()
    assert record.get("queued") and record.get("launched")
    labels = [lbl for _, lbl in record["components"] if lbl]
    assert "Text to synthesise" in labels and "Number of ODE steps" in labels
    phones, plot_path, (sr, wav) = record["example_render"]
    assert phones and plot_path.endswith(".png") and sr == 22050 and wav.size > 0

    (fn1, _, _), = record["click"]
    (fn2, _, _), = record["then"]
    phones, x, xl = fn1(app.DEFAULT_TEXT)
    assert len(phones) > 0
    plot_path, (sr, wav) = fn2(x, xl, 2, 0.667, 1.0, -1, "matcha_ljspeech")
    assert sr == 22050 and np.isfinite(wav).all()
    ml = app._pipelines["matcha_ljspeech"].synthesise_batch(
        x, xl, n_timesteps=1, length_scale=1.0)["mel_lengths"]
    assert wav.size == int(ml[0]) * 256
    with open(plot_path, "rb") as f:
        assert f.read(8) == b"\x89PNG\r\n\x1a\n"

    (fn_change, _, _), = record["change"]
    with pytest.raises(FileNotFoundError, match="matcha_vctk.ckpt"):
        fn_change("multi-speaker")
    assert app.CURRENTLY_LOADED_MODEL == "matcha_ljspeech"


def test_app_mel_lengths_match_jax(app, fabricated_ckpts, monkeypatch):  # noqa: F811
    """``synthesise_mel`` on the same text at a speaking rate of 1.5: the
    wav length (mel_length * 256) equals JAX's ``synthesise_mel``'s."""
    monkeypatch.setattr(jax_app, "_pipelines", {})
    phones, x, xl = app.process_text_gradio(TEXT)
    app.load_model("matcha_ljspeech", "hifigan_T2_v1")
    jax_app.load_model("matcha_ljspeech", "hifigan_T2_v1")
    _, (_, got) = app.synthesise_mel(x, xl, 1, 0.667, 1.5, model_name="matcha_ljspeech")
    _, (_, want) = jax_app.synthesise_mel(x, xl, 1, 0.667, 1.5, model_name="matcha_ljspeech")
    assert got.shape == want.shape and got.size > 0


def test_app_main_without_gradio_raises_jax_message(app, monkeypatch):
    monkeypatch.setitem(sys.modules, "gradio", None)
    with pytest.raises(RuntimeError, match="gradio is not installed in this environment"):
        app.main()


@pytest.fixture(scope="module")
def native_ckpt(fabricated_ckpts, tmp_path_factory):  # noqa: F811
    """The fabricated ``.ckpt``'s weights as the port's native checkpoint
    (its widths in ``model_kwargs``)."""
    home = f"{fabricated_ckpts}/matcha_tpu"
    ckpt = torch.load(f"{home}/matcha_ljspeech.ckpt", map_location="cpu", weights_only=False)
    model = port_cli.load_matcha(f"{home}/matcha_ljspeech.ckpt", "cpu")
    kwargs = port_cli.matcha_kwargs(ckpt["hyper_parameters"])
    return save_native_checkpoint(str(tmp_path_factory.mktemp("native")), model,
                                  {"model_kwargs": kwargs})


# the fixed-bucket, batched and long-form modes write their .png in
# tests/test_torch_fused.py::test_cli_modes_on_the_cpu_load_no_jax
CLI_MODES = {
    "unbatched": ["--text", "Hello world."],
    "staged": ["--batched", "--staged", "--batch_size", "2"],
}


@pytest.mark.parametrize("mode", list(CLI_MODES))
def test_cli_native_checkpoint_and_png(fabricated_ckpts, native_ckpt, tmp_path,  # noqa: F811
                                       monkeypatch, mode):
    """The CLI on the native checkpoint (``--checkpoint_path``) and on the
    named model's ``.ckpt`` (``--model matcha_ljspeech``): the same files
    (a .png, .npy and .wav each) and EQUAL mels."""
    monkeypatch.setenv("MATCHA_HOME", fabricated_ckpts)
    lines = tmp_path / "in.txt"
    lines.write_text("Hello world.\nA second line here.\n", encoding="utf-8")
    texts = CLI_MODES[mode] if "--text" in CLI_MODES[mode] else CLI_MODES[mode] + [
        "--file", str(lines)]
    common = [*texts, "--cleaner", CLEANER, "--steps", "1", "--cpu", "--seed", "5",
              "--vocoder", "hifigan_T2_v1", "--speaking_rate", "0.95"]
    port_cli.cli(["--model", "matcha_ljspeech", *common, "--output_folder", str(tmp_path / "a")])
    port_cli.cli(["--checkpoint_path", native_ckpt, *common,
                  "--output_folder", str(tmp_path / "b")])
    names = sorted(p.name for p in (tmp_path / "a").iterdir())
    assert names == sorted(p.name for p in (tmp_path / "b").iterdir())
    stems = {n.rsplit(".", 1)[0] for n in names}
    assert stems and names == sorted(f"{s}.{e}" for s in stems for e in ("npy", "png", "wav"))
    for s in stems:
        np.testing.assert_array_equal(np.load(tmp_path / "a" / f"{s}.npy"),
                                      np.load(tmp_path / "b" / f"{s}.npy"))
