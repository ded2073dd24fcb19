"""The gradio demo UI, on the port's synthesis backend.

The port of ``matcha_tpu/app.py``: two named models (LJSpeech and VCTK)
with switching at run time, sliders for the ODE steps, speaking rate,
temperature and speaker, a two-stage phonemise -> synthesise event chain,
and a mel plot with the audio out. Synthesis is ``TTSPipeline.
synthesise_batch`` on the card (the fused-MRF vocoder), with the noise
from ``torch.Generator(seed)`` on the pipeline's device; ``args.cpu``
runs it on the CPU. ``gradio`` is optional: everything but ``main()``
works without it.
"""

import tempfile
from argparse import Namespace
from pathlib import Path

import numpy as np
import torch

from matcha_tpu_torch.cli import (
    assert_required_models_available,
    get_user_data_dir,
    load_matcha,
    load_vocoder,
    process_text,
)
from matcha_tpu_torch.pipeline import HOP, SAMPLE_RATE, TTSPipeline
from matcha_tpu_torch.utils.utils import save_plot

LOCATION = Path(get_user_data_dir())

DEFAULT_TEXT = "The Secret Service believed that it was very doubtful that any President would ride regularly in a vehicle with a fixed top, even though transparent."

args = Namespace(
    cpu=False,
    model="matcha_ljspeech",
    vocoder="hifigan_T2_v1",
    spk=0,
)

CURRENTLY_LOADED_MODEL = args.model
_pipelines = {}


def load_model(model_name: str, vocoder_name: str) -> TTSPipeline:
    if model_name in _pipelines:
        return _pipelines[model_name]
    device = "cpu" if args.cpu else None
    model_args = Namespace(model=model_name, vocoder=vocoder_name, checkpoint_path=None)
    paths = assert_required_models_available(model_args)
    model = load_matcha(paths["matcha"], device)
    vocoder, bias = load_vocoder(paths["vocoder"], device, name=vocoder_name)
    pipeline = TTSPipeline(model, vocoder, bias, device=device)
    _pipelines[model_name] = pipeline
    return pipeline


def load_model_ui(model_type: str):
    """Switch between the single- and the multi-speaker model (the
    reference's radio-button handler)."""
    global CURRENTLY_LOADED_MODEL
    if model_type == "multi-speaker":
        name, voc, spk = "matcha_vctk", "hifigan_univ_v1", 0
    else:
        name, voc, spk = "matcha_ljspeech", "hifigan_T2_v1", None
    load_model(name, voc)
    CURRENTLY_LOADED_MODEL = name
    return name, spk


def process_text_gradio(text: str):
    output = process_text(1, text)
    return output["x_phones"][1::2], output["x"], output["x_lengths"]


def synthesise_mel(text, text_length, n_timesteps, mel_temp, length_scale, spk=None,
                   model_name=None, seed=1234):
    pipeline = _pipelines[model_name or CURRENTLY_LOADED_MODEL]
    spks = None if spk is None or spk < 0 else np.asarray([spk], np.int32)
    out = pipeline.synthesise_batch(
        np.asarray(text), np.asarray(text_length), n_timesteps=int(n_timesteps),
        temperature=float(mel_temp), length_scale=float(length_scale),
        generator=torch.Generator(pipeline.device).manual_seed(seed), spks=spks)
    ml = int(out["mel_lengths"][0])
    mel = out["mel"][0, :, :ml].cpu().numpy()
    wav = out["waveform"][0, :ml * HOP].cpu().numpy()
    with tempfile.NamedTemporaryFile(suffix=".png", delete=False) as fp:
        save_plot(mel, fp.name)
        plot_path = fp.name
    return plot_path, (SAMPLE_RATE, wav)


# example sentences for the cached-examples gallery (rendered once at launch)
EXAMPLE_TEXTS = [
    "The quick brown fox jumps over the lazy dog while the band plays on.",
    "Conditional flow matching turns noise into speech in only a handful of steps.",
    "Tensor processing units multiply matrices faster than you can say spectrogram.",
    "It rained all night, and by morning the harbour had vanished into fog.",
    "Please remember to water the plants before you leave for the station.",
]


def synthesise_example(text: str, n_timesteps: int = 10, mel_temp: float = 0.667,
                       length_scale: float = 0.95, spk: int = -1):
    """Phonemise and synthesise in one call, for gradio's cached examples."""
    phones, x, xl = process_text_gradio(text)
    plot_path, audio = synthesise_mel(x, xl, n_timesteps, mel_temp, length_scale,
                                      spk if spk >= 0 else None)
    return phones, plot_path, audio


def main() -> None:
    try:
        import gradio as gr
    except ImportError as e:
        raise RuntimeError(
            "gradio is not installed in this environment. The app's synthesis "
            "backend (load_model / synthesise_mel) works without it; install "
            "gradio to serve the UI, or use the matcha-tts CLI."
        ) from e

    load_model("matcha_ljspeech", "hifigan_T2_v1")

    with gr.Blocks(title="🍵 Matcha-TTS (PyTorch port)") as demo:
        gr.Markdown("# 🍵 Matcha-TTS: A fast TTS architecture with conditional flow matching — PyTorch port")
        with gr.Row():
            model_type = gr.Radio(["single-speaker", "multi-speaker"], value="single-speaker", label="Model type")
            model_name = gr.Textbox(value="matcha_ljspeech", label="Loaded model", interactive=False)
        text = gr.Textbox(value=DEFAULT_TEXT, label="Text to synthesise")
        phonemes = gr.Textbox(label="Phonetised text", interactive=False)
        with gr.Row():
            n_timesteps = gr.Slider(1, 100, value=10, step=1, label="Number of ODE steps")
            length_scale = gr.Slider(0.5, 1.5, value=0.95, step=0.05, label="Length scale (speaking rate)")
            mel_temp = gr.Slider(0.0, 2.0, value=0.667, step=0.016675, label="Sampling temperature")
            spk_slider = gr.Slider(-1, 107, value=-1, step=1, label="Speaker ID (-1 = single-speaker)")
        synth_btn = gr.Button("Synthesise")
        mel_image = gr.Image(label="Mel spectrogram", interactive=False)
        audio = gr.Audio(label="Synthesised audio", autoplay=True)

        x_state = gr.State()
        xl_state = gr.State()

        gr.Examples(
            examples=[[t] for t in EXAMPLE_TEXTS],
            inputs=[text],
            outputs=[phonemes, mel_image, audio],
            fn=lambda t: synthesise_example(t),
            cache_examples=True,
        )

        model_type.change(load_model_ui, inputs=[model_type], outputs=[model_name, spk_slider])
        synth_btn.click(
            fn=process_text_gradio, inputs=[text], outputs=[phonemes, x_state, xl_state],
        ).then(
            fn=synthesise_mel,
            inputs=[x_state, xl_state, n_timesteps, mel_temp, length_scale, spk_slider, model_name],
            outputs=[mel_image, audio],
        )

    demo.queue().launch()


if __name__ == "__main__":
    main()
