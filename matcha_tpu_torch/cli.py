"""Text -> wav with the PyTorch port: the CLI, the model registry and
model loading, over the synthesis pipeline of ``pipeline.py`` (its paths,
precision modes, replicas and speakers are described there).

Port of ``matcha_tpu/cli.py``'s CLI. It synthesises one utterance at a
time, in length-sorted batches (``--batched``, ``--staged``) or sentence
by sentence (``--long-form``); ``synth_fetch_guarded`` re-runs a
saturated ``--fixed-y-bucket N`` on the dynamic path. ``--batched
--staged`` prints the corpus's frame fill (``corpus_frames_true`` over
``corpus_frames_decoded``: the share of the decoded mel frames that are
speech, not bucket padding), split, how many batches replayed a decode
graph and how many captured one, and with BigVGAN the launches of K4
and the inputs it copied to channels-last first, each when not zero
(``ops/aa_snake.py::LAUNCHES``); ``--trace-spans PATH`` records the
pipeline's spans (``utils/tracing.py``) and writes them as a Chrome trace.
Models are named as in JAX's registry (``--model matcha_ljspeech |
matcha_vctk``, ``--vocoder hifigan_T2_v1 | hifigan_univ_v1 |
bigvgan_v2_22khz_80band_fmax8k_256x``, with each
model's default vocoder, speaking rate and speaker: ``validate_args``) and
read from ``$MATCHA_HOME/matcha_tpu/<name>[.ckpt]``; nothing is
downloaded (the published URLs are named when a file is missing).
``--checkpoint_path`` takes a reference Lightning ``.ckpt`` or the port's
own native checkpoint (``checkpoint_<step>`` or ``last`` with its
``.hparams.json`` beside it); a vocoder file is ``{"generator":
state_dict}``. Every path writes ``<name>.wav``, ``.npy`` and ``.png``.

    python -m matcha_tpu_torch.cli --text "..." --cleaner english_cleaners_no_espeak
"""

import argparse
import os
import sys
import time
import warnings
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from matcha_tpu_torch import resolve_device
from matcha_tpu_torch.convert import fold_hifigan_state_dict
from matcha_tpu_torch.models import bigvgan
from matcha_tpu_torch.models.denoiser import compute_bias_spec
from matcha_tpu_torch.models.hifigan import Generator, HiFiGANConfig
from matcha_tpu_torch.models.hifigan_fused import generator_apply_fused
from matcha_tpu_torch.models.matcha import MatchaTTS, check_speakers
from matcha_tpu_torch.ops import aa_snake
from matcha_tpu_torch.pipeline import (
    HOP,
    SAMPLE_RATE,
    TTSPipeline,
    fetch_fused_host,
    pad_ids,
    speaker_batch,
)
from matcha_tpu_torch.text import intersperse, sequence_to_text, text_to_sequence
from matcha_tpu_torch.text.segment import split_sentences
from matcha_tpu_torch.utils import tracing
from matcha_tpu_torch.utils.checkpoints import load_native_checkpoint
from matcha_tpu_torch.utils.utils import save_plot, write_wav

MATCHA_URLS = {
    "matcha_ljspeech": "https://github.com/shivammehta25/Matcha-TTS-checkpoints/releases/download/v1.0/matcha_ljspeech.ckpt",
    "matcha_vctk": "https://github.com/shivammehta25/Matcha-TTS-checkpoints/releases/download/v1.0/matcha_vctk.ckpt",
}

VOCODER_URLS = {
    "hifigan_T2_v1": "https://github.com/shivammehta25/Matcha-TTS-checkpoints/releases/download/v1.0/generator_v1",
    "hifigan_univ_v1": "https://github.com/shivammehta25/Matcha-TTS-checkpoints/releases/download/v1.0/g_02500000",
    "bigvgan_v2_22khz_80band_fmax8k_256x": "https://huggingface.co/nvidia/bigvgan_v2_22khz_80band_fmax8k_256x/resolve/main/bigvgan_generator.pt",
}
#: the vocoders of ``VOCODER_URLS`` that are BigVGAN generators (the rest are HiFi-GAN v1)
BIGVGAN_VOCODERS = {"bigvgan_v2_22khz_80band_fmax8k_256x": bigvgan.BigVGANConfig()}

MULTISPEAKER_MODEL = {
    "matcha_vctk": {"vocoder": "hifigan_univ_v1", "speaking_rate": 0.85, "spk": 0, "spk_range": (0, 107)}
}

SINGLESPEAKER_MODEL = {"matcha_ljspeech": {"vocoder": "hifigan_T2_v1", "speaking_rate": 0.95, "spk": None}}


def synth_fetch_guarded(pipeline, x, x_lengths, *, fixed_y_bucket=0, **kw):
    """``synthesise_batch`` + host fetch, with the integer fixed-bucket
    saturation guard. An int ``fixed_y_bucket`` replays with no host sync,
    so nothing inside the pipeline can check for clipping: the fetched
    lengths are checked here and, on saturation, this warns and runs the
    length-general dynamic path instead. ``"auto"`` escalates inside
    ``synthesise_batch`` (with its own top-bucket fallback), so it passes
    straight through. Returns ``(out, waveforms, mel_lengths)``, the last
    two on the host."""
    out = pipeline.synthesise_batch(x, x_lengths, fixed_y_bucket=fixed_y_bucket, **kw)
    wavs, mls = fetch_fused_host(out)
    if (fixed_y_bucket and fixed_y_bucket != "auto"
            and int(np.max(mls)) >= int(fixed_y_bucket)):
        warnings.warn(
            f"[-] --fixed-y-bucket {fixed_y_bucket} saturated (predicted mel "
            f"length >= bucket); re-running through the dynamic path so the "
            f"written audio is full-length. Pick a larger bucket, 'auto', "
            f"or --long-form to avoid the retry.", UserWarning)
        out = pipeline.synthesise_batch(x, x_lengths, **kw)
        wavs, mls = fetch_fused_host(out)
    return out, wavs, mls


def process_text(i: int, text: str, cleaner: str = "english_cleaners2"):
    print(f"[{i}] - Input text: {text}")
    seq = intersperse(text_to_sequence(text, [cleaner]), 0)
    x = np.asarray(seq, dtype=np.int32)[None]
    x_lengths = np.asarray([x.shape[-1]], dtype=np.int32)
    x_phones = sequence_to_text(list(x[0]))
    print(f"[{i}] - Phonetised text: {x_phones[1::2]}")
    return {"x_orig": text, "x": x, "x_lengths": x_lengths, "x_phones": x_phones}


# ---------------------------------------------------------------------------
# model loading
# ---------------------------------------------------------------------------


def get_user_data_dir(appname: str = "matcha_tpu") -> Path:
    """``$MATCHA_HOME/<appname>``, else ``~/.local/share/<appname>``."""
    home = os.environ.get("MATCHA_HOME")
    base = Path(home).expanduser() if home is not None else Path.home() / ".local" / "share"
    return base / appname


def _checked(path, url: Optional[str] = None) -> Path:
    path = Path(path)
    if not path.exists():
        published = f"; the published file is {url}" if url else ""
        raise FileNotFoundError(f"checkpoint not found: {path} (nothing is downloaded){published}")
    return path


def _get(d, k, default=None):
    try:
        return d[k]
    except (KeyError, TypeError):
        return default


def matcha_kwargs(hp) -> dict:
    """MatchaTTS constructor arguments from a reference checkpoint's
    ``hyper_parameters``."""
    enc = _get(hp, "encoder")
    dec = _get(hp, "decoder")
    enc_p = _get(enc, "encoder_params")
    dp_p = _get(enc, "duration_predictor_params")
    kwargs = dict(n_vocab=int(_get(hp, "n_vocab", 178)), n_spks=int(_get(hp, "n_spks", 1)),
                  spk_emb_dim=int(_get(hp, "spk_emb_dim", 64)),
                  n_feats=int(_get(hp, "n_feats", 80)))
    if enc_p is not None:
        kwargs.update(
            enc_n_channels=int(_get(enc_p, "n_channels", 192)),
            enc_filter_channels=int(_get(enc_p, "filter_channels", 768)),
            enc_filter_channels_dp=int(_get(enc_p, "filter_channels_dp", 256)),
            enc_n_heads=int(_get(enc_p, "n_heads", 2)),
            enc_n_layers=int(_get(enc_p, "n_layers", 6)),
            enc_kernel_size=int(_get(enc_p, "kernel_size", 3)),
            enc_prenet=bool(_get(enc_p, "prenet", True)),
        )
    if dp_p is not None:
        kwargs.update(dp_kernel_size=int(_get(dp_p, "kernel_size", 3)))
    if dec is not None:
        kwargs.update(
            dec_channels=tuple(_get(dec, "channels", (256, 256))),
            dec_attention_head_dim=int(_get(dec, "attention_head_dim", 64)),
            dec_n_blocks=int(_get(dec, "n_blocks", 1)),
            dec_num_mid_blocks=int(_get(dec, "num_mid_blocks", 2)),
            dec_num_heads=int(_get(dec, "num_heads", 2)),
            dec_act_fn=str(_get(dec, "act_fn", "snakebeta")),
            **{f"dec_{stage}_block_type": str(_get(dec, f"{stage}_block_type", "transformer"))
               for stage in ("down", "mid", "up")},
            dec_conformer_batch_norm=bool(_get(dec, "conformer_batch_norm", False)),
        )
    return kwargs


def load_matcha(checkpoint_path, device=None) -> MatchaTTS:
    """A Matcha checkpoint -> MatchaTTS on ``device``. Either the port's
    native checkpoint (a ``checkpoint_<step>`` or ``last`` file with its
    ``.hparams.json`` beside it): ``MatchaTTS(**hparams["model_kwargs"])``,
    as JAX builds its native ones, so the default (LJSpeech) widths when
    the json names none, which is what the trainers write; a checkpoint of
    other widths then fails the strict load, naming the keys. Or a
    reference Lightning ``.ckpt`` (a trusted file: it is unpickled in
    full, for its hyper-parameters)."""
    path = _checked(checkpoint_path)
    print(f"[!] Loading {path.name}!")
    if Path(f"{path}.hparams.json").exists():
        payload = load_native_checkpoint(str(path))
        kwargs = payload["hparams"].get("model_kwargs", {})
        model = MatchaTTS(**{k: tuple(v) if isinstance(v, list) else v
                             for k, v in kwargs.items()})
        model.load_state_dict(payload["model"])
        print(f"[+] {path.name} loaded!")
        return model.to(resolve_device(device)).eval()
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    sd = dict(ckpt["state_dict"])
    hp = ckpt.get("hyper_parameters", {})
    stats = _get(hp, "data_statistics", {})
    sd.setdefault("mel_mean", torch.tensor(float(_get(stats, "mel_mean", 0.0))))
    sd.setdefault("mel_std", torch.tensor(float(_get(stats, "mel_std", 1.0))))
    model = MatchaTTS(**matcha_kwargs(hp))
    model.load_state_dict(sd)
    print(f"[+] {path.name} loaded!")
    return model.to(resolve_device(device)).eval()


def load_vocoder(checkpoint_path, device=None, name: str = "hifigan_T2_v1"):
    """A published generator file ``{"generator": state_dict}`` of the
    vocoder ``name`` (one of ``VOCODER_URLS``) -> (generator with weight
    norm folded, denoiser bias). HiFi-GAN v1: the bias spectrum of its
    output on a zero mel. BigVGAN (``BIGVGAN_VOCODERS``): the bias is None,
    as BigVGAN's own inference does not denoise."""
    if name not in VOCODER_URLS:
        raise NotImplementedError(
            f"Vocoder {name} not implemented! define a load_<<vocoder_name>> method for it")
    path = _checked(checkpoint_path)
    print(f"[!] Loading {path.name}!")
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    sd = ckpt["generator"] if "generator" in ckpt else ckpt
    big = name in BIGVGAN_VOCODERS
    vocoder = bigvgan.Generator(BIGVGAN_VOCODERS[name]) if big else Generator(HiFiGANConfig())
    vocoder.load_state_dict(fold_hifigan_state_dict(sd))
    device = resolve_device(device)
    vocoder = vocoder.to(device).eval()
    bias = None if big else compute_bias_spec(lambda mel: generator_apply_fused(vocoder, mel),
                                              device=device)
    print(f"[+] {path.name} loaded!")
    return vocoder, bias


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------


def _texts(args) -> list:
    if args.text:
        return [args.text]
    with open(args.file, encoding="utf-8") as f:
        return [line for line in f if line.strip()]


def _rtf(seconds: float, n_samples: int) -> float:
    return seconds * SAMPLE_RATE / max(n_samples, 1)


def _save(folder: Path, name: str, mel: np.ndarray, wav: np.ndarray) -> Path:
    """``<name>.png`` (the mel's plot), ``<name>.npy`` (the mel,
    (n_feats, frames)) and ``<name>.wav``, as JAX's ``save_to_folder``."""
    base = folder / name
    save_plot(mel, base.with_suffix(".png"))
    np.save(base.with_suffix(".npy"), mel)
    write_wav(base.with_suffix(".wav"), wav)
    return base.with_suffix(".wav").resolve()


def _print_rtf_summary(rtfs) -> None:
    print(f"[🍵] Average Matcha-TTS + VOCODER RTF: {np.mean(rtfs):.4f} ± {np.std(rtfs)}")


def resolve_speaker(model: MatchaTTS, spk: Optional[int]) -> Optional[int]:
    """The speaker the CLI and the daemon run, checked against the loaded
    model (``validate_args`` knows only the named models; a custom
    checkpoint may have any ``n_spks``): a multi-speaker model without
    ``--spk`` warns and takes speaker 0 (the ``matcha_vctk`` default); an
    id outside [0, n_spks) exits with the range; a single-speaker model
    warns and ignores ``--spk``."""
    if model.n_spks <= 1:
        if spk is not None:
            warnings.warn(f"[-] Ignoring speaker id {spk} for a single-speaker model", UserWarning)
        return None
    if spk is None:
        warnings.warn("[!] Speaker ID not provided! Using speaker ID 0", UserWarning)
        return 0
    try:
        check_speakers(model.n_spks, [spk])
    except ValueError as e:
        raise SystemExit(f"--spk: {e}") from e
    return int(spk)


def _name(i: int, spk: Optional[int]) -> str:
    """``utterance_<i>``, with ``_speaker_<spk>`` for a multi-speaker run."""
    return f"utterance_{i:03d}" if spk is None else f"utterance_{i:03d}_speaker_{spk:03d}"


def unbatched_synthesis(args, pipeline: TTSPipeline, texts, folder: Path) -> None:
    """One utterance per call: ``utterance_<i>[_speaker_<spk>].wav`` /
    ``.npy``, i from 1."""
    rtfs = []
    for i, text in enumerate(texts, start=1):
        tp = process_text(i, text.strip(), pipeline.cleaner)
        generator = torch.Generator(pipeline.device).manual_seed(args.seed + i)
        t0 = time.perf_counter()
        out, wavs, mls = synth_fetch_guarded(
            pipeline, tp["x"], tp["x_lengths"], n_timesteps=args.steps,
            temperature=args.temperature, length_scale=args.speaking_rate,
            generator=generator, fixed_y_bucket=args.fixed_y_bucket, spks=speaker_batch(args.spk, 1))
        ml = int(mls[0])
        wav = wavs[0, :ml * HOP]
        rtfs.append(_rtf(time.perf_counter() - t0, wav.shape[-1]))
        print(f"[🍵-{i}] Matcha-TTS + VOCODER RTF: {rtfs[-1]:.4f}")
        location = _save(folder, _name(i, args.spk), out["mel"][0, :, :ml].cpu().numpy(), wav)
        print(f"[+] Waveform saved: {location}")
    _print_rtf_summary(rtfs)


def staged_batched_synthesis(args, pipeline: TTSPipeline, texts, folder: Path) -> None:
    """``--batched --staged``: the corpus protocol (``synthesise_corpus``,
    one host copy of lengths per window of batches), writing what
    ``batched_synthesis`` writes; the RTF is the whole corpus's, since
    every encoder pass of a window is launched up front. The noise of every
    batch comes from one generator seeded with ``--seed``."""
    processed = [process_text(i, t.strip(), pipeline.cleaner) for i, t in enumerate(texts)]
    utts = [p["x"][0] for p in processed]
    generator = torch.Generator(pipeline.device).manual_seed(args.seed)
    t0 = time.perf_counter()
    total_samples = 0
    true0, decoded0 = pipeline.corpus_frames_true, pipeline.corpus_frames_decoded
    replays0, captures0 = pipeline.corpus_decode_replays, pipeline.corpus_decode_captures
    k4_0 = dict(aa_snake.LAUNCHES)
    n_batches = 0
    for chunk, out in pipeline.synthesise_corpus(
            utts, n_timesteps=args.steps, temperature=args.temperature,
            length_scale=args.speaking_rate, batch_size=args.batch_size,
            fuse_stages=args.fused_stage, generator=generator, spk=args.spk):
        wavs, mel = out["waveform"].cpu().numpy(), out["mel"].cpu().numpy()
        for row, idx in enumerate(chunk):
            ml = int(out["mel_lengths_host"][row])
            location = _save(folder, _name(idx, args.spk), mel[row, :, :ml],
                             wavs[row, :ml * HOP])
            print(f"[🍵-{idx}] Waveform saved: {location}")
        total_samples += int(out["mel_lengths_host"].sum()) * HOP
        n_batches += 1
    rtf = _rtf(time.perf_counter() - t0, total_samples)
    print(f"[🍵] Corpus Matcha-TTS + VOCODER RTF: {rtf:.4f} ({len(texts)} utterances)")
    true, decoded = (pipeline.corpus_frames_true - true0,
                     pipeline.corpus_frames_decoded - decoded0)
    print(f"[🍵] Corpus frame fill: {100 * true / max(decoded, 1):.1f} % ({true} speech frames "
          f"of {decoded} decoded; the rest pads each batch to its mel bucket)")
    if not args.fused_stage:
        print(f"[🍵] Corpus decode: {pipeline.corpus_decode_replays - replays0} replays, "
              f"{pipeline.corpus_decode_captures - captures0} captures, of {n_batches} batches")
    k4, relayout = (aa_snake.LAUNCHES[k] - k4_0[k] for k in ("aa_snake", "aa_snake_relayout"))
    if k4:
        print(f"[🍵] Corpus K4 (anti-aliased SnakeBeta) launches: {k4} (replays run it uncounted)")
    if relayout:
        print(f"[🍵] Corpus K4 inputs copied to channels-last first: {relayout}")
    _print_rtf_summary([rtf])


def batched_synthesis(args, pipeline: TTSPipeline, texts, folder: Path) -> None:
    """Length-sorted batches of ``--batch_size``, one call each:
    ``utterance_<idx>.wav`` / ``.npy`` with idx the 0-based line, as the
    JAX CLI names them."""
    processed = [process_text(i, t.strip(), pipeline.cleaner) for i, t in enumerate(texts)]
    order = sorted(range(len(processed)), key=lambda i: processed[i]["x"].shape[-1])
    rtfs = []
    for bi, start in enumerate(range(0, len(order), args.batch_size)):
        chunk = order[start:start + args.batch_size]
        x, x_lengths = pad_ids([processed[i]["x"][0] for i in chunk],
                               max(processed[i]["x"].shape[-1] for i in chunk))
        generator = torch.Generator(pipeline.device).manual_seed(args.seed + bi)
        t0 = time.perf_counter()
        out, wavs, mls = synth_fetch_guarded(
            pipeline, x, x_lengths, n_timesteps=args.steps, temperature=args.temperature,
            length_scale=args.speaking_rate, generator=generator,
            fixed_y_bucket=args.fixed_y_bucket, spks=speaker_batch(args.spk, len(chunk)))
        rtfs.append(_rtf(time.perf_counter() - t0, int(np.sum(mls)) * HOP))
        print(f"[🍵-Batch: {bi + 1}] Matcha-TTS + VOCODER RTF: {rtfs[-1]:.4f}")
        mel = out["mel"].cpu().numpy()
        for row, idx in enumerate(chunk):
            ml = int(mls[row])
            location = _save(folder, _name(idx, args.spk), mel[row, :, :ml],
                             wavs[row, :ml * HOP])
            print(f"[🍵-{idx}] Waveform saved: {location}")
    _print_rtf_summary(rtfs)


def long_form_synthesis(args, pipeline: TTSPipeline, text: str, folder: Path) -> None:
    """Sentence-chunked synthesis of a long ``--text``
    (``text/segment.py``): each chunk through the same buckets, the
    waveforms and mels concatenated into ``utterance_long_form``."""
    chunks = split_sentences(text)
    print(f"[🍵] Long-form input: {len(chunks)} chunks")
    wavs, mels = [], []
    t0 = time.perf_counter()
    for ci, chunk in enumerate(chunks):
        tp = process_text(ci, chunk, pipeline.cleaner)
        generator = torch.Generator(pipeline.device).manual_seed(args.seed + ci)
        out, wavs_h, mls_h = synth_fetch_guarded(
            pipeline, tp["x"], tp["x_lengths"], n_timesteps=args.steps,
            temperature=args.temperature, length_scale=args.speaking_rate,
            generator=generator, fixed_y_bucket=args.fixed_y_bucket, spks=speaker_batch(args.spk, 1))
        ml = int(mls_h[0])
        wavs.append(wavs_h[0, :ml * HOP])
        mels.append(out["mel"][0, :, :ml].cpu().numpy())
    wav = np.concatenate(wavs)
    print(f"[🍵] Long-form RTF (incl. vocoder): {_rtf(time.perf_counter() - t0, wav.shape[-1]):.4f}"
          f" for {wav.shape[-1] / SAMPLE_RATE:.1f}s of audio")
    location = _save(folder, "utterance_long_form", np.concatenate(mels, axis=1), wav)
    print(f"[+] Waveform saved: {location}")


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        description="🍵 Matcha-TTS (PyTorch port): text to speech with conditional flow matching")
    parser.add_argument("--model", type=str, default="matcha_ljspeech",
                        choices=list(MATCHA_URLS.keys()),
                        help="Model, read from $MATCHA_HOME/matcha_tpu/<model>.ckpt "
                             "(default: matcha_ljspeech)")
    parser.add_argument("--checkpoint_path", type=str, default=None,
                        help="A custom Matcha checkpoint: a Lightning .ckpt or the port's native "
                             "checkpoint_<step> (its .hparams.json beside it)")
    parser.add_argument("--vocoder", type=str, default=None, choices=list(VOCODER_URLS.keys()),
                        help="Vocoder, read from $MATCHA_HOME/matcha_tpu/<vocoder> (default: the "
                             "model's own; hifigan_univ_v1 for a custom checkpoint)")
    parser.add_argument("--text", type=str, default=None, help="Text to synthesize")
    parser.add_argument("--file", type=str, default=None, help="Text file to synthesize, one utterance per line")
    parser.add_argument("--temperature", type=float, default=0.667, help="Variance of the x0 noise (default: 0.667)")
    parser.add_argument("--speaking_rate", type=float, default=None,
                        help="Higher is slower (default: 0.95 for LJSpeech, 0.85 for VCTK, 1.0 "
                             "for a custom checkpoint)")
    parser.add_argument("--steps", type=int, default=10, help="Number of ODE steps (default: 10)")
    parser.add_argument("--cpu", action="store_true", help="Run on the CPU (default: CUDA)")
    parser.add_argument("--denoiser_strength", type=float, default=0.00025,
                        help="Strength of the vocoder bias denoiser (default: 0.00025)")
    parser.add_argument("--output_folder", type=str, default=os.getcwd(),
                        help="Output folder (default: current dir)")
    parser.add_argument("--batched", action="store_true",
                        help="Synthesize --file in length-sorted batches of --batch_size")
    parser.add_argument("--batch_size", type=int, default=32,
                        help="Batch size, with --batched (default: 32)")
    parser.add_argument("--long-form", action="store_true",
                        help="Synthesize a long --text sentence by sentence into one wav")
    parser.add_argument("--seed", type=int, default=1234, help="Noise seed (default 1234)")
    parser.add_argument("--spk", type=int, default=None,
                        help="Speaker ID of a multi-speaker model, in [0, n_spks) (default 0, "
                             "with a warning); ignored, with a warning, by a single-speaker one")
    parser.add_argument("--cleaner", type=str, default="english_cleaners2",
                        help="Text cleaner (english_cleaners_no_espeak works without espeak)")
    parser.add_argument("--fixed-y-bucket", type=lambda s: s if s == "auto" else int(s), default=0,
                        help="Run the whole text->wav path at this mel bucket as one CUDA graph "
                             "(no host sync; a saturated result re-runs on the dynamic path). "
                             "'auto' = the self-calibrating tightest bucket. 0 = dynamic bucket "
                             "pick (default)")
    parser.add_argument("--no-pcm24-transfer", action="store_true",
                        help="Fixed-bucket path: fetch the waveform as f32 instead of 24-bit "
                             "PCM packed on the device (the written-WAV encoding)")
    parser.add_argument("--staged", action="store_true",
                        help="With --batched: staged corpus synthesis (every batch's encoder "
                             "pass first, one host copy of all predicted lengths, then decode + "
                             "vocode per batch with no other host sync)")
    parser.add_argument("--fused-stage", action="store_true",
                        help="With --staged: run decode + vocode + denoise as one CUDA graph "
                             "per (mel bucket, vocoder bucket) triple instead of separate calls")
    parser.add_argument("--data-parallel", action="store_true",
                        help="Shard batches over ALL visible GPUs (data-parallel serving: the "
                             "models replicate once per GPU, each batch's rows split over the "
                             "replicas). Pick --batch_size a multiple of the GPU count. A no-op "
                             "with one GPU")
    parser.add_argument("--vocoder-chunk", type=int, default=0,
                        help="Run the vocoder on N-frame mel windows (with a receptive-field "
                             "halo, one after another) to bound its activation memory. 0 = the "
                             "whole utterance (default)")
    parser.add_argument("--full-precision", action="store_true",
                        help="Turn TF32 off for cuDNN convolutions and for matmuls, so that f32 "
                             "runs in full f32. Without it torch's defaults stand: cuDNN "
                             "convolutions in TF32, matmuls in full f32")
    parser.add_argument("--bf16-latency", action="store_true",
                        help="With --fixed-y-bucket: run the CFM Euler loop on a bf16 copy of the "
                             "decoder and the vocoder in bf16. The encoder and the durations stay "
                             "f32, so the mel lengths equal the f32 path's")
    parser.add_argument("--bf16-vocoder", action="store_true",
                        help="Run the vocoder with bf16 weights and activations on every path "
                             "(cuDNN convs in bf16; the fused MRF kernel computes in f32 inside). "
                             "The clip, the denoiser and the PCM packing stay f32")
    parser.add_argument("--no-pallas-vocoder", action="store_true",
                        help="Run every vocoder stage as cuDNN convs instead of the fused MRF "
                             "kernel on the narrow stages")
    parser.add_argument("--trace-spans", type=str, default=None, metavar="PATH",
                        help="Record the pipeline's spans (utils/tracing.py: pipeline.*, "
                             "models.*) and write them as a Chrome trace JSON file at the end")
    return parser


def assert_required_models_available(args) -> dict:
    """The local files of ``args.model`` (or ``args.checkpoint_path``) and
    ``args.vocoder`` under ``$MATCHA_HOME/matcha_tpu/``: {"matcha": path,
    "vocoder": path}. A missing file raises FileNotFoundError naming its
    published URL; nothing is downloaded."""
    home = get_user_data_dir()
    if args.checkpoint_path is not None:
        model_path = _checked(args.checkpoint_path)
    else:
        model_path = _checked(home / f"{args.model}.ckpt", MATCHA_URLS[args.model])
    vocoder_path = _checked(home / f"{args.vocoder}", VOCODER_URLS[args.vocoder])
    return {"matcha": model_path, "vocoder": vocoder_path}


def _require(ok: bool, message: str) -> None:
    if not ok:
        raise SystemExit(message)


def validate_args(args):
    """JAX's argument checks: each model's default vocoder, speaking rate
    and speaker, the "I would suggest passing --vocoder" warnings, the
    VCTK speaker range, and ``--spk`` ignored for LJSpeech; a custom
    checkpoint takes ``hifigan_univ_v1`` and rate 1.0 by default. An
    invalid argument exits with JAX's message."""
    _require(bool(args.text or args.file), "Either text or file must be provided Matcha-T(ea)TTS "
             "need sometext to whisk the waveforms.")
    _require(args.temperature >= 0, "Sampling temperature cannot be negative")
    _require(args.steps > 0, "Number of ODE steps must be greater than 0")

    if args.checkpoint_path is None:
        if args.model in SINGLESPEAKER_MODEL:
            args = _validate_single_speaker(args)
        if args.model in MULTISPEAKER_MODEL:
            args = _validate_multispeaker(args)
    else:
        if args.vocoder != "hifigan_univ_v1":
            warnings.warn(
                "[-] Using custom model checkpoint! I would suggest passing --vocoder "
                "hifigan_univ_v1, unless the custom model is trained on LJ Speech.", UserWarning)
        if args.speaking_rate is None:
            args.speaking_rate = 1.0
        if args.vocoder is None:
            args.vocoder = "hifigan_univ_v1"

    if args.batched:
        _require(args.batch_size > 0, "Batch size must be greater than 0")
    _require(args.speaking_rate > 0, "Speaking rate must be greater than 0")
    return args


def _validate_multispeaker(args):
    info = MULTISPEAKER_MODEL[args.model]
    if args.vocoder is not None:
        if args.vocoder != info["vocoder"]:
            warnings.warn(f"[-] Using {args.model} model! I would suggest passing --vocoder "
                          f"{info['vocoder']}", UserWarning)
    else:
        args.vocoder = info["vocoder"]
    if args.speaking_rate is None:
        args.speaking_rate = info["speaking_rate"]
    spk_range = info["spk_range"]
    if args.spk is not None:
        _require(spk_range[0] <= args.spk <= spk_range[-1],
                 f"Speaker ID must be between {spk_range} for this model.")
    else:
        warnings.warn(f"[!] Speaker ID not provided! Using speaker ID {info['spk']}", UserWarning)
        args.spk = info["spk"]
    return args


def _validate_single_speaker(args):
    info = SINGLESPEAKER_MODEL[args.model]
    if args.vocoder is not None:
        if args.vocoder != info["vocoder"]:
            warnings.warn(f"[-] Using {args.model} model! I would suggest passing --vocoder "
                          f"{info['vocoder']}", UserWarning)
    else:
        args.vocoder = info["vocoder"]
    if args.speaking_rate is None:
        args.speaking_rate = info["speaking_rate"]
    if args.spk != info["spk"]:
        warnings.warn(f"[-] Ignoring speaker id {args.spk} for {args.model}", UserWarning)
        args.spk = info["spk"]
    return args


def print_config(args) -> None:
    print("[!] Configurations: ")
    print(f"\t- Model: {args.model}")
    print(f"\t- Vocoder: {args.vocoder}")
    print(f"\t- Temperature: {args.temperature}")
    print(f"\t- Speaking rate: {args.speaking_rate}")
    print(f"\t- Number of ODE steps: {args.steps}")
    print(f"\t- Speaker: {args.spk}")


def data_parallel_devices(data_parallel: bool, device: torch.device) -> Optional[list]:
    """``--data-parallel``: every visible GPU, one replica each, or None
    (one device: the flag is a no-op, as JAX's with a 1-device mesh)."""
    n = torch.cuda.device_count() if device.type == "cuda" else 1
    if not data_parallel or n < 2:
        return None
    print(f"[+] Data-parallel serving over {n} devices")
    return [torch.device("cuda", i) for i in range(n)]


def cli(argv=None):
    args = validate_args(build_parser().parse_args(argv))
    if args.vocoder_chunk < 0:
        raise SystemExit("--vocoder-chunk must be >= 0")
    device = resolve_device("cpu" if args.cpu else None)
    if args.full_precision:  # JAX's jax_default_matmul_precision = "highest"
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    print(f"[+] Device: {device}")
    print_config(args)
    paths = assert_required_models_available(args)
    if args.checkpoint_path is not None:
        print(f"[🍵] Loading custom model from {args.checkpoint_path}")
        args.model = "custom_model"

    model = load_matcha(paths["matcha"], device)
    args.spk = resolve_speaker(model, args.spk)
    vocoder, bias = load_vocoder(paths["vocoder"], device, name=args.vocoder)
    devices = data_parallel_devices(args.data_parallel, device)
    pipeline = TTSPipeline(model, vocoder, bias, cleaner=args.cleaner,
                           device=devices[0] if devices else device,
                           denoiser_strength=args.denoiser_strength,
                           pcm24_transfer=not args.no_pcm24_transfer,
                           vocoder_chunk=args.vocoder_chunk, vocoder_bf16=args.bf16_vocoder,
                           vocoder_pallas=not args.no_pallas_vocoder,
                           bf16_latency=args.bf16_latency, devices=devices)

    texts = _texts(args)
    folder = Path(args.output_folder)
    folder.mkdir(parents=True, exist_ok=True)
    if args.trace_spans:
        tracing.enable()
    try:
        if args.long_form and args.text:
            long_form_synthesis(args, pipeline, args.text, folder)
        elif len(texts) == 1 or not args.batched:
            unbatched_synthesis(args, pipeline, texts, folder)
        elif args.staged:
            staged_batched_synthesis(args, pipeline, texts, folder)
        else:
            batched_synthesis(args, pipeline, texts, folder)
    finally:
        if args.trace_spans:
            tracing.disable()
            n = tracing.write_chrome(args.trace_spans)
            print(f"[+] {n} spans written to {args.trace_spans}")


if __name__ == "__main__":
    cli(sys.argv[1:])
