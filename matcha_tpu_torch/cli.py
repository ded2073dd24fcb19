"""Text -> wav with the PyTorch port: the synthesis pipeline and its CLI.

Port of ``matcha_tpu/cli.py``'s two synthesis paths:
- the dynamic path: encode -> host pick of the mel bucket -> decode ->
  slice to the finer vocoder bucket -> vocode (the fused-MRF generator)
  -> clip -> denoise -> optional 24-bit PCM packing;
- the fixed-bucket path (``fixed_y_bucket``, CLI ``--fixed-y-bucket``):
  the whole text -> wav body at one mel bucket, one CUDA graph per
  bucket on a GPU (``fused.py``), with the self-calibrating ``"auto"``
  bucket, its saturation escalation and the top-bucket fallback to the
  dynamic path.
The CLI synthesises one utterance at a time, in length-sorted batches
(``--batched``) or sentence by sentence (``--long-form``). Checkpoints
are the reference formats (a Lightning ``.ckpt`` for Matcha,
``{"generator": state_dict}`` for HiFi-GAN), read from
``$MATCHA_HOME/matcha_tpu/`` or a given path; nothing is downloaded.

    python -m matcha_tpu_torch.cli --text "..." --cleaner english_cleaners_no_espeak
"""

import argparse
import collections
import os
import sys
import time
import warnings
from pathlib import Path
from typing import Callable, Optional, Union

import numpy as np
import torch

from matcha_tpu_torch import resolve_device
from matcha_tpu_torch.convert import fold_hifigan_state_dict
from matcha_tpu_torch.fused import FusedGraph, _pack_pcm24
from matcha_tpu_torch.models.denoiser import compute_bias_spec, denoise
from matcha_tpu_torch.models.hifigan import Generator, HiFiGANConfig
from matcha_tpu_torch.models.hifigan_fused import fused_stage_weights, generator_apply_fused
from matcha_tpu_torch.models.matcha import MatchaTTS
from matcha_tpu_torch.text import intersperse, sequence_to_text, text_to_sequence
from matcha_tpu_torch.text.segment import split_sentences
from matcha_tpu_torch.utils.utils import PCM24_SCALE, write_wav

X_BUCKETS = (32, 64, 96, 128, 192, 256, 384, 512, 768, 1024)
Y_BUCKETS = (128, 256, 384, 512, 768, 1024, 1536, 2048)
# The vocoder runs on a finer 128-frame grid: the decode bucket's padding
# tail is sliced off before the most expensive stage.
VOC_BUCKETS = tuple(range(128, 2049, 128))
HOP = 256
SAMPLE_RATE = 22050


def pick_bucket(n: int, buckets) -> int:
    for b in buckets:
        if n <= b:
            return b
    return ((n + 63) // 64) * 64  # beyond the table: round to 64


def _unpack_pcm24(arr: np.ndarray):
    """Host inverse of ``_pack_pcm24``: (B, 3n+3) uint8 -> f32 waveform
    (B, n) + int32 mel_lengths (B,)."""
    u = arr.reshape(arr.shape[0], -1, 3).astype(np.int32)
    v = u[..., 0] | (u[..., 1] << 8) | (u[..., 2] << 16)
    v = (v ^ 0x800000) - 0x800000  # sign-extend 24 -> 32 bit
    wav = (v[:, :-1] / np.float32(PCM24_SCALE)).astype(np.float32)
    return wav, v[:, -1].astype(np.int32)


def _pcm24_lengths(arr: np.ndarray) -> np.ndarray:
    """mel_lengths from packed PCM24 rows without decoding the audio: only
    the trailing 3-byte sample of each row is read (lengths are positive
    and below 2^23). The other bytes of a row are the WAV frames as
    ``write_wav`` writes them."""
    t = arr[:, -3:].astype(np.int32)
    return t[:, 0] | (t[:, 1] << 8) | (t[:, 2] << 16)


def fetch_fused_host(out: dict):
    """A fixed-bucket result's (waveform, mel_lengths) on the host, in one
    copy, whichever wire format the graph packed (``wav_pcm24``,
    ``wav_packed``, or the plain f32 waveform and lengths). The ``"auto"``
    path has already fetched into ``*_host`` keys for its saturation
    check; integer-bucket callers use this."""
    if "waveform_host" in out:
        return out["waveform_host"], np.asarray(out["mel_lengths_host"])
    if "pcm24_bytes_host" in out:  # raw_pcm24 delivery, already fetched
        return _unpack_pcm24(out["pcm24_bytes_host"])
    if "wav_pcm24" in out:
        return _unpack_pcm24(out["wav_pcm24"].cpu().numpy())
    if "wav_packed" in out:
        packed = out["wav_packed"].cpu().numpy()
        return packed[:, :-1], packed[:, -1].astype(np.int32)
    return out["waveform"].cpu().numpy(), out["mel_lengths"].cpu().numpy()


def _fetch_auto_host(out: dict, raw_pcm24: bool) -> np.ndarray:
    """The ``"auto"`` path's one host copy of a result, kept in the keys
    that ``fetch_fused_host`` reads back: the packed rows as
    ``pcm24_bytes_host`` (``raw_pcm24`` delivery, lengths read from the
    last sample), else the waveform of either wire format as
    ``waveform_host``; a result with neither (no vocoder, or the dynamic
    fallback's f32 waveform) fetches its lengths only. Sets and returns
    ``mel_lengths_host``."""
    if raw_pcm24 and "wav_pcm24" in out:
        out["pcm24_bytes_host"] = out["wav_pcm24"].cpu().numpy()
        ml = _pcm24_lengths(out["pcm24_bytes_host"])
    elif "wav_pcm24" in out or "wav_packed" in out:
        out["waveform_host"], ml = fetch_fused_host(out)
    else:
        ml = out["mel_lengths"].cpu().numpy()
    out["mel_lengths_host"] = ml
    return ml


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


#: unit noise for a call: a (B, T_y, n_feats) tensor at the bucket the call
#: uses, or a callable T_y -> such a tensor (the bucket of an "auto" call is
#: not known in advance)
Noise = Union[torch.Tensor, Callable[[int], torch.Tensor], None]


class TTSPipeline:
    """Bucketed synthesis: MatchaTTS + fused-MRF HiFi-GAN + denoiser, on
    the dynamic path or as one CUDA graph per fixed mel bucket."""

    #: candidate mel buckets of the fixed-bucket path under "auto" (finer
    #: than Y_BUCKETS: the tightest bucket is the least decode and vocoder
    #: work)
    FUSED_Y_BUCKETS = tuple(range(64, 2049, 64))
    #: headroom over the calibrated frames-per-token estimate
    FUSED_MARGIN = 1.15

    def __init__(self, model: MatchaTTS, vocoder: Optional[Generator] = None,
                 denoiser_bias: Optional[torch.Tensor] = None,
                 cleaner: str = "english_cleaners2", device=None,
                 denoiser_strength: float = 0.00025, pcm24_transfer: bool = True):
        self.device = resolve_device(device)
        self.model = model.to(self.device).eval()
        self.vocoder = None if vocoder is None else vocoder.to(self.device).eval()
        # the fused stages' kernel weights, packed once here and not per call
        self.vocoder_weights = None if vocoder is None else fused_stage_weights(self.vocoder)
        self.denoiser_bias = None if denoiser_bias is None else denoiser_bias.to(self.device)
        self.cleaner = cleaner
        self.denoiser_strength = denoiser_strength
        # the fixed-bucket path's wire format: 24-bit PCM with the lengths as
        # a last sample (the written-WAV encoding, 3 bytes a sample), else
        # the f32 rows with the lengths as a last column
        self.pcm24_transfer = pcm24_transfer
        self._graphs = {}
        self._graph_pool = None
        # "auto" calibration: the p90 of the recent mel frames per (id x
        # length_scale); None until a call returns real mel lengths
        self._dur_ratio = None
        self._dur_obs = collections.deque(maxlen=64)

    def vocode(self, mel_btc: torch.Tensor) -> torch.Tensor:
        """Mel (B, T, n_feats) -> clipped, denoised waveform (B, T * hop)."""
        wav = generator_apply_fused(self.vocoder, mel_btc, self.vocoder_weights)
        wav = torch.clamp(wav[..., 0], -1.0, 1.0)
        if self.denoiser_bias is not None:
            wav = denoise(wav, self.denoiser_bias, strength=self.denoiser_strength)
        return wav

    def fused_graph(self, B: int, T_x: int, T_y: int, n_timesteps: int, temperature: float,
                    length_scale: float, cuda_graph: Optional[bool] = None) -> FusedGraph:
        """The cached fixed-bucket body for this key (``_fused_fn``'s key
        fields plus B, the wire format and the graph mode; the port runs
        single-speaker models and has no key fold)."""
        key = (B, T_x, T_y, n_timesteps, temperature, length_scale,
               float(self.denoiser_strength), self.pcm24_transfer, cuda_graph)
        if key not in self._graphs:
            if self._graph_pool is None and self.device.type == "cuda" and cuda_graph is not False:
                self._graph_pool = torch.cuda.graph_pool_handle()
            self._graphs[key] = FusedGraph(self, B, T_x, T_y, n_timesteps, temperature,
                                           length_scale, self.pcm24_transfer, cuda_graph,
                                           self._graph_pool)
        return self._graphs[key]

    def observe_dur_ratio(self, obs: float) -> None:
        """Fold one non-saturated fixed-bucket result into the
        frames-per-token calibration of ``_auto_y_bucket``: the 90th
        percentile of the last 64 observations, not an all-time maximum,
        so that one long-winded utterance does not push every later
        request onto a larger bucket for good. An underestimate costs the
        one call a re-run at a larger bucket; an overestimate taxes every
        call."""
        self._dur_obs.append(float(obs))
        self._dur_ratio = float(np.quantile(np.asarray(self._dur_obs), 0.9))

    def _auto_y_bucket(self, n_ids: int, length_scale: float) -> int:
        """The tightest fixed mel bucket from the calibrated ratio; the
        largest before any calibration (always right, just not tight)."""
        if self._dur_ratio is None:
            return self.FUSED_Y_BUCKETS[-1]
        est = n_ids * length_scale * self._dur_ratio * self.FUSED_MARGIN
        for b in self.FUSED_Y_BUCKETS:
            if b >= est:
                return b
        return self.FUSED_Y_BUCKETS[-1]

    @torch.inference_mode()
    def synthesise_batch(self, x: np.ndarray, x_lengths: np.ndarray, n_timesteps: int = 10,
                         temperature: float = 0.667, length_scale: float = 1.0,
                         z: Noise = None, generator: Optional[torch.Generator] = None,
                         pack_wav: bool = False, fixed_y_bucket: Union[int, str] = 0,
                         raw_pcm24: bool = False, cuda_graph: Optional[bool] = None) -> dict:
        """ids (B, T) + lengths -> the ``decode`` dict plus the waveform.

        Noise: ``z``, unit normal (B, T_y, n_feats) at the mel bucket T_y
        the call uses, or a callable ``z(T_y)`` that returns it; otherwise
        drawn from ``generator``. JAX's ``key_fold`` has no counterpart:
        the noise is always this explicit ``z`` or ``generator``.

        Dynamic path (``fixed_y_bucket`` 0): ``waveform`` (B, T_voc * hop),
        or ``wav_pcm24`` when ``pack_wav``.

        ``fixed_y_bucket`` an int: the whole path at that mel bucket, one
        replay of the bucket's CUDA graph on a GPU (captured at its first
        call), the same body eagerly on the CPU; ``waveform`` (B, T_y *
        hop) plus ``wav_pcm24`` (or ``wav_packed`` without
        ``pcm24_transfer``). No host sync: lengths that reach the bucket
        mean clipped audio, which ``synth_fetch_guarded`` checks.
        ``cuda_graph=False`` runs the body eagerly on the GPU.

        ``"auto"``: the bucket from ``_auto_y_bucket``. One host copy
        carries the wav and the lengths (``waveform_host`` and
        ``mel_lengths_host``); a result that reached its bucket re-runs at
        the first bucket of at least twice the size, and one that reached
        the largest falls back to the dynamic path with a warning. Only
        results that did not saturate calibrate the ratio. ``raw_pcm24``
        (pcm24 wire): deliver the packed rows as ``pcm24_bytes_host``
        instead of the f32 ``waveform_host``, also through the fallback.
        """
        x = np.asarray(x)
        x_lengths_host = np.asarray(x_lengths, dtype=np.int32)
        T_x = pick_bucket(x.shape[-1], X_BUCKETS)
        x_pad = np.zeros((x.shape[0], T_x), dtype=np.int64)
        x_pad[:, :x.shape[-1]] = x

        if fixed_y_bucket:
            auto = fixed_y_bucket == "auto"
            T_y = (self._auto_y_bucket(int(x_lengths_host.max()), length_scale)
                   if auto else int(fixed_y_bucket))
            while True:
                graph = self.fused_graph(x.shape[0], T_x, T_y, n_timesteps, temperature,
                                         length_scale, cuda_graph)
                out = graph(x_pad, x_lengths_host, z(T_y) if callable(z) else z, generator)
                if not auto:
                    return out
                ml = _fetch_auto_host(out, raw_pcm24)
                saturated = bool((ml >= T_y).any())
                valid = x_lengths_host > 0
                if not saturated and valid.any():
                    self.observe_dur_ratio(
                        float(np.max(ml[valid] / (x_lengths_host[valid] * length_scale))))
                if not saturated:
                    return out
                if T_y >= self.FUSED_Y_BUCKETS[-1]:
                    # clipped audio is never acceptable: the dynamic path
                    # is length-general (pick_bucket rounds past its table)
                    warnings.warn(
                        f"[-] Utterance saturated the largest fused mel "
                        f"bucket ({T_y} frames); falling back to the "
                        f"dynamic path for full-length audio. Consider "
                        f"--long-form for very long inputs.", UserWarning)
                    out = self.synthesise_batch(
                        x, x_lengths_host, n_timesteps=n_timesteps, temperature=temperature,
                        length_scale=length_scale, z=z, generator=generator,
                        pack_wav=raw_pcm24)
                    _fetch_auto_host(out, raw_pcm24)  # the same byte-delivery contract
                    return out
                T_y = next((b for b in self.FUSED_Y_BUCKETS if b >= 2 * T_y),
                           self.FUSED_Y_BUCKETS[-1])

        x_t = torch.from_numpy(x_pad).to(self.device)
        xl = torch.from_numpy(x_lengths_host).to(self.device)
        mu_x, w_ceil, y_lengths = self.model.encode(x_t, xl, length_scale)
        max_y = int(y_lengths.max())  # the one host sync of the path
        T_y = pick_bucket(max_y, Y_BUCKETS)
        out = self.model.decode(mu_x, w_ceil, xl, y_lengths, n_timesteps, temperature,
                                y_max_length=T_y, z=z(T_y) if callable(z) else z,
                                generator=generator)
        if self.vocoder is not None:
            T_voc = min(T_y, pick_bucket(min(max_y, T_y), VOC_BUCKETS))
            wav = self.vocode(out["mel"].transpose(1, 2)[:, :T_voc])
            if pack_wav:
                out["wav_pcm24"] = _pack_pcm24(wav, out["mel_lengths"])
            else:
                out["waveform"] = wav
        return out


# ---------------------------------------------------------------------------
# model loading
# ---------------------------------------------------------------------------


def get_user_data_dir(appname: str = "matcha_tpu") -> Path:
    """``$MATCHA_HOME/<appname>``, else ``~/.local/share/<appname>``."""
    home = os.environ.get("MATCHA_HOME")
    base = Path(home).expanduser() if home is not None else Path.home() / ".local" / "share"
    return base / appname


def _checked(path) -> Path:
    path = Path(path)
    if not path.exists():
        raise FileNotFoundError(f"checkpoint not found: {path} (nothing is downloaded)")
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
        for stage in ("down", "mid", "up"):
            block = str(_get(dec, f"{stage}_block_type", "transformer"))
            if block != "transformer":
                raise NotImplementedError(f"{stage}_block_type={block!r}: only transformer "
                                          "decoder blocks are ported")
        kwargs.update(
            dec_channels=tuple(_get(dec, "channels", (256, 256))),
            dec_attention_head_dim=int(_get(dec, "attention_head_dim", 64)),
            dec_n_blocks=int(_get(dec, "n_blocks", 1)),
            dec_num_mid_blocks=int(_get(dec, "num_mid_blocks", 2)),
            dec_num_heads=int(_get(dec, "num_heads", 2)),
            dec_act_fn=str(_get(dec, "act_fn", "snakebeta")),
        )
    return kwargs


def load_matcha(checkpoint_path, device=None) -> MatchaTTS:
    """A reference Lightning ``.ckpt`` (a trusted file: it is unpickled in
    full, for its hyper-parameters) -> MatchaTTS on ``device``."""
    path = _checked(checkpoint_path)
    print(f"[!] Loading {path.name}!")
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


def load_vocoder(checkpoint_path, device=None):
    """A reference HiFi-GAN v1 generator file -> (Generator with weight
    norm folded, denoiser bias spectrum from its output on a zero mel)."""
    path = _checked(checkpoint_path)
    print(f"[!] Loading {path.name}!")
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    sd = ckpt["generator"] if "generator" in ckpt else ckpt
    vocoder = Generator(HiFiGANConfig())
    vocoder.load_state_dict(fold_hifigan_state_dict(sd))
    device = resolve_device(device)
    vocoder = vocoder.to(device).eval()
    bias = compute_bias_spec(lambda mel: generator_apply_fused(vocoder, mel), device=device)
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
    """``<name>.npy`` (the mel, (n_feats, frames)) and ``<name>.wav``."""
    base = folder / name
    np.save(base.with_suffix(".npy"), mel)
    write_wav(base.with_suffix(".wav"), wav)
    return base.with_suffix(".wav").resolve()


def _print_rtf_summary(rtfs) -> None:
    print(f"[🍵] Average Matcha-TTS + VOCODER RTF: {np.mean(rtfs):.4f} ± {np.std(rtfs)}")


def unbatched_synthesis(args, pipeline: TTSPipeline, texts, folder: Path) -> None:
    """One utterance per call: ``utterance_<i>.wav`` / ``.npy``, i from 1."""
    rtfs = []
    for i, text in enumerate(texts, start=1):
        tp = process_text(i, text.strip(), pipeline.cleaner)
        generator = torch.Generator(pipeline.device).manual_seed(args.seed + i)
        t0 = time.perf_counter()
        out, wavs, mls = synth_fetch_guarded(
            pipeline, tp["x"], tp["x_lengths"], n_timesteps=args.steps,
            temperature=args.temperature, length_scale=args.speaking_rate,
            generator=generator, fixed_y_bucket=args.fixed_y_bucket)
        ml = int(mls[0])
        wav = wavs[0, :ml * HOP]
        rtfs.append(_rtf(time.perf_counter() - t0, wav.shape[-1]))
        print(f"[🍵-{i}] Matcha-TTS + VOCODER RTF: {rtfs[-1]:.4f}")
        location = _save(folder, f"utterance_{i:03d}", out["mel"][0, :, :ml].cpu().numpy(), wav)
        print(f"[+] Waveform saved: {location}")
    _print_rtf_summary(rtfs)


def batched_synthesis(args, pipeline: TTSPipeline, texts, folder: Path) -> None:
    """Length-sorted batches of ``--batch_size``, one call each:
    ``utterance_<idx>.wav`` / ``.npy`` with idx the 0-based line, as the
    JAX CLI names them."""
    processed = [process_text(i, t.strip(), pipeline.cleaner) for i, t in enumerate(texts)]
    order = sorted(range(len(processed)), key=lambda i: processed[i]["x"].shape[-1])
    rtfs = []
    for bi, start in enumerate(range(0, len(order), args.batch_size)):
        chunk = order[start:start + args.batch_size]
        x = np.zeros((len(chunk), max(processed[i]["x"].shape[-1] for i in chunk)), np.int32)
        x_lengths = np.zeros((len(chunk),), np.int32)
        for row, idx in enumerate(chunk):
            xi = processed[idx]["x"][0]
            x[row, :xi.shape[-1]] = xi
            x_lengths[row] = xi.shape[-1]
        generator = torch.Generator(pipeline.device).manual_seed(args.seed + bi)
        t0 = time.perf_counter()
        out, wavs, mls = synth_fetch_guarded(
            pipeline, x, x_lengths, n_timesteps=args.steps, temperature=args.temperature,
            length_scale=args.speaking_rate, generator=generator,
            fixed_y_bucket=args.fixed_y_bucket)
        rtfs.append(_rtf(time.perf_counter() - t0, int(np.sum(mls)) * HOP))
        print(f"[🍵-Batch: {bi + 1}] Matcha-TTS + VOCODER RTF: {rtfs[-1]:.4f}")
        mel = out["mel"].cpu().numpy()
        for row, idx in enumerate(chunk):
            ml = int(mls[row])
            location = _save(folder, f"utterance_{idx:03d}", mel[row, :, :ml],
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
            generator=generator, fixed_y_bucket=args.fixed_y_bucket)
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
    parser.add_argument("--checkpoint_path", type=str, default=None,
                        help="Matcha .ckpt (default: $MATCHA_HOME/matcha_tpu/matcha_ljspeech.ckpt)")
    parser.add_argument("--text", type=str, default=None, help="Text to synthesize")
    parser.add_argument("--file", type=str, default=None, help="Text file to synthesize, one utterance per line")
    parser.add_argument("--temperature", type=float, default=0.667, help="Variance of the x0 noise (default: 0.667)")
    parser.add_argument("--speaking_rate", type=float, default=None,
                        help="Higher is slower (default: 0.95 for LJSpeech, 1.0 for a custom checkpoint)")
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
    return parser


def cli(argv=None):
    args = build_parser().parse_args(argv)
    if not (args.text or args.file):
        raise SystemExit("Either --text or --file must be given")
    if args.temperature < 0 or args.steps <= 0:
        raise SystemExit("--temperature must be >= 0 and --steps > 0")
    if args.batched and args.batch_size <= 0:
        raise SystemExit("--batch_size must be > 0")
    device = resolve_device("cpu" if args.cpu else None)
    home = get_user_data_dir()
    if args.checkpoint_path is None:
        matcha_path, vocoder_name, rate = home / "matcha_ljspeech.ckpt", "hifigan_T2_v1", 0.95
    else:
        matcha_path, vocoder_name, rate = Path(args.checkpoint_path), "hifigan_univ_v1", 1.0
    args.speaking_rate = rate if args.speaking_rate is None else args.speaking_rate
    if args.speaking_rate <= 0:
        raise SystemExit("--speaking_rate must be > 0")
    print(f"[+] Device: {device}")

    model = load_matcha(matcha_path, device)
    vocoder, bias = load_vocoder(home / vocoder_name, device)
    pipeline = TTSPipeline(model, vocoder, bias, cleaner=args.cleaner, device=device,
                           denoiser_strength=args.denoiser_strength,
                           pcm24_transfer=not args.no_pcm24_transfer)

    texts = _texts(args)
    folder = Path(args.output_folder)
    folder.mkdir(parents=True, exist_ok=True)
    if args.long_form and args.text:
        long_form_synthesis(args, pipeline, args.text, folder)
    elif len(texts) == 1 or not args.batched:
        unbatched_synthesis(args, pipeline, texts, folder)
    else:
        batched_synthesis(args, pipeline, texts, folder)


if __name__ == "__main__":
    cli(sys.argv[1:])
