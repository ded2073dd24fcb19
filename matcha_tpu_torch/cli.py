"""Text -> wav with the PyTorch port: the synthesis pipeline and its CLI.

Port of the dynamic path of ``matcha_tpu/cli.py``: encode -> host pick of
the mel bucket -> decode -> slice to the finer vocoder bucket -> vocode
(the fused-MRF generator) -> clip -> denoise -> optional 24-bit PCM
packing. Checkpoints are the reference formats (a Lightning ``.ckpt`` for
Matcha, ``{"generator": state_dict}`` for HiFi-GAN), read from
``$MATCHA_HOME/matcha_tpu/`` or a given path; nothing is downloaded.

    python -m matcha_tpu_torch.cli --text "..." --cleaner english_cleaners_no_espeak
"""

import argparse
import os
import sys
import time
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from matcha_tpu_torch import resolve_device
from matcha_tpu_torch.convert import fold_hifigan_state_dict
from matcha_tpu_torch.models.denoiser import compute_bias_spec, denoise
from matcha_tpu_torch.models.hifigan import Generator, HiFiGANConfig
from matcha_tpu_torch.models.hifigan_fused import fused_stage_weights, generator_apply_fused
from matcha_tpu_torch.models.matcha import MatchaTTS
from matcha_tpu_torch.text import intersperse, sequence_to_text, text_to_sequence
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


def _pack_pcm24(wav: torch.Tensor, mel_lengths: torch.Tensor) -> torch.Tensor:
    """(B, n) f32 waveform -> (B, 3n+3) uint8 little-endian 24-bit PCM on
    the waveform's device (clip, scale by 2^23-1, truncate toward zero,
    low 3 bytes), with mel_lengths appended as one trailing sample per
    row."""
    v = (torch.clamp(wav, -1.0, 1.0) * PCM24_SCALE).to(torch.int32)
    v = torch.cat([v, mel_lengths[:, None].to(torch.int32)], dim=1)
    b = torch.stack([v & 0xFF, (v >> 8) & 0xFF, (v >> 16) & 0xFF], dim=-1)
    return b.to(torch.uint8).reshape(v.shape[0], -1)


def _unpack_pcm24(arr: np.ndarray):
    """Host inverse of ``_pack_pcm24``: (B, 3n+3) uint8 -> f32 waveform
    (B, n) + int32 mel_lengths (B,)."""
    u = arr.reshape(arr.shape[0], -1, 3).astype(np.int32)
    v = u[..., 0] | (u[..., 1] << 8) | (u[..., 2] << 16)
    v = (v ^ 0x800000) - 0x800000  # sign-extend 24 -> 32 bit
    wav = (v[:, :-1] / np.float32(PCM24_SCALE)).astype(np.float32)
    return wav, v[:, -1].astype(np.int32)


def process_text(i: int, text: str, cleaner: str = "english_cleaners2"):
    print(f"[{i}] - Input text: {text}")
    seq = intersperse(text_to_sequence(text, [cleaner]), 0)
    x = np.asarray(seq, dtype=np.int32)[None]
    x_lengths = np.asarray([x.shape[-1]], dtype=np.int32)
    x_phones = sequence_to_text(list(x[0]))
    print(f"[{i}] - Phonetised text: {x_phones[1::2]}")
    return {"x_orig": text, "x": x, "x_lengths": x_lengths, "x_phones": x_phones}


class TTSPipeline:
    """Bucketed synthesis: MatchaTTS + fused-MRF HiFi-GAN + denoiser."""

    def __init__(self, model: MatchaTTS, vocoder: Optional[Generator] = None,
                 denoiser_bias: Optional[torch.Tensor] = None,
                 cleaner: str = "english_cleaners2", device=None,
                 denoiser_strength: float = 0.00025):
        self.device = resolve_device(device)
        self.model = model.to(self.device).eval()
        self.vocoder = None if vocoder is None else vocoder.to(self.device).eval()
        # the fused stages' kernel weights, packed once here and not per call
        self.vocoder_weights = None if vocoder is None else fused_stage_weights(self.vocoder)
        self.denoiser_bias = None if denoiser_bias is None else denoiser_bias.to(self.device)
        self.cleaner = cleaner
        self.denoiser_strength = denoiser_strength

    def vocode(self, mel_btc: torch.Tensor) -> torch.Tensor:
        """Mel (B, T, n_feats) -> clipped, denoised waveform (B, T * hop)."""
        wav = generator_apply_fused(self.vocoder, mel_btc, self.vocoder_weights)
        wav = torch.clamp(wav[..., 0], -1.0, 1.0)
        if self.denoiser_bias is not None:
            wav = denoise(wav, self.denoiser_bias, strength=self.denoiser_strength)
        return wav

    @torch.inference_mode()
    def synthesise_batch(self, x: np.ndarray, x_lengths: np.ndarray, n_timesteps: int = 10,
                         temperature: float = 0.667, length_scale: float = 1.0,
                         z: Optional[torch.Tensor] = None,
                         generator: Optional[torch.Generator] = None,
                         pack_wav: bool = False) -> dict:
        """ids (B, T) + lengths -> the ``decode`` dict plus ``waveform``
        (B, T_voc * hop), or ``wav_pcm24`` when ``pack_wav``.

        ``z``: unit-normal noise (B, T_y, n_feats) at the mel bucket T_y
        this call picks; otherwise drawn from ``generator``."""
        x = np.asarray(x)
        T_x = pick_bucket(x.shape[-1], X_BUCKETS)
        x_pad = np.zeros((x.shape[0], T_x), dtype=np.int64)
        x_pad[:, :x.shape[-1]] = x
        x_t = torch.from_numpy(x_pad).to(self.device)
        xl = torch.from_numpy(np.asarray(x_lengths, dtype=np.int32)).to(self.device)

        mu_x, w_ceil, y_lengths = self.model.encode(x_t, xl, length_scale)
        max_y = int(y_lengths.max())  # the one host sync of the path
        T_y = pick_bucket(max_y, Y_BUCKETS)
        out = self.model.decode(mu_x, w_ceil, xl, y_lengths, n_timesteps, temperature,
                                y_max_length=T_y, z=z, generator=generator)
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
    parser.add_argument("--seed", type=int, default=1234, help="Noise seed (default 1234)")
    parser.add_argument("--cleaner", type=str, default="english_cleaners2",
                        help="Text cleaner (english_cleaners_no_espeak works without espeak)")
    return parser


def cli(argv=None):
    args = build_parser().parse_args(argv)
    if not (args.text or args.file):
        raise SystemExit("Either --text or --file must be given")
    if args.temperature < 0 or args.steps <= 0:
        raise SystemExit("--temperature must be >= 0 and --steps > 0")
    device = resolve_device("cpu" if args.cpu else None)
    home = get_user_data_dir()
    if args.checkpoint_path is None:
        matcha_path, vocoder_name, rate = home / "matcha_ljspeech.ckpt", "hifigan_T2_v1", 0.95
    else:
        matcha_path, vocoder_name, rate = Path(args.checkpoint_path), "hifigan_univ_v1", 1.0
    speaking_rate = rate if args.speaking_rate is None else args.speaking_rate
    if speaking_rate <= 0:
        raise SystemExit("--speaking_rate must be > 0")
    print(f"[+] Device: {device}")

    model = load_matcha(matcha_path, device)
    vocoder, bias = load_vocoder(home / vocoder_name, device)
    pipeline = TTSPipeline(model, vocoder, bias, cleaner=args.cleaner, device=device,
                           denoiser_strength=args.denoiser_strength)

    if args.text:
        texts = [args.text]
    else:
        with open(args.file, encoding="utf-8") as f:
            texts = [line for line in f if line.strip()]
    folder = Path(args.output_folder)
    folder.mkdir(parents=True, exist_ok=True)
    rtfs = []
    for i, text in enumerate(texts, start=1):
        tp = process_text(i, text.strip(), args.cleaner)
        generator = torch.Generator(device).manual_seed(args.seed + i)
        t0 = time.perf_counter()
        out = pipeline.synthesise_batch(tp["x"], tp["x_lengths"], n_timesteps=args.steps,
                                        temperature=args.temperature,
                                        length_scale=speaking_rate, generator=generator)
        ml = int(out["mel_lengths"][0])
        wav = out["waveform"][0, :ml * HOP].cpu().numpy()
        seconds = time.perf_counter() - t0
        rtfs.append(seconds * SAMPLE_RATE / max(wav.shape[-1], 1))
        print(f"[🍵-{i}] Matcha-TTS + VOCODER RTF: {rtfs[-1]:.4f}")
        base = folder / f"utterance_{i:03d}"
        np.save(base.with_suffix(".npy"), out["mel"][0, :, :ml].cpu().numpy())
        write_wav(base.with_suffix(".wav"), wav)
        print(f"[+] Waveform saved: {base.with_suffix('.wav').resolve()}")
    print(f"[🍵] Average Matcha-TTS + VOCODER RTF: {np.mean(rtfs):.4f} ± {np.std(rtfs)}")


if __name__ == "__main__":
    cli(sys.argv[1:])
