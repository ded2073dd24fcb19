"""Spectral-subtraction vocoder-bias denoiser.

Port of ``matcha_tpu/models/denoiser.py``: the vocoder's output on a zero
mel gives its bias spectrum; synthesis magnitudes lose ``strength *
bias`` and are resynthesised with their own phases.
"""

from typing import Callable, Optional

import torch

from benchmark.reference.audio.stft import istft, stft_magnitude_phase


@torch.inference_mode()
def compute_bias_spec(vocoder_apply: Callable[[torch.Tensor], torch.Tensor],
                      n_feats: int = 80, n_frames: int = 88, filter_length: int = 1024,
                      n_overlap: int = 4, win_length: int = 1024,
                      device=None, mode: str = "zeros",
                      generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Bias magnitude (n_freq, 1) of ``vocoder_apply`` on a mel (1,
    n_frames, n_feats) of zeros (``mode="zeros"``) or of unit normal noise
    drawn from ``generator`` (``mode="normal"``): the first STFT frame."""
    hop_length = filter_length // n_overlap
    if mode == "zeros":
        mel = torch.zeros((1, n_frames, n_feats), device=device)
    elif mode == "normal":
        mel = torch.randn((1, n_frames, n_feats), generator=generator, device=device)
    else:
        raise ValueError(f"Mode {mode} is not supported")
    bias_audio = vocoder_apply(mel).reshape(-1)
    bias_spec, _ = stft_magnitude_phase(bias_audio, filter_length, hop_length, win_length)
    return bias_spec[:, 0:1]


@torch.inference_mode()
def denoise(audio: torch.Tensor, bias_spec: torch.Tensor, strength: float = 0.00025,
            filter_length: int = 1024, n_overlap: int = 4,
            win_length: int = 1024) -> torch.Tensor:
    """Subtract the vocoder bias from (T,) or (B, T) audio in the
    magnitude domain; same leading shape out."""
    hop_length = filter_length // n_overlap
    squeeze = audio.dim() == 1
    if squeeze:
        audio = audio[None]
    mag, phase = stft_magnitude_phase(audio, filter_length, hop_length, win_length)
    mag = torch.clamp(mag - bias_spec[None] * strength, min=0.0)
    out = istft(mag, phase, filter_length, hop_length, win_length)
    return out[0] if squeeze else out
