"""Centered STFT / inverse STFT for the vocoder-bias denoiser.

Port of ``matcha_tpu/audio/stft.py``: center=True with reflect padding, a
periodic Hann window, onesided, no normalisation; the inverse divides the
overlap-add by the summed squared window, as ``torch.istft`` does.

The window and the normaliser are built once per device and shape from
the numpy values, and cached: a call copies nothing from the host, so a
CUDA graph can capture it once a call at the same shapes has run. The
caches never evict: a captured graph reads these tensors by address and
holds no reference to them, so a freed entry would be read as whatever
the allocator put there next. They hold one small tensor per distinct
length.
"""

import functools

import numpy as np
import torch
import torch.nn.functional as F


def hann_window_periodic(win_length: int) -> np.ndarray:
    """Periodic Hann window (torch.hann_window's default), f32."""
    n = np.arange(win_length, dtype=np.float64)
    return (0.5 - 0.5 * np.cos(2.0 * np.pi * n / win_length)).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _window(win_length: int, device: torch.device) -> torch.Tensor:
    with torch.inference_mode(False):
        return torch.from_numpy(hann_window_periodic(win_length)).to(device)


@functools.lru_cache(maxsize=None)
def _window_square_sum(n_fft: int, hop_length: int, win_length: int, n_frames: int,
                       device: torch.device) -> torch.Tensor:
    """The ISTFT normaliser: the squared window overlap-added over
    ``n_frames`` frames, f32 (it depends only on the shapes)."""
    wsq = np.zeros((n_fft + hop_length * (n_frames - 1),), np.float64)
    w2 = hann_window_periodic(win_length).astype(np.float64) ** 2
    for f in range(n_frames):
        wsq[f * hop_length:f * hop_length + n_fft] += w2
    with torch.inference_mode(False):
        return torch.from_numpy(wsq.astype(np.float32)).to(device)


def stft_magnitude_phase(audio: torch.Tensor, n_fft: int = 1024, hop_length: int = 256,
                         win_length: int = 1024):
    """(..., T) -> (magnitude, phase), each (..., n_freq, n_frames)."""
    lead = audio.shape[:-1]
    pad = n_fft // 2
    audio = F.pad(audio.reshape(-1, 1, audio.shape[-1]), (pad, pad), mode="reflect")
    frames = audio[:, 0].unfold(-1, n_fft, hop_length)  # (N, n_frames, n_fft)
    window = _window(win_length, audio.device)
    spec = torch.fft.rfft(frames * window, dim=-1)
    mag = torch.sqrt(spec.real ** 2 + spec.imag ** 2)
    phase = torch.atan2(spec.imag, spec.real)
    mag, phase = mag.transpose(-1, -2), phase.transpose(-1, -2)
    return mag.reshape(*lead, *mag.shape[-2:]), phase.reshape(*lead, *phase.shape[-2:])


def istft(magnitude: torch.Tensor, phase: torch.Tensor, n_fft: int = 1024,
          hop_length: int = 256, win_length: int = 1024, length: int = None) -> torch.Tensor:
    """(n_freq, n_frames) or (B, n_freq, n_frames) -> waveform (..., n)
    with the center padding removed."""
    squeeze = magnitude.dim() == 2
    if squeeze:
        magnitude, phase = magnitude[None], phase[None]
    spec = torch.complex(magnitude * torch.cos(phase), magnitude * torch.sin(phase))
    frames = torch.fft.irfft(spec.transpose(-1, -2), n=n_fft, dim=-1)  # (B, n_frames, n_fft)
    frames = frames * _window(win_length, frames.device)
    n_frames = frames.shape[-2]
    out_len = n_fft + hop_length * (n_frames - 1)
    signal = F.fold(frames.transpose(1, 2), output_size=(1, out_len),
                    kernel_size=(1, n_fft), stride=(1, hop_length))[:, 0, 0]
    wsq = _window_square_sum(n_fft, hop_length, win_length, n_frames, signal.device)
    signal = signal / torch.clamp(wsq, min=1e-11)

    pad = n_fft // 2
    signal = signal[:, pad:out_len - pad]
    if length is not None:
        signal = signal[:, :length]
    return signal[0] if squeeze else signal
