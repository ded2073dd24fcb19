"""Log-mel spectrogram, HiFi-GAN convention: on the host and on the device.

The port's own copy of ``matcha_tpu/audio/mel.py``: reflect-pad by
(n_fft - hop) / 2, framed STFT with a periodic Hann window and
center=False, magnitude ``sqrt(re^2 + im^2 + 1e-9)``, the
Slaney-normalised librosa mel filterbank, ``log(clamp(x, 1e-5))``.
``mel_spectrogram_np`` is the host pipeline the training data path calls
for every utterance; ``mel_spectrogram`` is the same function in torch on
any device, differentiable (the vocoder GAN step's mel loss).
"""

import functools
import logging

import numpy as np
import torch
import torch.nn.functional as F

log = logging.getLogger(__name__)


def _hz_to_mel(frequencies: np.ndarray) -> np.ndarray:
    """Slaney-formula Hz -> mel (linear below 1 kHz, log above)."""
    frequencies = np.asanyarray(frequencies, dtype=np.float64)
    f_min, f_sp = 0.0, 200.0 / 3
    mels = (frequencies - f_min) / f_sp
    min_log_hz = 1000.0
    min_log_mel = (min_log_hz - f_min) / f_sp
    logstep = np.log(6.4) / 27.0
    log_region = frequencies >= min_log_hz
    return np.where(
        log_region,
        min_log_mel + np.log(np.maximum(frequencies, min_log_hz) / min_log_hz) / logstep,
        mels,
    )


def _mel_to_hz(mels: np.ndarray) -> np.ndarray:
    mels = np.asanyarray(mels, dtype=np.float64)
    f_min, f_sp = 0.0, 200.0 / 3
    freqs = f_min + f_sp * mels
    min_log_hz = 1000.0
    min_log_mel = (min_log_hz - f_min) / f_sp
    logstep = np.log(6.4) / 27.0
    log_region = mels >= min_log_mel
    return np.where(log_region, min_log_hz * np.exp(logstep * (mels - min_log_mel)), freqs)


@functools.lru_cache(maxsize=8)
def mel_filterbank(sr: int, n_fft: int, n_mels: int, fmin: float, fmax: float) -> np.ndarray:
    """Slaney-normalised triangular mel filterbank, (n_mels, 1 + n_fft//2):
    ``librosa.filters.mel(htk=False, norm='slaney')``."""
    fmax = float(sr) / 2 if fmax is None else float(fmax)
    n_freqs = 1 + n_fft // 2
    fftfreqs = np.linspace(0.0, sr / 2.0, n_freqs, dtype=np.float64)

    mel_min, mel_max = _hz_to_mel(np.array([fmin])), _hz_to_mel(np.array([fmax]))
    mel_f = _mel_to_hz(np.linspace(mel_min[0], mel_max[0], n_mels + 2))

    fdiff = np.diff(mel_f)
    ramps = mel_f[:, None] - fftfreqs[None, :]
    lower = -ramps[:-2] / fdiff[:-1, None]
    upper = ramps[2:] / fdiff[1:, None]
    weights = np.maximum(0.0, np.minimum(lower, upper))

    # Slaney-style area normalisation
    enorm = 2.0 / (mel_f[2: n_mels + 2] - mel_f[:n_mels])
    weights *= enorm[:, None]
    return weights.astype(np.float32)


@functools.lru_cache(maxsize=8)
def hann_window_periodic(win_length: int) -> np.ndarray:
    """Periodic Hann window (torch.hann_window's default)."""
    n = np.arange(win_length, dtype=np.float64)
    return (0.5 - 0.5 * np.cos(2.0 * np.pi * n / win_length)).astype(np.float32)


def _frame_indices(n_samples: int, n_fft: int, hop_size: int) -> np.ndarray:
    n_frames = 1 + (n_samples - n_fft) // hop_size
    return np.arange(n_frames)[:, None] * hop_size + np.arange(n_fft)[None, :]


def mel_spectrogram_np(
    y: np.ndarray,
    n_fft: int = 1024,
    num_mels: int = 80,
    sampling_rate: int = 22050,
    hop_size: int = 256,
    win_size: int = 1024,
    fmin: float = 0.0,
    fmax: float = 8000.0,
    center: bool = False,
) -> np.ndarray:
    """Log-mel of waveform ``y`` (..., n_samples) -> (..., n_mels, n_frames)."""
    if center or win_size != n_fft:
        raise ValueError("the HiFi-GAN convention is center=False and win_size == n_fft")
    y = np.asarray(y, dtype=np.float32)
    pad = int((n_fft - hop_size) / 2)
    pad_widths = [(0, 0)] * (y.ndim - 1) + [(pad, pad)]
    y = np.pad(y, pad_widths, mode="reflect")

    idx = _frame_indices(y.shape[-1], n_fft, hop_size)
    frames = y[..., idx]
    window = hann_window_periodic(win_size)
    spec_c = np.fft.rfft(frames * window, axis=-1)
    mag = np.sqrt(spec_c.real**2 + spec_c.imag**2 + 1e-9).astype(np.float32)

    fb = mel_filterbank(sampling_rate, n_fft, num_mels, fmin, fmax)
    mel = np.einsum("mf,...tf->...mt", fb, mag)
    return np.log(np.clip(mel, 1e-5, None)).astype(np.float32)


_DEVICE_CONSTANTS = {}


def _device_constants(sr: int, n_fft: int, n_mels: int, fmin: float, fmax: float,
                      device, dtype):
    """(window, filterbank) on ``device``, cached: the host arrays of
    :func:`hann_window_periodic` and :func:`mel_filterbank`."""
    key = (sr, n_fft, n_mels, fmin, fmax, str(device), dtype)
    if key not in _DEVICE_CONSTANTS:
        _DEVICE_CONSTANTS[key] = (
            torch.from_numpy(hann_window_periodic(n_fft)).to(device, dtype),
            torch.from_numpy(mel_filterbank(sr, n_fft, n_mels, fmin, fmax)).to(device, dtype))
    return _DEVICE_CONSTANTS[key]


def mel_spectrogram(
    y: torch.Tensor,
    n_fft: int = 1024,
    num_mels: int = 80,
    sampling_rate: int = 22050,
    hop_size: int = 256,
    win_size: int = 1024,
    fmin: float = 0.0,
    fmax: float = 8000.0,
    center: bool = False,
) -> torch.Tensor:
    """Log-mel of waveform ``y`` (..., n_samples) -> (..., n_mels,
    n_frames), on ``y``'s device and differentiable in ``y``."""
    if center or win_size != n_fft:
        raise ValueError("the HiFi-GAN convention is center=False and win_size == n_fft")
    pad = int((n_fft - hop_size) / 2)
    lead = y.shape[:-1]
    y = F.pad(y.reshape(-1, 1, y.shape[-1]), (pad, pad), mode="reflect")
    frames = y[:, 0].unfold(-1, n_fft, hop_size)  # (N, n_frames, n_fft)
    window, fb = _device_constants(sampling_rate, n_fft, num_mels, fmin, fmax, y.device,
                                   y.dtype)
    spec_c = torch.fft.rfft(frames * window, dim=-1)
    mag = torch.sqrt(spec_c.real ** 2 + spec_c.imag ** 2 + 1e-9)
    mel = torch.einsum("mf,ntf->nmt", fb, mag)
    return torch.log(torch.clamp(mel, min=1e-5)).reshape(*lead, num_mels, -1)


def resolve_mel_frontend(frontend: str):
    """The mel function of the data path, as the JAX package picks it:
    ``"numpy"`` gives :func:`mel_spectrogram_np`; ``"native"`` the C++
    frontend (``audio/native.py``), built now so that a failure raises
    here and not in a loader thread; ``"auto"`` the native one when it
    builds, else numpy with a warning."""
    if frontend == "numpy":
        return mel_spectrogram_np
    if frontend not in ("native", "auto"):
        raise ValueError(f"unknown mel frontend {frontend!r}")
    try:
        from matcha_tpu_torch.audio.native import mel_spectrogram_native

        mel_spectrogram_native(np.zeros(4096, dtype=np.float32))
        return mel_spectrogram_native
    except Exception as e:
        if frontend == "native":
            raise
        log.warning(f"native mel frontend unavailable ({e}); using numpy")
        return mel_spectrogram_np
