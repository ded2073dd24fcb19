"""Log-mel spectrogram on the host, numpy, HiFi-GAN convention.

The port's own copy of ``matcha_tpu/audio/mel.py``'s numpy pipeline:
reflect-pad by (n_fft - hop) / 2, framed STFT with a periodic Hann
window and center=False, magnitude ``sqrt(re^2 + im^2 + 1e-9)``, the
Slaney-normalised librosa mel filterbank, ``log(clamp(x, 1e-5))``. The
training data path calls it for every utterance.
"""

import functools

import numpy as np


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


def resolve_mel_frontend(frontend: str):
    """The mel function of the data path. ``"numpy"`` and ``"auto"`` give
    :func:`mel_spectrogram_np` (``"auto"`` is what the JAX package falls
    back to when its native frontend does not build); ``"native"`` is not
    ported yet."""
    if frontend in ("numpy", "auto"):
        return mel_spectrogram_np
    if frontend == "native":
        raise NotImplementedError("the native (C++) mel frontend is not ported; "
                                  "use frontend=numpy")
    raise ValueError(f"unknown mel frontend {frontend!r}")
