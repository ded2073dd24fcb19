"""Evaluation metrics, host side in numpy float64.

The port's own copy of ``matcha_tpu/utils/metrics.py``: MCD
(mel-cepstral distortion) through an orthonormal DCT-II of the log-mel,
and the mean absolute log-mel error; the same formulas.
"""

from typing import Optional

import numpy as np


def dct_matrix(n_out: int, n_in: int) -> np.ndarray:
    """Orthonormal DCT-II basis (n_out, n_in)."""
    k = np.arange(n_out)[:, None]
    n = np.arange(n_in)[None, :]
    basis = np.cos(np.pi * k * (2 * n + 1) / (2 * n_in))
    basis *= np.sqrt(2.0 / n_in)
    basis[0] *= np.sqrt(0.5)
    return basis.astype(np.float64)


def mel_to_mfcc(log_mel: np.ndarray, n_mfcc: int = 13) -> np.ndarray:
    """(n_mels, T) log-mel -> (n_mfcc, T) cepstra via DCT-II."""
    n_mels = log_mel.shape[0]
    return dct_matrix(n_mfcc, n_mels) @ np.asarray(log_mel, dtype=np.float64)


def mcd(mel_a: np.ndarray, mel_b: np.ndarray, n_mfcc: int = 13, exclude_c0: bool = True,
        lengths: Optional[int] = None) -> float:
    """Mel-cepstral distortion in dB between two (n_mels, T) log-mels:
    (10 / ln 10) * sqrt(2) * mean_t ||c_a(t) - c_b(t)||_2 over c1..cK
    (c0 too with ``exclude_c0=False``), on the common length (at most
    ``lengths`` frames)."""
    T = min(mel_a.shape[-1], mel_b.shape[-1])
    if lengths is not None:
        T = min(T, int(lengths))
    ca = mel_to_mfcc(mel_a[:, :T], n_mfcc)
    cb = mel_to_mfcc(mel_b[:, :T], n_mfcc)
    if exclude_c0:
        ca, cb = ca[1:], cb[1:]
    dist = np.sqrt(np.sum((ca - cb) ** 2, axis=0))
    return float((10.0 / np.log(10.0)) * np.sqrt(2.0) * dist.mean())


def log_mel_l1(mel_a: np.ndarray, mel_b: np.ndarray) -> float:
    """Mean absolute log-mel error over the common length."""
    T = min(mel_a.shape[-1], mel_b.shape[-1])
    return float(np.mean(np.abs(mel_a[:, :T] - mel_b[:, :T])))
