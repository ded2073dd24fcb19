"""ctypes binding of the native C++ mel frontend (``native/audio/frontend.cpp``).

The port's own binding of the repo's C++/OpenMP log-mel: the same
function as :func:`matcha_tpu_torch.audio.mel.mel_spectrogram_np`, for the
host data path. At first use the source is compiled with ``g++ -O3
-fopenmp -shared -fPIC`` into ``build/matcha_tpu_torch/`` of the checkout
(gitignored; where the CUDA kernels go), under a name keyed on a hash of
the source and the flags, and loaded with ``ctypes``.
"""

import ctypes
import threading
from pathlib import Path

import numpy as np

from matcha_tpu_torch.audio.mel import mel_filterbank
from matcha_tpu_torch.ops.cuda_build import BUILD_DIR, build_host_library, host_library_path

SOURCE = Path(__file__).resolve().parents[2] / "native" / "audio" / "frontend.cpp"

_lock = threading.Lock()
_lib = None


def library_path() -> Path:
    return host_library_path(SOURCE, "libaudio", BUILD_DIR)


def _load() -> ctypes.CDLL:
    """The frontend's library, compiled first if it is not built yet."""
    global _lib
    with _lock:
        if _lib is None:
            path = build_host_library(SOURCE, library_path())
            lib = ctypes.CDLL(str(path))
            lib.mel_spectrogram_c.argtypes = [
                ctypes.POINTER(ctypes.c_float), ctypes.c_int64,
                ctypes.POINTER(ctypes.c_float), ctypes.c_int32, ctypes.c_int32,
                ctypes.c_int32, ctypes.POINTER(ctypes.c_float),
            ]
            lib.mel_spectrogram_c.restype = ctypes.c_int32
            _lib = lib
    return _lib


def mel_spectrogram_native(
    y: np.ndarray,
    n_fft: int = 1024,
    num_mels: int = 80,
    sampling_rate: int = 22050,
    hop_size: int = 256,
    win_size: int = 1024,
    fmin: float = 0.0,
    fmax: float = 8000.0,
) -> np.ndarray:
    """(n_samples,) float32 -> (num_mels, n_frames) log-mel, in C++."""
    if win_size != n_fft:
        raise ValueError("the native frontend needs win_size == n_fft")
    lib = _load()
    y = np.ascontiguousarray(y, dtype=np.float32)
    fb = np.ascontiguousarray(mel_filterbank(sampling_rate, n_fft, num_mels, fmin, fmax))
    pad = (n_fft - hop_size) // 2
    n_frames = 1 + (y.shape[0] + 2 * pad - n_fft) // hop_size
    out = np.empty((num_mels, n_frames), dtype=np.float32)
    written = lib.mel_spectrogram_c(
        y.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), y.shape[0],
        fb.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), num_mels, n_fft,
        hop_size, out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
    )
    if written != n_frames:
        raise RuntimeError(f"native mel frontend failed (returned {written}, expected {n_frames})")
    return out
