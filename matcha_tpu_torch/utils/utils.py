"""Host-side helpers: wav I/O, the blank interleave, the sweep metric, plots.

The port's own copies of ``matcha_tpu/utils/utils.py``'s ``pcm24_bytes``,
``write_wav``, ``read_wav``, ``get_metric_value`` and ``plot_tensor``;
``intersperse`` is the text frontend's.
"""

import logging
import wave

import numpy as np

from matcha_tpu_torch.text import intersperse

__all__ = ["intersperse", "pcm24_bytes", "write_wav", "read_wav", "get_metric_value",
           "plot_tensor"]

log = logging.getLogger(__name__)

#: 24-bit PCM full scale
PCM24_SCALE = 2**23 - 1


def pcm24_bytes(audio: np.ndarray) -> bytes:
    """Mono float waveform -> 24-bit little-endian PCM frames (clipped to
    [-1, 1], scaled by 2^23 - 1, truncated toward zero): the one encoder
    of written files and of the serving daemon's responses."""
    clipped = np.clip(np.asarray(audio, dtype=np.float32).squeeze(), -1.0, 1.0)
    scaled = (clipped * PCM24_SCALE).astype("<i4")
    return np.frombuffer(scaled.tobytes(), dtype=np.uint8).reshape(-1, 4)[:, :3].tobytes()


def write_wav(path, audio: np.ndarray, sample_rate: int = 22050) -> None:
    """Mono waveform, clipped to [-1, 1] -> 24-bit PCM .wav."""
    with wave.open(str(path), "wb") as f:
        f.setnchannels(1)
        f.setsampwidth(3)
        f.setframerate(sample_rate)
        f.writeframes(pcm24_bytes(audio))


def read_wav(path) -> tuple:
    """A wav file as mono float32 in [-1, 1]: (audio, sample_rate)."""
    from scipy.io import wavfile

    sr, data = wavfile.read(path)
    if data.dtype == np.int16:
        data = data.astype(np.float32) / 32768.0
    elif data.dtype == np.int32:
        data = data.astype(np.float32) / 2147483648.0
    elif data.dtype == np.uint8:
        data = (data.astype(np.float32) - 128.0) / 128.0
    else:
        data = data.astype(np.float32)
    if data.ndim > 1:
        data = data.mean(axis=1)
    return data, sr


def get_metric_value(metric_dict: dict, metric_name):
    """The value of the metric a sweep optimises, or None without a name."""
    if not metric_name:
        log.info("Metric name is None! Skipping metric value retrieval...")
        return None
    if metric_name not in metric_dict:
        raise ValueError(
            f"Metric value not found! <metric_name={metric_name}>\n"
            "Make sure metric name logged during training is correct!\n"
            "Make sure `optimized_metric` name in `hparams_search` config is correct!")
    metric_value = float(metric_dict[metric_name])
    log.info(f"Retrieved metric value! <{metric_name}={metric_value}>")
    return metric_value


#: viridis at 0, 1/4, 1/2, 3/4 and 1: the colours of ``plot_tensor``'s
#: rendering without matplotlib
_VIRIDIS = np.array([[68, 1, 84], [59, 82, 139], [33, 145, 140], [94, 201, 98],
                     [253, 231, 37]], dtype=np.float64)


def plot_tensor(tensor) -> np.ndarray:
    """A 2-D array as an (H, W, 3) uint8 image, its first axis upwards: a
    12 x 3 inch matplotlib figure (Agg) with a colour bar, as the JAX
    package draws it. Where matplotlib is not installed, the array itself,
    one pixel per element, min-max scaled through viridis."""
    data = np.asarray(tensor, dtype=np.float32)
    try:
        import matplotlib
    except ImportError:
        lo, hi = float(data.min()), float(data.max())
        x = (data - lo) / (hi - lo) if hi > lo else np.zeros_like(data)
        pos = x[::-1] * (len(_VIRIDIS) - 1)
        i = np.minimum(pos.astype(np.int64), len(_VIRIDIS) - 2)
        frac = (pos - i)[..., None]
        return np.round(_VIRIDIS[i] * (1 - frac) + _VIRIDIS[i + 1] * frac).astype(np.uint8)

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(12, 3))
    im = ax.imshow(data, aspect="auto", origin="lower", interpolation="none")
    plt.colorbar(im, ax=ax)
    plt.tight_layout()
    fig.canvas.draw()
    image = np.asarray(fig.canvas.buffer_rgba())[..., :3].copy()
    plt.close(fig)
    return image
