"""Host-side helpers: wav I/O and the 24-bit PCM wire format, the blank
interleave, the sweep metric, plots, and the entry points' task wrappers.

The port's own copies of ``matcha_tpu/utils/utils.py``'s ``pcm24_bytes``,
``write_wav``, ``read_wav``, ``get_metric_value``, ``plot_tensor``,
``save_plot``, ``extras``, ``enforce_tags`` and ``task_wrapper``;
``intersperse`` is the text frontend's.
"""

import os
import struct
import sys
import warnings
import wave
import zlib

import numpy as np
import torch

from matcha_tpu_torch.text import intersperse
from matcha_tpu_torch.utils.pylogger import get_pylogger, process_rank

__all__ = ["intersperse", "pcm24_bytes", "pack_pcm24", "unpack_pcm24", "pcm24_lengths",
           "write_wav", "read_wav", "get_metric_value", "plot_tensor", "save_plot", "write_png",
           "extras", "enforce_tags", "task_wrapper"]

log = get_pylogger(__name__)

#: 24-bit PCM full scale
PCM24_SCALE = 2**23 - 1


def pcm24_bytes(audio: np.ndarray) -> bytes:
    """Mono float waveform -> 24-bit little-endian PCM frames (clipped to
    [-1, 1], scaled by 2^23 - 1, truncated toward zero): the one encoder
    of written files and of the serving daemon's responses."""
    clipped = np.clip(np.asarray(audio, dtype=np.float32).squeeze(), -1.0, 1.0)
    scaled = (clipped * PCM24_SCALE).astype("<i4")
    return np.frombuffer(scaled.tobytes(), dtype=np.uint8).reshape(-1, 4)[:, :3].tobytes()


def pack_pcm24(wav: torch.Tensor, mel_lengths: torch.Tensor) -> torch.Tensor:
    """(B, n) f32 waveform -> (B, 3n+3) uint8 little-endian 24-bit PCM on
    the waveform's device (clip, scale by 2^23-1, truncate toward zero,
    low 3 bytes), with mel_lengths appended as one trailing sample per
    row."""
    v = (torch.clamp(wav, -1.0, 1.0) * PCM24_SCALE).to(torch.int32)
    v = torch.cat([v, mel_lengths[:, None].to(torch.int32)], dim=1)
    b = torch.stack([v & 0xFF, (v >> 8) & 0xFF, (v >> 16) & 0xFF], dim=-1)
    return b.to(torch.uint8).reshape(v.shape[0], -1)


def unpack_pcm24(arr: np.ndarray):
    """Host inverse of ``pack_pcm24``: (B, 3n+3) uint8 -> f32 waveform
    (B, n) + int32 mel_lengths (B,)."""
    u = arr.reshape(arr.shape[0], -1, 3).astype(np.int32)
    v = u[..., 0] | (u[..., 1] << 8) | (u[..., 2] << 16)
    v = (v ^ 0x800000) - 0x800000  # sign-extend 24 -> 32 bit
    wav = (v[:, :-1] / np.float32(PCM24_SCALE)).astype(np.float32)
    return wav, v[:, -1].astype(np.int32)


def pcm24_lengths(arr: np.ndarray) -> np.ndarray:
    """mel_lengths from packed PCM24 rows without decoding the audio: only
    the trailing 3-byte sample of each row is read (lengths are positive
    and below 2^23). The other bytes of a row are the WAV frames as
    ``write_wav`` writes them."""
    t = arr[:, -3:].astype(np.int32)
    return t[:, 0] | (t[:, 1] << 8) | (t[:, 2] << 16)


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


def extras(cfg) -> None:
    """The config's ``extras`` before a task starts: ``ignore_warnings``,
    ``enforce_tags`` and ``print_config`` (the last two also write
    ``tags.log`` and ``config_tree.log`` into ``paths.output_dir``)."""
    if not cfg.get("extras"):
        log.warning("Extras config not found! <cfg.extras=null>")
        return

    if cfg.extras.get("ignore_warnings"):
        log.info("Disabling python warnings! <cfg.extras.ignore_warnings=True>")
        warnings.filterwarnings("ignore")

    # in a process group every rank sets the tags; rank 0 writes the files
    if cfg.extras.get("enforce_tags"):
        enforce_tags(cfg, save_to_file=process_rank() == 0)

    if cfg.extras.get("print_config") and process_rank() == 0:
        from matcha_tpu_torch.utils.config import print_config_tree

        print_config_tree(cfg, save_to_file=True)


def enforce_tags(cfg, save_to_file: bool = False) -> None:
    """Run tags when the config gives none: on an interactive terminal a
    comma-separated list is asked for (default "dev"), otherwise ["dev"]
    with a warning. Only rank 0 asks; a multirun must set them first."""
    if cfg.get("tags"):
        return
    if cfg.get("_multirun"):
        raise ValueError("Specify tags before launching a multirun!")

    tags = None
    if process_rank() == 0 and sys.stdin is not None and sys.stdin.isatty():
        log.warning("No tags provided in config. Prompting user to input tags...")
        raw = input('Enter a list of comma separated tags (default "dev"): ')
        tags = [t.strip() for t in raw.split(",") if t.strip()]
    if not tags:
        log.warning('No tags provided; using default ["dev"]')
        tags = ["dev"]
    cfg["tags"] = tags
    log.info(f"Tags: {tags}")
    out_dir = cfg.get("paths", {}).get("output_dir")
    if save_to_file and out_dir:
        # extras() runs before the task creates the run directory
        os.makedirs(str(out_dir), exist_ok=True)
        with open(os.path.join(str(out_dir), "tags.log"), "w", encoding="utf-8") as f:
            f.write(", ".join(tags) + "\n")


def task_wrapper(task_func):
    """A task entry point ``task_func(cfg=..., **kwargs) -> (metric_dict,
    object_dict)`` whose exceptions are logged before they propagate, and
    which logs the output directory however it ends."""

    def wrap(cfg, **kwargs):
        try:
            metric_dict, object_dict = task_func(cfg=cfg, **kwargs)
        except Exception as ex:
            log.exception("")
            raise ex
        finally:
            output_dir = cfg.get("paths", {}).get("output_dir", None)
            if output_dir is not None:
                log.info(f"Output dir: {output_dir}")
        return metric_dict, object_dict

    return wrap


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


def _png_chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def write_png(path, image: np.ndarray) -> None:
    """An (H, W, 3) uint8 image as an 8-bit RGB PNG: the signature, IHDR,
    one zlib IDAT (filter byte 0 on each row) and IEND."""
    image = np.ascontiguousarray(image, dtype=np.uint8)
    if image.ndim != 3 or image.shape[2] != 3:
        raise ValueError(f"expected an (H, W, 3) image, got shape {image.shape}")
    h, w = image.shape[:2]
    rows = np.concatenate([np.zeros((h, 1), np.uint8), image.reshape(h, w * 3)], axis=1)
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n")
        f.write(_png_chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)))
        f.write(_png_chunk(b"IDAT", zlib.compress(rows.tobytes())))
        f.write(_png_chunk(b"IEND", b""))


def save_plot(tensor, savepath) -> None:
    """A 2-D array as a ``.png``: the JAX package's 12 x 3 inch matplotlib
    figure (Agg) with a colour bar; where matplotlib is not installed,
    ``plot_tensor``'s numpy rendering (one pixel per element, viridis)."""
    try:
        import matplotlib
    except ImportError:
        write_png(savepath, plot_tensor(tensor))
        return

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(12, 3))
    im = ax.imshow(np.asarray(tensor), aspect="auto", origin="lower", interpolation="none")
    plt.colorbar(im, ax=ax)
    plt.tight_layout()
    fig.savefig(savepath)
    plt.close(fig)
