"""Sequence math: masks, length rounding, the duration path, the
duration loss and the mel normalisation."""

import math

import numpy as np
import torch


def sequence_mask(length: torch.Tensor, max_length: int) -> torch.Tensor:
    """Boolean mask (B, max_length): True where index < length."""
    x = torch.arange(max_length, dtype=length.dtype, device=length.device)
    return x[None, :] < length[:, None]


def fix_len_compatibility(length: int, num_downsamplings_in_unet: int = 2) -> int:
    """Round a mel length up to a multiple of 2**num_downsamplings."""
    factor = 2**num_downsamplings_in_unet
    return int(math.ceil(length / factor) * factor)


def round_up(n: int, grid: int) -> int:
    """Round ``n`` up to a multiple of ``grid`` (the data buckets)."""
    return ((n + grid - 1) // grid) * grid


def generate_path(duration: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Expand per-token durations (B, T_x) into a 0/1 alignment
    (B, T_x, T_y): row x covers frames [cumsum_{<x}, cumsum_{<=x})."""
    b, t_x, t_y = mask.shape
    cum_duration = torch.cumsum(duration, dim=1)
    path = sequence_mask(cum_duration.reshape(b * t_x), t_y).to(mask.dtype)
    path = path.reshape(b, t_x, t_y)
    path = path - torch.nn.functional.pad(path, (0, 0, 1, 0))[:, :-1]
    return path * mask


def duration_loss(logw: torch.Tensor, logw_: torch.Tensor,
                  lengths: torch.Tensor) -> torch.Tensor:
    """MSE between predicted and target log-durations, normalised by the
    total token count."""
    return torch.sum((logw - logw_) ** 2) / torch.sum(lengths)


def normalize(data, mu: float, std: float):
    """Mel normalisation: (data - mu) / std."""
    return (data - mu) / std


def denormalize(data: torch.Tensor, mu: float, std: float) -> torch.Tensor:
    """Inverse of the mel normalisation: data * std + mu."""
    return data * std + mu


def intersperse_ids(ids: np.ndarray, item: int = 0) -> np.ndarray:
    """Blank-interleave for numpy id arrays (host side)."""
    ids = np.asarray(ids)
    out = np.full(2 * ids.shape[-1] + 1, item, dtype=ids.dtype)
    out[1::2] = ids
    return out
