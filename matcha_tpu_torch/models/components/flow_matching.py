"""OT-CFM sampling: integrate the learned vector field with fixed-step Euler.

Port of ``matcha_tpu/models/components/flow_matching.py`` (inference
only). The terminal noise is either handed in as a unit-normal ``z`` (the
tests pass JAX's draw, which torch cannot reproduce) or drawn from an
explicit ``torch.Generator``.
"""

from typing import Callable, Optional

import torch
from torch import nn

from matcha_tpu_torch.models.components.decoder import Decoder


def euler_schedule(n_timesteps: int, device=None) -> torch.Tensor:
    """Uniform t_span in [0, 1] with n_timesteps+1 points, as ``iota *
    (1/n)`` in f32 (bit-equal to ``jnp.linspace`` for the usual step
    counts)."""
    step = torch.tensor(1.0, device=device) / n_timesteps
    return torch.arange(n_timesteps + 1, dtype=torch.float32, device=device) * step


def solve_euler(estimator: Callable, x: torch.Tensor, t_span: torch.Tensor,
                mu: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """x_{i+1} = x_i + dt_i * estimator(x_i, mask, mu, t_i) over t_span."""
    dts = t_span[1:] - t_span[:-1]
    for t, dt in zip(t_span[:-1], dts):
        x = x + dt * estimator(x, mask, mu, t)
    return x


def cfm_sample(estimator: Callable, mu: torch.Tensor, mask: torch.Tensor,
               n_timesteps: int, temperature: float = 1.0,
               z: Optional[torch.Tensor] = None,
               generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Integrate the probability flow from ``z * temperature`` (z unit
    normal, shaped like ``mu``; drawn from ``generator`` when not given)."""
    if z is None:
        z = torch.randn(mu.shape, generator=generator, device=mu.device, dtype=mu.dtype)
    elif z.shape != mu.shape:
        raise ValueError(f"z has shape {tuple(z.shape)}, expected {tuple(mu.shape)}")
    t_span = euler_schedule(n_timesteps, device=mu.device)
    return solve_euler(estimator, z.to(mu.device, mu.dtype) * temperature, t_span, mu, mask)


class CFM(nn.Module):
    """Holds the U-Net as ``estimator`` (the reference's ``decoder``
    module, so its keys read ``decoder.estimator.*``)."""

    def __init__(self, estimator: Decoder):
        super().__init__()
        self.estimator = estimator

    def forward(self, mu, mask, n_timesteps, temperature=1.0, z=None, generator=None):
        return cfm_sample(self.estimator, mu, mask, n_timesteps, temperature, z, generator)
