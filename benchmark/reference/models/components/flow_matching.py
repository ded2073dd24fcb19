"""OT-CFM sampling: integrate the learned vector field with fixed-step Euler.

Port of ``matcha_tpu/models/components/flow_matching.py``: sampling and
the training loss. The noise (the terminal ``z`` of sampling; the flow
time ``t`` and the source ``z`` of the loss) is either handed in (the
tests pass JAX's draws, which torch cannot reproduce) or drawn from an
explicit ``torch.Generator``.
"""

from typing import Callable, Optional

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from benchmark.reference.models.components.decoder import Decoder


def euler_schedule(n_timesteps: int, device=None) -> torch.Tensor:
    """Uniform t_span in [0, 1] with n_timesteps+1 points, as ``iota *
    (1/n)`` in f32 (bit-equal to ``jnp.linspace`` for the usual step
    counts). Built on the device, with no host-to-device copy, so that a
    CUDA graph can capture it."""
    step = torch.full((), 1.0, device=device) / n_timesteps
    return torch.arange(n_timesteps + 1, dtype=torch.float32, device=device) * step


def solve_euler(estimator: Callable, x: torch.Tensor, t_span: torch.Tensor,
                mu: torch.Tensor, mask: torch.Tensor,
                spks: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x_{i+1} = x_i + dt_i * estimator(x_i, mask, mu, t_i, spks) over
    t_span. The f32 dt is cast to x's type first, so that a bf16 x stays
    bf16."""
    dts = (t_span[1:] - t_span[:-1]).to(x.dtype)
    for t, dt in zip(t_span[:-1], dts):
        x = x + dt * estimator(x, mask, mu, t, spks)
    return x


def cfm_sample(estimator: Callable, mu: torch.Tensor, mask: torch.Tensor,
               n_timesteps: int, temperature: float = 1.0,
               z: Optional[torch.Tensor] = None,
               generator: Optional[torch.Generator] = None,
               spks: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Integrate the probability flow from ``z * temperature`` (z unit
    normal, shaped like ``mu``; drawn from ``generator`` when not given),
    conditioned on the speaker embeddings ``spks`` (B, spk_emb_dim) or None.
    The noise is drawn in f32 and then cast to ``mu``'s type, as in JAX:
    a bf16 flow starts from the f32 flow's z, rounded."""
    if z is None:
        z = torch.randn(mu.shape, generator=generator, device=mu.device, dtype=torch.float32)
    elif z.shape != mu.shape:
        raise ValueError(f"z has shape {tuple(z.shape)}, expected {tuple(mu.shape)}")
    t_span = euler_schedule(n_timesteps, device=mu.device)
    return solve_euler(estimator, z.to(mu.device, mu.dtype) * temperature, t_span, mu, mask,
                       spks)


class CFM(nn.Module):
    """Holds the U-Net as ``estimator`` (the reference's ``decoder``
    module, so its keys read ``decoder.estimator.*``). ``remat``: the loss
    runs the estimator under ``torch.utils.checkpoint`` (JAX's
    ``jax.checkpoint``), so its activations are recomputed in the backward
    pass instead of kept."""

    def __init__(self, estimator: Decoder, sigma_min: float = 1e-4, remat: bool = False):
        super().__init__()
        self.estimator = estimator
        self.sigma_min = sigma_min
        self.remat = remat

    def forward(self, mu, mask, n_timesteps, temperature=1.0, z=None, generator=None,
                spks=None):
        return cfm_sample(self.estimator, mu, mask, n_timesteps, temperature, z, generator,
                          spks)

    def compute_loss(self, x1: torch.Tensor, mask: torch.Tensor, mu: torch.Tensor,
                     t: Optional[torch.Tensor] = None, z: Optional[torch.Tensor] = None,
                     generator: Optional[torch.Generator] = None,
                     spks: Optional[torch.Tensor] = None) -> torch.Tensor:
        """OT-CFM loss: regress the estimator at ``y_t = (1 - (1 - sigma_min) t) z
        + t x1`` onto ``u = x1 - (1 - sigma_min) z``. ``x1``, ``mu``: (B, T,
        n_feats); ``mask`` (B, T, 1); ``t`` (B,) uniform in [0, 1) in
        ``mu``'s type and ``z`` unit normal in ``x1``'s (JAX draws them so),
        drawn from ``generator`` when not given; ``spks`` (B, spk_emb_dim)
        or None. The squared error is summed over the whole padded tensor
        and divided by sum(mask) * n_feats, the reference normalisation."""
        B = x1.shape[0]
        if t is None:
            t = torch.rand(B, generator=generator, device=x1.device, dtype=mu.dtype)
        if z is None:
            z = torch.randn(x1.shape, generator=generator, device=x1.device, dtype=x1.dtype)
        t = t.to(x1.device, mu.dtype).reshape(B, 1, 1)
        z = z.to(x1.device, x1.dtype)
        y = (1.0 - (1.0 - self.sigma_min) * t) * z + t * x1
        u = x1 - (1.0 - self.sigma_min) * z
        if self.remat and torch.is_grad_enabled():
            pred = checkpoint(self.estimator, y, mask, mu, t[:, 0, 0], spks, use_reentrant=False)
        else:
            pred = self.estimator(y, mask, mu, t[:, 0, 0], spks)
        return torch.sum((pred - u) ** 2) / (torch.sum(mask) * u.shape[-1])
