"""Seeded weights, made on the device in a few large draws.

Every convolution and linear layer gets its weight and bias from
U(-1/sqrt(fan_in), 1/sqrt(fan_in)), PyTorch's default scale for those
layers; every embedding N(0, 1), PyTorch's default. The norms' gains and
offsets and the snake parameters keep their constant defaults. One draw
of uniform numbers and one of normal numbers, from one
``torch.Generator`` on the device, cover all of them.

The same function fills the system under test's models and the
reference's: their parameters have the same names, and the state dict
made here is loaded into both.
"""

import torch
from torch import nn

_UNIFORM = (nn.Conv1d, nn.Conv2d, nn.ConvTranspose1d, nn.Linear)


def seeded_state_dict(module: nn.Module, seed: int) -> dict:
    """``module``'s state dict with its drawn parameters replaced by draws
    from ``seed``, on the module's device. ``module`` is changed in place
    (its parameters hold the draws)."""
    uniform, normal = [], []
    for m in module.modules():
        if isinstance(m, _UNIFORM):
            fan_in, _ = nn.init._calculate_fan_in_and_fan_out(m.weight)
            bound = 1.0 / fan_in ** 0.5
            uniform += [(m.weight, bound)] + ([(m.bias, bound)] if m.bias is not None else [])
        elif isinstance(m, nn.Embedding):
            normal.append((m.weight, 1.0))
    device = next(module.parameters()).device
    gen = torch.Generator(device).manual_seed(int(seed))
    with torch.no_grad():
        for group, draw in ((uniform, "uniform"), (normal, "normal")):
            total = sum(p.numel() for p, _ in group)
            if not total:
                continue
            flat = torch.empty(total, device=device)
            if draw == "uniform":
                flat.uniform_(-1.0, 1.0, generator=gen)
            else:
                flat.normal_(generator=gen)
            o = 0
            for p, scale in group:
                n = p.numel()
                p.copy_(flat[o:o + n].view_as(p) * scale)
                o += n
    return module.state_dict()
