"""Tensor parallelism: the ``model`` axis of the mesh, Megatron-style.

JAX splits the parameters that ``_TP_RULES`` name over the ``model`` axis
of its mesh and lets GSPMD insert the collectives. The port splits the
same parameters (``parallel/mesh.py::TP_RULES``) over the model group of
``parallel/dist.py`` and writes each collective by hand, as an autograd
function whose backward is the forward's adjoint:

* ``copy_to_model`` (Megatron's f): the identity forward; the backward
  sums the gradient over the model group. Each rank feeds the same
  replicated input to its shard of a column-split layer, so the input's
  gradient is the sum of the ranks' parts.
* ``reduce_from_model`` (g): the forward sums over the model group (the
  partial products of a row-split layer); the backward is the identity,
  since every rank's output is the same sum.
* ``gather_from_model``: the forward concatenates the ranks' last dims;
  the backward sums the gradient over the group and keeps the rank's
  slice (a reduce-scatter), since every rank used the whole.

``shard_model(model)`` replaces each ruled parameter with the
rank's slice in place and wires the collectives around the layers: f on
the input of each column-split pair (an attention module, the encoder's
``conv_1``, the decoder's feed-forward, the time MLP), g on the output of
its row-split layer, whose bias is added once, after the sum. The
model's forward code stays the one it runs unsplit. An attention module
whose heads divide by ``n_model`` runs the rank's heads; otherwise (2
heads over 4 ranks) it gathers q, k and v, runs the whole attention on
every rank and hands the row-split output projection the rank's channels.
Dropout on a split tensor draws its mask at full width and keeps the
rank's part (``ShardedDropout``), so the masks are those of the unsplit
model. Checkpoints hold the gathered tensors (``full_state_dict``,
``full_optimizer_state``) and are sharded again on load.
"""

import dataclasses
from typing import Dict, List, Optional, Set

import torch
import torch.distributed as tdist
import torch.nn.functional as F
from torch import nn

from matcha_tpu_torch.models.components.common import Conv1d, PointwiseConv1d, TimestepEmbedding
from matcha_tpu_torch.models.components.text_encoder import FFN, MultiHeadAttention
from matcha_tpu_torch.models.components.transformer import GEGLU, Attention, FeedForward
from matcha_tpu_torch.parallel import dist
from matcha_tpu_torch.parallel.mesh import param_shard_dim


def _memory_order(t: torch.Tensor) -> List[int]:
    """``t``'s dims from the slowest to the fastest in memory."""
    return sorted(range(t.dim()), key=lambda d: (-t.stride(d), d))


def model_all_reduce(t: torch.Tensor) -> torch.Tensor:
    """A copy of ``t`` summed over the model group, in ``t``'s memory
    layout (a transposed view stays one: the unsplit model's dropout
    draws its mask in its input's layout, so the split one must see the
    same layout)."""
    out = t.clone()  # a dense tensor keeps its strides
    buf = out.permute(_memory_order(out))
    if not buf.is_contiguous():
        out = buf = t.contiguous()
    tdist.all_reduce(buf, op=tdist.ReduceOp.SUM, group=dist.model_group())
    return out


class _CopyToModel(torch.autograd.Function):
    """y = x on every rank; dL/dx = sum over the ranks of dL/dy."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return model_all_reduce(grad)


class _ReduceFromModel(torch.autograd.Function):
    """y = sum over the ranks of x_r; dL/dx_r = dL/dy, the same on every
    rank."""

    @staticmethod
    def forward(ctx, x):
        return model_all_reduce(x)

    @staticmethod
    def backward(ctx, grad):
        return grad


class _GatherFromModel(torch.autograd.Function):
    """y = concat over the ranks of x_r on the last dim; dL/dx_r = rank
    r's slice of the sum over the ranks of dL/dy."""

    @staticmethod
    def forward(ctx, x):
        x = x.contiguous()
        parts = [torch.empty_like(x) for _ in range(dist.n_model())]
        tdist.all_gather(parts, x, group=dist.model_group())
        ctx.width = x.shape[-1]
        return torch.cat(parts, dim=-1)

    @staticmethod
    def backward(ctx, grad):
        return model_all_reduce(grad).narrow(-1, dist.model_rank() * ctx.width, ctx.width)


def copy_to_model(x: torch.Tensor) -> torch.Tensor:
    return _CopyToModel.apply(x)


def reduce_from_model(x: torch.Tensor) -> torch.Tensor:
    return _ReduceFromModel.apply(x)


def gather_from_model(x: torch.Tensor) -> torch.Tensor:
    return _GatherFromModel.apply(x)


def _row(layer, x: torch.Tensor, partial) -> torch.Tensor:
    """A row-split layer: the rank's input channels (its slice of a
    gathered input first, when ``tp_in_slice`` is set) through its
    weight's columns, summed over the group, then the bias, once."""
    if layer.tp_in_slice is not None:
        x = x.narrow(-1, *layer.tp_in_slice)
    y = reduce_from_model(partial(x))
    return y if layer.bias is None else y + layer.bias.to(y.dtype)


class RowLinear(nn.Linear):
    """A row-split ``nn.Linear`` (or ``common.Linear``: the weight takes
    the input's type)."""

    tp_in_slice = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return _row(self, x, lambda v: F.linear(v, self.weight.to(v.dtype)))


class RowPointwiseConv1d(PointwiseConv1d):
    tp_in_slice = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return _row(self, x, lambda v: F.linear(v, self.weight[:, :, 0]))


class RowConv1d(Conv1d):
    tp_in_slice = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return _row(self, x, lambda v: self._conv_forward(v.transpose(1, 2), self.weight,
                                                          None).transpose(1, 2))


_ROW_CLASSES = ((PointwiseConv1d, RowPointwiseConv1d), (Conv1d, RowConv1d),
                (nn.Linear, RowLinear))


def _dense_ones(x: torch.Tensor, size: List[int]) -> torch.Tensor:
    """Ones of ``size`` laid out in memory in ``x``'s order of dims (the
    layout the unsplit module's dropout input has)."""
    order = _memory_order(x)
    t = torch.ones([size[d] for d in order], dtype=x.dtype, device=x.device)
    return t.permute([order.index(d) for d in range(x.dim())])


class ShardedDropout(nn.Dropout):
    """Dropout on a tensor split along ``dim`` over the model group: the
    mask is drawn at full width, in the unsplit tensor's layout, from the
    generator that every rank seeds alike, and the rank keeps its part.
    ``x * dropout(ones)`` equals ``dropout(x)`` bit for bit (both are x
    times the same mask of 0 and 1 / (1 - p))."""

    def __init__(self, p: float, dim: int, n_model: int, rank: int):
        super().__init__(p)
        self.dim, self.n_model, self.rank = dim, n_model, rank

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training or self.p == 0:
            return x
        dim = self.dim % x.dim()
        size = list(x.shape)
        size[dim] *= self.n_model
        mask = F.dropout(_dense_ones(x, size), self.p, True)
        return x * mask.narrow(dim, self.rank * x.shape[dim], x.shape[dim])


@dataclasses.dataclass
class Plan:
    """How a model is split: the dim of each split parameter, and the
    parameters split in two halves (a GEGLU projection, whose output is
    chunked into value and gate: each rank takes its part of both)."""

    n_model: int
    rank: int
    dims: Dict[str, int]
    halves: Set[str]

    def index(self, name: str, full: int, rank: int) -> torch.Tensor:
        """The indices along the split dim that ``rank`` holds."""
        if name in self.halves:
            half = full // 2
            part = torch.arange(rank * half // self.n_model, (rank + 1) * half // self.n_model)
            return torch.cat([part, part + half])
        step = full // self.n_model
        return torch.arange(rank * step, (rank + 1) * step)


def plan_of(model: nn.Module) -> Optional[Plan]:
    """The model's ``Plan``, or None when it is not split."""
    return getattr(model, "tensor_parallel", None)


def _copy_first_arg(module, args):
    return (copy_to_model(args[0]),) + tuple(args[1:])


def _gather_output(module, args, out):
    return gather_from_model(out)


def _to_row(layer: nn.Module, in_slice=None) -> None:
    for base, row in _ROW_CLASSES:
        if isinstance(layer, base):
            layer.__class__ = row
            layer.tp_in_slice = in_slice
            return
    raise TypeError(f"no row-split form of {type(layer).__name__}")


def shard_model(model: nn.Module) -> Plan:
    """Split ``model`` over this rank's model group (``dist.set_model_axis``)
    in place; every rank of the group calls it on the same weights. Each
    parameter that ``TP_RULES`` name becomes the rank's slice, and the
    collectives are wired around the split layers (module doc). Build the
    optimizer and any ``DistributedDataParallel`` wrapper after this
    call."""
    n_model, rank = dist.n_model(), dist.model_rank()
    if plan_of(model) is not None:
        raise RuntimeError("the model is split already")
    params = dict(model.named_parameters())
    dims = {name: d for name, p in params.items()
            if (d := param_shard_dim(name, p.shape, n_model)) is not None}
    plan = Plan(n_model, rank, dims, set())
    wired: Set[str] = set()

    def split(prefix: str, *names: str) -> bool:
        return all(f"{prefix}.{n}" in dims for n in names)

    for prefix, m in list(model.named_modules()):
        if isinstance(m, MultiHeadAttention) and split(prefix, "conv_q.weight", "conv_o.weight"):
            _wire_attention(m, [m.conv_q, m.conv_k, m.conv_v], m.conv_o, m.n_heads, plan)
            if m.n_heads % n_model == 0:  # dropout on the rank's heads' probabilities
                m.drop = ShardedDropout(m.drop.p, 1, n_model, rank)
            wired.update(f"{prefix}.conv_{c}.{w}" for c in "qkv" for w in ("weight", "bias"))
            wired.add(f"{prefix}.conv_o.weight")
        elif isinstance(m, Attention) and split(prefix, "to_q.weight", "to_out.0.weight"):
            _wire_attention(m, [m.to_q, m.to_k, m.to_v], m.to_out[0], m.heads, plan)
            wired.update(f"{prefix}.to_{c}.weight" for c in ("q", "k", "v", "out.0"))
        elif isinstance(m, FFN) and split(prefix, "conv_1.weight", "conv_2.weight"):
            m.conv_1.register_forward_pre_hook(_copy_first_arg)
            _to_row(m.conv_2)
            m.drop = ShardedDropout(m.drop.p, -1, n_model, rank)
            wired.update(f"{prefix}.{n}" for n in ("conv_1.weight", "conv_1.bias",
                                                    "conv_2.weight"))
        elif isinstance(m, FeedForward) and split(prefix, "net.0.proj.weight", "net.2.weight"):
            m.net[0].register_forward_pre_hook(_copy_first_arg)
            m.net[1] = ShardedDropout(m.net[1].p, -1, n_model, rank)
            _to_row(m.net[2])
            act = [f"{prefix}.net.0.{n}" for n in ("proj.weight", "proj.bias", "alpha", "beta")]
            if isinstance(m.net[0], GEGLU):
                plan.halves.update(act[:2])
            wired.update(act + [f"{prefix}.net.2.weight"])
        elif isinstance(m, TimestepEmbedding) and split(prefix, "linear_1.weight",
                                                        "linear_2.weight"):
            m.linear_1.register_forward_pre_hook(_copy_first_arg)
            _to_row(m.linear_2)
            wired.update(f"{prefix}.{n}" for n in ("linear_1.weight", "linear_1.bias",
                                                    "linear_2.weight"))
    stray = sorted(set(dims) - wired)
    if stray:
        raise RuntimeError(f"split parameters outside a split layer pair: {stray}")
    for name, d in dims.items():
        owner, _, leaf = name.rpartition(".")
        module = model.get_submodule(owner)
        p = params[name]
        part = p.detach().index_select(d, plan.index(name, p.shape[d], rank).to(p.device))
        setattr(module, leaf, nn.Parameter(part.clone(), requires_grad=p.requires_grad))
    model.tensor_parallel = plan
    return plan


def _wire_attention(module: nn.Module, qkv, out: nn.Module, heads: int, plan: Plan) -> None:
    """f at the attention's input and g after its output projection; when
    the heads do not divide over the group, q, k and v are gathered and
    the output projection takes the rank's slice of the channels."""
    module.register_forward_pre_hook(_copy_first_arg)
    if heads % plan.n_model == 0:
        _to_row(out)
        return
    for layer in qkv:
        layer.register_forward_hook(_gather_output)
    width = out.weight.shape[1] // plan.n_model
    _to_row(out, (plan.rank * width, width))


def sharded_mask(model: nn.Module, names: List[str]) -> Optional[List[bool]]:
    """Which of the named parameters are split; None for a model that is
    not split."""
    plan = plan_of(model)
    return None if plan is None else [n in plan.dims for n in names]


def full_tensor(model: nn.Module, name: str, t: torch.Tensor) -> torch.Tensor:
    """``t``, the rank's slice of the split parameter ``name`` (or of its
    gradient or a moment of it), gathered to the full shape (a
    collective); ``t`` itself for a parameter that is not split."""
    plan = plan_of(model)
    return t if plan is None or name not in plan.dims else _gather(plan, name, t)


def _gather(plan: Plan, name: str, t: torch.Tensor) -> torch.Tensor:
    d = plan.dims[name]
    t = t.contiguous()
    parts = [torch.empty_like(t) for _ in range(plan.n_model)]
    tdist.all_gather(parts, t, group=dist.model_group())
    size = list(t.shape)
    size[d] *= plan.n_model
    full = t.new_empty(size)
    for r, part in enumerate(parts):
        full.index_copy_(d, plan.index(name, size[d], r).to(t.device), part)
    return full


def _slice(plan: Plan, name: str, t: torch.Tensor) -> torch.Tensor:
    d = plan.dims[name]
    return t.index_select(d, plan.index(name, t.shape[d], plan.rank).to(t.device))


def full_state_dict(model: nn.Module) -> dict:
    """The model's state dict with every split tensor gathered (a
    collective: every rank of the model group calls it)."""
    sd = model.state_dict()
    plan = plan_of(model)
    if plan is not None:
        for name in plan.dims:
            sd[name] = _gather(plan, name, sd[name])
    return sd


def shard_state_dict(model: nn.Module, sd: dict) -> dict:
    """A full state dict cut to the rank's slices of the split tensors."""
    plan = plan_of(model)
    if plan is None:
        return sd
    return {k: _slice(plan, k, v) if k in plan.dims else v for k, v in sd.items()}


def _optimizer_names(model: nn.Module) -> List[str]:
    """The parameter names in the order ``make_optimizer`` lists them."""
    return [n for n, p in model.named_parameters() if p.requires_grad]


def _map_optimizer_state(model: nn.Module, state: dict, fn, full: bool) -> dict:
    plan = plan_of(model)
    if plan is None:
        return state
    names = _optimizer_names(model)
    params = dict(model.named_parameters())
    out = {}
    for i in sorted(state["state"]):
        name, entry = names[i], dict(state["state"][i])
        if name in plan.dims:
            shape = list(params[name].shape)
            if full:
                shape[plan.dims[name]] *= plan.n_model
            for k, v in entry.items():
                if torch.is_tensor(v) and list(v.shape) == shape:
                    entry[k] = fn(plan, name, v)
        out[i] = entry
    return {"state": out, "param_groups": state["param_groups"]}


def full_optimizer_state(model: nn.Module, optimizer) -> dict:
    """The optimizer's state dict with the moments of every split
    parameter gathered (a collective)."""
    return _map_optimizer_state(model, optimizer.state_dict(), _gather, False)


def shard_optimizer_state(model: nn.Module, state: dict) -> dict:
    """A full optimizer state dict cut to the rank's slices."""
    return _map_optimizer_state(model, state, _slice, True)


def full_numel(model: nn.Module) -> int:
    """The unsplit model's parameter count."""
    plan = plan_of(model)
    n = plan.n_model if plan is not None else 1
    return sum(p.numel() * (n if plan is not None and k in plan.dims else 1)
               for k, p in model.named_parameters())
