"""The mesh: which devices a run uses, how a batch splits over them, and
which parameters tensor parallelism splits. The port of
``matcha_tpu/parallel/mesh.py``.

The ``data`` axis: JAX shards the leading axis of a batch over it; the
port gives each data index a contiguous slice of rows: a rank of a
``DistributedDataParallel`` job in training (every rank of a model group
holds the same rows), a replica of the models in serving
(``pipeline.TTSPipeline(devices=)``).

The ``model`` axis (``TP_RULES``): the wide projections split
Megatron-style, a column split (output features) then a row split (input
features), so that each attention or feed-forward pair needs one sum over
the model group (``parallel/tensor.py`` inserts it; GSPMD does in JAX).
The rules are JAX's ``_TP_RULES`` on the port's parameter names: a flax
kernel carries its output features last, a torch conv or linear weight on
dim 0, so JAX's ``P(None, "model")`` on a kernel is dim 0 here and a row
split is dim 1.
"""

import math
import re
from typing import List, Optional, Sequence, Union

import torch

Devices = Union[None, str, int, Sequence[int]]

#: (parameter name pattern, the torch dim it splits on), one per rule of
#: JAX's ``_TP_RULES``; a row layer's bias is never split
TP_RULES = [
    # encoder conv FFN: conv_1 (F, C, k) col / conv_2 (C, F, k) row
    (r".*ffn_layers\.\d+\.conv_1\.weight$", 0),
    (r".*ffn_layers\.\d+\.conv_1\.bias$", 0),
    (r".*ffn_layers\.\d+\.conv_2\.weight$", 1),
    # encoder attention (1x1 convs): q/k/v col, o row
    (r".*attn_layers\.\d+\.conv_[qkv]\.weight$", 0),
    (r".*attn_layers\.\d+\.conv_[qkv]\.bias$", 0),
    (r".*attn_layers\.\d+\.conv_o\.weight$", 1),
    # decoder transformer attention
    (r".*\.attn1\.to_[qkv]\.weight$", 0),
    (r".*\.attn1\.to_out\.0\.weight$", 1),
    # decoder feed-forward: the activation's projection and its alpha/beta
    # col, the output Linear row
    (r".*\.ff\.net\.0\.proj\.weight$", 0),
    (r".*\.ff\.net\.0\.proj\.bias$", 0),
    (r".*\.ff\.net\.0\.(alpha|beta)$", 0),
    (r".*\.ff\.net\.2\.weight$", 1),
    # time MLP
    (r".*\.time_mlp\.linear_1\.weight$", 0),
    (r".*\.time_mlp\.linear_1\.bias$", 0),
    (r".*\.time_mlp\.linear_2\.weight$", 1),
]


def param_shard_dim(name: str, shape, n_model: int) -> Optional[int]:
    """The dim a parameter splits on over a model axis of ``n_model``, or
    None (replicated): no rule matches, or ``n_model`` does not divide
    that dim (JAX's ``param_pspec``)."""
    if n_model > 1:
        for pattern, dim in TP_RULES:
            if re.match(pattern, name):
                return dim if dim < len(shape) and shape[dim] % n_model == 0 else None
    return None


def mesh_coords(rank: int, n_model: int) -> tuple:
    """(data index, model index) of a rank: JAX's ``reshape(n_data,
    n_model)`` of the device list."""
    return rank // n_model, rank % n_model


def local_devices(devices: Devices = "all") -> List[torch.device]:
    """The local GPUs a run uses, as JAX's ``trainer.devices``: ``"all"``
    (also None, ``"auto"``, -1) every visible GPU, N the first N of them,
    a list those indices. Raises without a GPU and for an index that is
    not visible."""
    count = torch.cuda.device_count()
    if count == 0:
        raise RuntimeError("no CUDA device found")
    if isinstance(devices, (list, tuple)) or (hasattr(devices, "__iter__")
                                              and not isinstance(devices, str)):
        idx = [int(i) for i in devices]
        bad = [i for i in idx if not 0 <= i < count]
        if bad or not idx:
            raise ValueError(f"trainer.devices={list(devices)}: {count} GPU(s) visible")
        return [torch.device("cuda", i) for i in idx]
    if devices in (None, "all", "auto", -1, "-1"):
        n = count
    else:
        n = max(1, min(count, int(devices)))
    return [torch.device("cuda", i) for i in range(n)]


def n_data_local(n_local_devices: int, local_bs: int) -> int:
    """How many local devices hold rows of a node's batch of ``local_bs``:
    JAX's rule ``max(1, gcd(devices, batch))``; the others idle."""
    return max(1, math.gcd(int(n_local_devices), int(local_bs)))


def split_bounds(B: int, n: int) -> List[tuple]:
    """``n`` contiguous (start, stop) parts of ``B`` rows, the first
    ``B % n`` one row longer (``numpy.array_split``); parts may be empty."""
    q, r = divmod(B, n)
    bounds, start = [], 0
    for i in range(n):
        stop = start + q + (1 if i < r else 0)
        bounds.append((start, stop))
        start = stop
    return bounds


def rank_rows(B: int, local_rank: int, local_world_size: int, batch_size: int,
              n_model: int = 1) -> tuple:
    """(start, stop, weight) of a local rank's rows in a node batch of
    ``B`` rows (``batch_size`` but for a short last batch). The node's
    ranks form ``local_world_size // n_model`` data indices (``mesh_coords``);
    ``n_data_local`` of them (JAX's ``gcd((n_dev // n_model_axis) //
    pcount, local_bs)``) hold contiguous parts at weight 1, the rank's
    part that of its data index; a data index beyond them, or with an
    empty part, gets the first part at weight 0 (a zero-weight copy: under
    DDP every rank must run every step)."""
    index = mesh_coords(local_rank, n_model)[0]
    n = n_data_local(local_world_size // n_model, batch_size)
    parts = split_bounds(B, n)
    if index < n and parts[index][1] > parts[index][0]:
        return parts[index] + (1,)
    return parts[0] + (0,)


def replica_rows(B: int, n: int) -> Optional[List[slice]]:
    """The rows of each of ``n`` replicas, or None when ``B`` does not
    divide by ``n`` (the caller then runs the whole batch on its first
    replica)."""
    if n < 1 or B % n:
        return None
    return [slice(s, e) for s, e in split_bounds(B, n)]


def row_slice(batch, i: int, n: int):
    """Slice ``i`` of ``n`` equal contiguous slices of the leading axis of a
    tensor, an array or every non-None value of a dict (JAX's
    ``shard_batch`` for one device of the data axis)."""
    if isinstance(batch, dict):
        return {k: None if v is None else row_slice(v, i, n) for k, v in batch.items()}
    B = batch.shape[0]
    if B % n:
        raise ValueError(f"{B} rows do not split into {n} equal slices")
    step = B // n
    return batch[i * step:(i + 1) * step]


def is_trivial(devices: Sequence) -> bool:
    """One device: nothing to split."""
    return len(devices) == 1
