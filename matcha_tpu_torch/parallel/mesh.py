"""The data axis: which devices a run uses and how a batch splits over
them. The port of the ``data`` half of ``matcha_tpu/parallel/mesh.py``.

JAX shards the leading axis of a batch over the ``data`` axis of one
mesh; the port gives each device a contiguous slice of rows: a rank of a
``DistributedDataParallel`` job in training, a replica of the models in
serving (``cli.TTSPipeline(devices=)``). The ``model`` axis (tensor
parallelism, JAX's ``_TP_RULES``) is not ported.
"""

import math
from typing import List, Optional, Sequence, Union

import torch

Devices = Union[None, str, int, Sequence[int]]


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


def rank_rows(B: int, local_rank: int, local_world_size: int, batch_size: int) -> tuple:
    """(start, stop, weight) of a local rank's rows in a node batch of
    ``B`` rows (``batch_size`` but for a short last batch): part
    ``local_rank`` of ``n_data_local(local_world_size, batch_size)``
    contiguous parts at weight 1; a rank beyond them, or with an empty
    part, gets the first part at weight 0 (a zero-weight copy: under DDP
    every rank must run every step)."""
    n = n_data_local(local_world_size, batch_size)
    parts = split_bounds(B, n)
    if local_rank < n and parts[local_rank][1] > parts[local_rank][0]:
        return parts[local_rank] + (1,)
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
