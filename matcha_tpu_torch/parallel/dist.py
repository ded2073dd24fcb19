"""Process-group bootstrap and rank helpers: the port of
``matcha_tpu/parallel/dist.py``.

JAX scales over processes with ``jax.distributed.initialize()``; the port
runs one process per GPU in a ``torch.distributed`` process group (NCCL on
CUDA, gloo on the CPU) and its trainer wraps the loss in
``DistributedDataParallel``.

Environment contract (JAX's names):

* ``MATCHA_COORDINATOR_ADDRESS`` (``host:port``), ``MATCHA_NUM_PROCESSES``
  and ``MATCHA_PROCESS_ID``: a ``tcp://`` store at that address, that
  world size and rank. Each such process counts as its own node (JAX's
  multi-process semantics, one device each).
* ``MATCHA_DIST=1``, or a ``torchrun`` launch: torchrun's env (``RANK``,
  ``WORLD_SIZE``, ``LOCAL_RANK``, ``LOCAL_WORLD_SIZE``, ``GROUP_RANK``,
  ``MASTER_ADDR``/``MASTER_PORT``) through ``env://``.

Without either nothing is initialised, and every helper here answers as a
single process: rank 0 of 1, barriers and reductions do nothing.

A node is what a JAX process is: it reads its shard of the filelist and
its ranks (its local GPUs) split each of its batches. ``host_all_gather``
runs on a gloo group on the host, also when the main backend is NCCL, so
exchanging a few integers never waits for the card.
"""

import datetime
import os
from typing import Optional, Sequence

import torch
import torch.distributed as tdist

from matcha_tpu_torch.utils.pylogger import get_pylogger

log = get_pylogger(__name__)

#: rank, world size, local rank, local world size, node rank, node count
_topology: Optional[dict] = None
#: a gloo group over every rank for host-side exchanges (the default
#: group itself when that is gloo)
_host_group = None


def is_initialized() -> bool:
    return _topology is not None


def initialize(backend: str, init_method: str, rank: int, world_size: int,
               local_rank: int = 0, local_world_size: int = 1,
               timeout_s: float = 600.0) -> None:
    """Join a process group. ``backend`` "nccl" (each process must have
    selected its GPU with ``torch.cuda.set_device`` first) or "gloo"; no
    fallback from one to the other. The ranks of a node are consecutive:
    ``node_rank = rank // local_world_size``."""
    global _topology, _host_group
    if _topology is not None:
        raise RuntimeError("a process group is already initialised")
    if world_size % local_world_size:
        raise ValueError(f"world size {world_size} is not a multiple of the "
                         f"{local_world_size} ranks of a node")
    timeout = datetime.timedelta(seconds=timeout_s)
    tdist.init_process_group(backend, init_method=init_method, rank=rank,
                             world_size=world_size, timeout=timeout)
    _host_group = (tdist.new_group(backend="gloo", timeout=timeout) if backend != "gloo"
                   else tdist.group.WORLD)
    _topology = {"rank": rank, "world_size": world_size, "local_rank": local_rank,
                 "local_world_size": local_world_size, "node_rank": rank // local_world_size,
                 "n_nodes": world_size // local_world_size}
    log.info(f"torch.distributed ({backend}) initialised: rank {rank}/{world_size}, "
             f"local rank {local_rank}/{local_world_size}")


def maybe_initialize_distributed(coordinator_address: Optional[str] = None,
                                 num_processes: Optional[int] = None,
                                 process_id: Optional[int] = None,
                                 backend: Optional[str] = None,
                                 device: Optional[torch.device] = None) -> bool:
    """Join the process group the environment describes, if it describes
    one (the contract above); arguments override the ``MATCHA_*``
    variables. ``backend``: None = NCCL when CUDA is available, else gloo.
    With NCCL the process selects ``device`` (default ``cuda:<LOCAL_RANK>``,
    ``cuda:0`` under the ``MATCHA_*`` contract). Returns True when more
    than one process takes part. Safe to call again."""
    if _topology is not None:
        return world_size() > 1
    coordinator_address = coordinator_address or os.environ.get("MATCHA_COORDINATOR_ADDRESS")
    env_np = os.environ.get("MATCHA_NUM_PROCESSES")
    env_pid = os.environ.get("MATCHA_PROCESS_ID")
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    if coordinator_address:
        world = num_processes if num_processes is not None else int(env_np or 1)
        rank_ = process_id if process_id is not None else int(env_pid or 0)
        if backend == "nccl":
            torch.cuda.set_device(device if device is not None else 0)
        initialize(backend, f"tcp://{coordinator_address}", rank_, world, 0, 1)
        return world > 1
    if os.environ.get("MATCHA_DIST") == "1" or "TORCHELASTIC_RUN_ID" in os.environ:
        env = os.environ
        world = int(env["WORLD_SIZE"])
        local = int(env.get("LOCAL_RANK", 0))
        if backend == "nccl":
            torch.cuda.set_device(device if device is not None else local)
        initialize(backend, "env://", int(env["RANK"]), world, local,
                   int(env.get("LOCAL_WORLD_SIZE", world)))
        return world > 1
    return False


def rank() -> int:
    return _topology["rank"] if _topology else 0


def world_size() -> int:
    return _topology["world_size"] if _topology else 1


def local_rank() -> int:
    return _topology["local_rank"] if _topology else 0


def local_world_size() -> int:
    return _topology["local_world_size"] if _topology else 1


def node_rank() -> int:
    return _topology["node_rank"] if _topology else 0


def n_nodes() -> int:
    return _topology["n_nodes"] if _topology else 1


def barrier() -> None:
    """Every rank waits for the others (on the host group)."""
    if _topology:
        tdist.barrier(group=_host_group)


def all_reduce_sum(t: torch.Tensor) -> torch.Tensor:
    """``t`` summed over the ranks, in place (on the main backend: a CUDA
    tensor under NCCL stays on the card); ``t`` itself without a group."""
    if _topology:
        tdist.all_reduce(t, op=tdist.ReduceOp.SUM)
    return t


def host_all_gather(values: Sequence[int]) -> torch.Tensor:
    """Every rank's ``values`` (int64, the same count on each) as a
    (world_size, n) CPU tensor, exchanged on the host group."""
    mine = torch.tensor(list(values), dtype=torch.int64)
    if not _topology:
        return mine[None]
    out = [torch.empty_like(mine) for _ in range(world_size())]
    tdist.all_gather(out, mine, group=_host_group)
    return torch.stack(out)


def destroy() -> None:
    """Leave the process group (a no-op without one)."""
    global _topology, _host_group
    if _topology:
        tdist.destroy_process_group()
    _topology, _host_group = None, None


def _launched(index: int, fn, args, nprocs: int, backend: str, init_file: str,
              threads: Optional[int], cuda_devices: Optional[Sequence[int]]) -> None:
    """One worker of ``launch_local``: torchrun's env, the group, ``fn``."""
    os.environ.update(RANK=str(index), WORLD_SIZE=str(nprocs), LOCAL_RANK=str(index),
                      LOCAL_WORLD_SIZE=str(nprocs), GROUP_RANK="0")
    if threads:
        torch.set_num_threads(threads)
    if backend == "nccl":
        torch.cuda.set_device(cuda_devices[index] if cuda_devices else index)
    initialize(backend, f"file://{init_file}", index, nprocs, index, nprocs)
    try:
        fn(index, *args)
    finally:
        destroy()


def launch_local(fn, args: tuple, nprocs: int, backend: str, store_dir: str,
                 timeout_s: Optional[float] = 600.0, threads: Optional[int] = None,
                 cuda_devices: Optional[Sequence[int]] = None) -> None:
    """Run ``fn(local_rank, *args)`` in ``nprocs`` spawned processes that
    form one node's process group (a file store in ``store_dir``: no
    port is opened). Under NCCL process i selects ``cuda_devices[i]``
    (default ``cuda:i``). Raises when a worker fails, or after
    ``timeout_s`` (None: no limit; the workers are then ended). ``threads``: torch's CPU threads per worker. ``fn`` must be importable
    (a module-level function of a module that the workers can import)."""
    import tempfile

    import torch.multiprocessing as mp

    os.makedirs(store_dir, exist_ok=True)
    fd, init_file = tempfile.mkstemp(prefix="store-", dir=store_dir)
    os.close(fd)
    os.remove(init_file)  # the file store creates it
    ctx = mp.start_processes(
        _launched, args=(fn, args, nprocs, backend, init_file, threads, cuda_devices),
        nprocs=nprocs, join=False, start_method="spawn")
    deadline = (None if timeout_s is None
                else datetime.datetime.now() + datetime.timedelta(seconds=timeout_s))
    try:
        while not ctx.join(timeout=1.0):
            if deadline is not None and datetime.datetime.now() > deadline:
                raise TimeoutError(f"{nprocs} workers still running after {timeout_s:.0f} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.terminate()
        for p in ctx.processes:
            p.join(5.0)
