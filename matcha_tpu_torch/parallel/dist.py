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

The mesh (JAX's ``make_mesh(n_data, n_model)``): ``set_model_axis(n)``
splits the ranks into groups of ``n`` consecutive ranks, the model groups
that hold one model between them (tensor parallelism,
``parallel/tensor.py``), and the data groups of the ranks with the same
index in their model group, over which the gradients are averaged. Rank
``r`` is at data index ``r // n`` and model index ``r % n``: JAX's
``reshape(n_data, n_model)`` of the device list. Without a model axis
(``n = 1``) the data group is the whole world.
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
#: the model axis: its size, this rank's model group and data group (None:
#: no group of its own, the whole world for the data group)
_axis = {"n_model": 1, "model_group": None, "data_group": None}


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


def set_model_axis(n_model: int) -> None:
    """Split the ranks into model groups of ``n_model`` consecutive ranks
    and data groups across them (every rank must call it, with the same
    ``n_model``). ``n_model`` must divide the ranks of a node, so that a
    model group never spans nodes. Without a process group only 1 is
    accepted."""
    n_model = int(n_model)
    if n_model < 1:
        raise ValueError(f"n_model={n_model}")
    if _topology is None:
        if n_model != 1:
            raise ValueError(f"a model axis of {n_model} needs a process group of at least "
                             f"{n_model} ranks; none is initialised")
        return
    if local_world_size() % n_model:
        raise ValueError(f"a model axis of {n_model} does not divide the "
                         f"{local_world_size()} ranks of a node")
    if n_model == _axis["n_model"]:
        return
    model_g = data_g = None
    if n_model > 1:
        world = world_size()
        for d in range(world // n_model):  # every rank creates every group
            ranks = list(range(d * n_model, (d + 1) * n_model))
            g = tdist.new_group(ranks)
            model_g = g if rank() in ranks else model_g
        for m in range(n_model):
            ranks = list(range(m, world, n_model))
            g = tdist.new_group(ranks)
            data_g = g if rank() in ranks else data_g
    _axis.update(n_model=n_model, model_group=model_g, data_group=data_g)


def n_model() -> int:
    """Ranks in a model group (1 without a model axis)."""
    return _axis["n_model"]


def model_rank() -> int:
    """This rank's index in its model group."""
    return rank() % n_model()


def model_group():
    """This rank's model group, or None without a model axis."""
    return _axis["model_group"]


def n_data() -> int:
    """Ranks in a data group: the data axis's size."""
    return world_size() // n_model()


def data_rank() -> int:
    """This rank's index on the data axis."""
    return rank() // n_model()


def data_group():
    """This rank's data group; None when it is the whole world."""
    return _axis["data_group"]


def barrier() -> None:
    """Every rank waits for the others (on the host group)."""
    if _topology:
        tdist.barrier(group=_host_group)


def all_reduce_sum(t: torch.Tensor) -> torch.Tensor:
    """``t`` summed over this rank's data group (every rank without a
    model axis), in place (on the main backend: a CUDA tensor under NCCL
    stays on the card); ``t`` itself when the data axis has one rank."""
    if n_data() > 1:
        tdist.all_reduce(t, op=tdist.ReduceOp.SUM, group=data_group())
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
    _axis.update(n_model=1, model_group=None, data_group=None)


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
