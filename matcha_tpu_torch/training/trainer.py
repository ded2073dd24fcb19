"""Training loop: Adam, global-norm clipping, checkpoints, on one device
or one rank of a data-parallel process group.

The port of ``matcha_tpu/training/trainer.py``:

* ``make_optimizer``: ``torch.optim.Adam`` (or ``AdamW`` with weight
  decay) and, for the config's ``scheduler``, a ``LambdaLR`` with optax's
  ``exponential_decay`` (non-staircase) or ``cosine_decay_schedule``;
* ``clip_by_global_norm_``: optax's formula, ``g / norm * max_norm`` when
  ``norm >= max_norm`` (``torch.nn.utils.clip_grad_norm_`` adds 1e-6 and
  differs), computed on the device with no host sync;
* ``train_step`` / ``eval_step``: the noise of a step (flow time, source
  noise, segment offsets) comes from a generator seeded from
  ``(seed, step)``, as the JAX step folds the step into its key; dropout
  draws from the global generator, seeded the same way;
* ``Trainer``: ``fit``, ``validate``, ``log_every_n_steps``,
  ``max_steps``/``max_epochs``, ``fast_dev_run``, ``limit_*_batches``,
  ``overfit_batches``, ``last`` and top-k checkpoints with the
  ``topk.json`` ledger, and resume from a checkpoint;
* ``MetricLogger``: CSV, tensorboard when it is installed, and the
  wandb / mlflow / neptune / comet / aim backends, each a warning when its
  client is not installed. Metric names are the reference's
  (``loss/train``, ``sub_loss/train_dur_loss``, ..., ``grad_norm/total``);
  after each validation but the first-epoch-only ``original/i``, 2
  samples are synthesised (10 steps, noise seed 42) and their encoder
  output, decoder output and alignment written as images
  (``_log_images``);
* ``profiler="jax"`` (``configs/debug/profiler.yaml``): steps 1-3 of
  epoch 0 traced with ``torch.profiler`` into ``<output_dir>/profile``.

Data parallelism (JAX's ``data`` axis; ``parallel/dist.py``): in a
process group the ``Trainer`` wraps the loss (``BatchLoss``) in
``DistributedDataParallel`` and each rank trains on its rows of the global
batch (``training/data.py``). The step equals JAX's on the global batch:

* ``share_batch`` pads the rank's rows to the global batch's padded T_x /
  T_y (one exchange of integers on the host), so every row sees the shapes
  it has in the whole batch;
* the noise (flow time, source noise, segment offsets; ``share_noise``) is
  drawn at the global batch's shape from the step's generator and each
  rank keeps its rows, so N ranks draw what one process would;
* each loss is a sum over rows divided by a denominator of the whole
  batch (sum(x_lengths) for the duration loss, sum(y_mask) x n_feats for
  the prior and the CFM losses), so each rank's loss is scaled by
  world x its denominator / the global one: DDP's mean of the gradients
  is then the gradient of the global loss, and clip + Adam run on the
  same gradients on every rank. A rank that holds no rows (JAX's idle
  devices under the gcd rule) runs a copy of the first rank's rows at
  weight 0: DDP needs every rank in every all-reduce;
* the logged losses are the global ones; validation means are the same
  on every rank; only rank 0 logs and writes checkpoints, and every rank
  restores from the same file.

Precision, as JAX's ``make_train_step``: params, gradients and Adam
moments are f32. Under ``"bf16"``, ``"bf16-mixed"`` and ``"16-mixed"``
(the same bf16 policy: no fp16, no loss scaling) the forward and backward
run on a copy of every float parameter and buffer rounded to bf16 and of
the batch's ``y`` in bf16 (``batch_losses``), and the three losses are
cast back to f32 before they are summed. In JAX a bf16 weight that meets
an f32 activation is promoted to f32 by the flax layer, and the first
mask product makes the activations f32, so the model computes in f32 on
bf16-rounded weights; the port hands the layers those values as f32
(rounded to bf16 and back, a differentiable pair of casts, so each
gradient is rounded to bf16 on its way to the f32 master, as JAX's is).
Validation stays f32. Every other string (the config's ``"bf16-compute"``
included) trains in f32.
"""

import dataclasses
import itertools
import json
import math
import os
import queue
import sys
import threading
import time
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from matcha_tpu_torch.models.matcha import MatchaTTS, segment_offsets
from matcha_tpu_torch.parallel import dist
from matcha_tpu_torch.utils.checkpoints import load_native_checkpoint, save_native_checkpoint
from matcha_tpu_torch.utils.pylogger import get_pylogger

log = get_pylogger(__name__)

BF16_PRECISIONS = ("bf16", "bf16-mixed", "16-mixed")


def make_schedule(scheduler: Optional[dict] = None) -> Optional[Callable[[int], float]]:
    """The learning-rate factor at an update count, or None for a constant
    rate. {"name": "exponential", "gamma": g, "interval_steps": n} gives
    g ** (step / n); {"name": "cosine", "decay_steps": n} gives
    (1 + cos(pi * min(step, n) / n)) / 2."""
    if not scheduler:
        return None
    name = scheduler.get("name", "exponential")
    if name == "exponential":
        gamma = float(scheduler.get("gamma", 0.999))
        interval = int(scheduler.get("interval_steps", 1000))
        return lambda step: gamma ** (step / interval)
    if name == "cosine":
        decay_steps = int(scheduler.get("decay_steps", 100_000))
        return lambda step: 0.5 * (1.0 + math.cos(math.pi * min(step, decay_steps) / decay_steps))
    raise ValueError(f"Unknown scheduler {name!r}")


def make_optimizer(model: torch.nn.Module, lr: float = 1e-4, weight_decay: float = 0.0,
                   scheduler: Optional[dict] = None):
    """(optimizer, lr_scheduler or None): Adam, AdamW with decay."""
    params = [p for p in model.parameters() if p.requires_grad]
    if weight_decay:
        opt = torch.optim.AdamW(params, lr=lr, weight_decay=weight_decay)
    else:
        opt = torch.optim.Adam(params, lr=lr)
    factor = make_schedule(scheduler)
    return opt, (torch.optim.lr_scheduler.LambdaLR(opt, factor) if factor else None)


def global_norm(tensors) -> torch.Tensor:
    """sqrt of the sum of squares of every element, as optax.global_norm."""
    return torch.linalg.vector_norm(torch.stack(torch._foreach_norm(list(tensors))))


@torch.no_grad()
def clip_by_global_norm_(grads, max_norm: float) -> torch.Tensor:
    """Clip in place with optax's rule: leave ``grads`` as they are when
    their global norm is below ``max_norm``, else ``g / norm * max_norm``.
    Returns the norm before clipping. No host sync."""
    grads = list(grads)
    norm = global_norm(grads)
    if max_norm:
        keep = norm < max_norm
        one = torch.ones_like(norm)
        torch._foreach_div_(grads, torch.where(keep, one, norm))
        torch._foreach_mul_(grads, torch.where(keep, one, torch.full_like(norm, max_norm)))
    return norm


def step_seed(seed: int, step: int) -> int:
    """The seed of a step's noise: a function of the run's seed and the
    step count only, so a resumed run draws what an unbroken one would."""
    return ((seed + 17) * 1_000_003 + step) % (2**63)


def to_device(batch: dict, device) -> dict:
    """Numpy batch -> tensors on ``device`` (ids as int64)."""
    out = {}
    for k, v in batch.items():
        if v is None:
            out[k] = None
            continue
        t = torch.as_tensor(v).to(device, non_blocking=True)
        out[k] = t.long() if k == "x" else t
    return out


def batch_losses(model: MatchaTTS, batch: dict, out_size: Optional[int] = None,
                 generator: Optional[torch.Generator] = None, noise: Optional[dict] = None,
                 precision: str = "f32"):
    """(dur_loss, prior_loss, diff_loss) of a batch of tensors, f32.
    Under a ``BF16_PRECISIONS`` name: on the model's float parameters and
    buffers rounded to bf16 (held as f32, the type flax promotes them to
    where they meet the activations) and ``y`` in bf16, the losses cast
    back to f32 (JAX's ``make_train_step``); gradients reach the f32
    parameters through the casts, rounded to bf16."""
    args = [batch["x"], batch["x_lengths"], batch["y"], batch["y_lengths"], out_size]
    kwargs = dict(durations=batch.get("durations"), spks=batch.get("spks"),
                  generator=generator, **(noise or {}))
    if precision not in BF16_PRECISIONS:
        return model.losses(*args, **kwargs)[:3]
    cast = {name: t.to(torch.bfloat16).to(t.dtype)
            for name, t in itertools.chain(model.named_parameters(), model.named_buffers())
            if t.is_floating_point()}
    args[2] = args[2].to(torch.bfloat16)
    losses = torch.func.functional_call(model, cast, tuple(args), kwargs)[:3]
    return tuple(v.float() for v in losses)


class BatchLoss(torch.nn.Module):
    """``batch_losses`` as a module's ``forward``, the module that
    ``DistributedDataParallel`` wraps: DDP averages the gradients of what
    its module's ``forward`` ran, and a loss computed around it
    (``functional_call`` on bf16-rounded copies included) would leave each
    rank with its own gradients and raise nothing."""

    def __init__(self, model: MatchaTTS, out_size: Optional[int] = None,
                 precision: str = "f32"):
        super().__init__()
        self.model = model
        self.out_size = out_size
        self.precision = precision

    def forward(self, batch: dict, generator: Optional[torch.Generator] = None,
                noise: Optional[dict] = None):
        return batch_losses(self.model, batch, self.out_size, generator, noise, self.precision)


def make_ddp(model: MatchaTTS, device, out_size: Optional[int] = None,
             precision: str = "f32"):
    """``BatchLoss`` in ``DistributedDataParallel`` (the process group must
    be initialised). Every parameter of a ``MatchaTTS`` reaches the loss
    (single- and multi-speaker, transformer and conformer decoders;
    ``tests/test_torch_ddp.py`` checks it), so ``find_unused_parameters``
    is off: a parameter that the loss missed would make DDP raise at the
    next step, not pass unnoticed."""
    from torch.nn.parallel import DistributedDataParallel

    device = torch.device(device)
    return DistributedDataParallel(
        BatchLoss(model, out_size, precision),
        device_ids=[device.index if device.index is not None else torch.cuda.current_device()]
        if device.type == "cuda" else None,
        find_unused_parameters=False)


@dataclasses.dataclass
class Share:
    """A rank's part of the global batch of a data-parallel step."""

    #: the global index of its first row (0 for a zero-weight copy)
    lo: int
    #: rows of the global batch and rows the rank holds
    n_global: int
    n_rows: int
    #: world x its sum(x_lengths) / the global sum (0 at weight 0)
    dur_scale: float
    #: the same for sum(y_mask) after the segment cut
    mel_scale: float
    world: int


def _pad_to(t: torch.Tensor, dim: int, size: int) -> torch.Tensor:
    if t.shape[dim] == size:
        return t
    pad = [0, 0] * (t.dim() - dim - 1) + [0, size - t.shape[dim]]
    return torch.nn.functional.pad(t, pad)


def share_batch(batch: dict, out_size: Optional[int] = None) -> Tuple[dict, Share]:
    """A rank's host batch (with the ``rows`` [start, stop, weight] that
    ``training/data.py`` adds) -> (its tensors zero-padded to the global
    batch's T_x and T_y, its ``Share``). One all-gather of a few integers
    on the host: the shapes, row counts and loss denominators of every
    rank."""
    batch = {k: None if v is None else torch.as_tensor(v) for k, v in batch.items()}
    start, stop, weight = (int(v) for v in batch.pop("rows"))
    xl, yl = batch["x_lengths"].long(), batch["y_lengths"].long()
    y_cut = torch.clamp(yl, max=out_size) if out_size is not None else yl
    mine = [batch["x"].shape[1], batch["y"].shape[1], (stop - start) * weight,
            int(xl.sum()) * weight, int(yl.sum()) * weight, int(y_cut.sum()) * weight]
    every = dist.host_all_gather(mine)
    T_x, T_y = int(every[:, 0].max()), int(every[:, 1].max())
    for k in ("x", "durations"):
        if batch.get(k) is not None:
            batch[k] = _pad_to(batch[k], 1, T_x)
    batch["y"] = _pad_to(batch["y"], 1, T_y)
    col = 5 if out_size is not None and out_size < T_y else 4
    world = every.shape[0]
    share = Share(lo=int(every[:dist.rank(), 2].sum()) if weight else 0,
                  n_global=int(every[:, 2].sum()), n_rows=stop - start,
                  dur_scale=world * mine[3] / int(every[:, 3].sum()),
                  mel_scale=world * mine[col] / int(every[:, col].sum()), world=world)
    return batch, share


def share_noise(share: Share, batch: dict, out_size: Optional[int],
                generator: Optional[torch.Generator], noise: Optional[dict] = None,
                precision: str = "f32") -> dict:
    """The rank's rows of the step's noise. ``noise`` (``t``, ``z``,
    ``offsets`` of the global batch) is sliced; otherwise the segment
    draws, ``t`` and ``z`` are drawn from ``generator`` at the global
    batch's shape, in ``MatchaTTS.losses``'s order and types (``z`` in the
    mel's type: bf16 under a ``BF16_PRECISIONS`` name)."""
    rows = slice(share.lo, share.lo + share.n_rows)
    if noise is not None:
        return {k: v[rows] for k, v in noise.items()}
    y = batch["y"]
    G, T_y, n_feats = share.n_global, y.shape[1], y.shape[2]
    y_dtype = torch.bfloat16 if precision in BF16_PRECISIONS else y.dtype
    out = {}
    if out_size is not None and out_size < T_y:
        u = torch.rand(G, generator=generator, device=y.device)[rows]
        out["offsets"] = segment_offsets(u, batch["y_lengths"], out_size, y_dtype)
        T_y = out_size
    out["t"] = torch.rand(G, generator=generator, device=y.device)[rows]
    out["z"] = torch.randn((G, T_y, n_feats), generator=generator, device=y.device,
                           dtype=y_dtype)[rows]
    return out


def _global_losses(losses, share: Share):
    """A rank's three losses scaled to its part of the global losses."""
    dur, prior, diff = losses
    return dur * share.dur_scale, prior * share.mel_scale, diff * share.mel_scale


def _reduced(scaled, share: Optional[Share]) -> torch.Tensor:
    """(dur, prior, diff) of the global batch from every rank's scaled
    parts, on the device."""
    v = torch.stack([t.detach() for t in scaled])
    return v if share is None else dist.all_reduce_sum(v) / share.world


def train_step(model: MatchaTTS, optimizer, lr_scheduler, batch: dict, step: int, seed: int,
               out_size: Optional[int] = None, gradient_clip_val: float = 5.0,
               noise: Optional[dict] = None,
               on_phase: Optional[Callable[[str], None]] = None,
               precision: str = "f32", ddp=None,
               share: Optional[Share] = None) -> Dict[str, torch.Tensor]:
    """One update on a batch of tensors on the model's device. ``noise``:
    optional ``t``, ``z``, ``offsets`` for ``MatchaTTS.losses``, else
    drawn from the step's generator. ``precision``: a ``BF16_PRECISIONS``
    name runs the forward and backward in bf16 on f32 masters
    (``batch_losses``). ``on_phase(name)`` is called after "forward",
    "backward" and "optimizer" (for timing). Returns the metrics as 0-d
    tensors on the device.

    Data-parallel: ``ddp`` (``make_ddp`` of this model) and the rank's
    ``share`` (``share_batch``); ``batch`` holds the rank's rows and
    ``noise``, when given, is the global batch's. The losses and the
    gradient norm returned are the global batch's, the same on every
    rank."""
    model.train()
    device = batch["y"].device
    gen = torch.Generator(device=device).manual_seed(step_seed(seed, step))
    torch.manual_seed(step_seed(seed + 1, step))  # dropout
    if share is None:
        losses = batch_losses(model, batch, out_size, gen, noise, precision)
    else:
        losses = _global_losses(
            ddp(batch, None, share_noise(share, batch, out_size, gen, noise, precision)), share)
    loss = losses[0] + losses[1] + losses[2]
    if on_phase:
        on_phase("forward")
    optimizer.zero_grad(set_to_none=True)
    loss.backward()
    if on_phase:
        on_phase("backward")
    grads = [p.grad for p in model.parameters() if p.grad is not None]
    grad_norm = clip_by_global_norm_(grads, gradient_clip_val)
    optimizer.step()
    if lr_scheduler is not None:
        lr_scheduler.step()
    if on_phase:
        on_phase("optimizer")
    dur, prior, diff = _reduced(losses, share)
    return {"dur_loss": dur, "prior_loss": prior, "diff_loss": diff,
            "loss": dur + prior + diff if share is not None else loss.detach(),
            "grad_norm": grad_norm}


@torch.no_grad()
def eval_step(model: MatchaTTS, batch: dict, out_size: Optional[int] = None,
              noise: Optional[dict] = None,
              share: Optional[Share] = None) -> Dict[str, torch.Tensor]:
    """The losses of a batch with dropout off, noise from a fixed seed (or
    ``noise``: ``t``, ``z``, ``offsets`` for ``MatchaTTS.losses``), in f32
    whatever the training precision (as JAX's ``make_eval_step``). With a
    ``share``, the global batch's losses (every rank must call it)."""
    model.eval()
    gen = torch.Generator(device=batch["y"].device).manual_seed(0)
    if share is None:
        losses = batch_losses(model, batch, out_size, gen, noise)
    else:
        losses = _global_losses(
            batch_losses(model, batch, out_size, None,
                         share_noise(share, batch, out_size, gen, noise)), share)
    dur, prior, diff = _reduced(losses, share)
    return {"dur_loss": dur, "prior_loss": prior, "diff_loss": diff, "loss": dur + prior + diff}


class MetricLogger:
    """Scalars to CSV (``csv_path``) and to tensorboard (``logdir``) when
    ``torch.utils.tensorboard`` can be imported, and to the external
    backends the config names (wandb, mlflow, neptune, comet, aim; the
    JAX package's ``_make_backend``), each of which degrades to a warning
    when its client library is not installed."""

    def __init__(self, logdir: Optional[str], csv_path: Optional[str] = None,
                 backends: Optional[dict] = None):
        self.writer = None
        self._csv = None
        self._csv_fields = None
        self._csv_path = csv_path
        self._external: list = []  # (name, log_fn(metrics, step), close_fn)
        if logdir:
            try:
                from torch.utils.tensorboard import SummaryWriter

                os.makedirs(logdir, exist_ok=True)
                self.writer = SummaryWriter(logdir)
            except ImportError:
                log.warning("tensorboard not available; metrics not persisted there")
        if csv_path:
            os.makedirs(os.path.dirname(csv_path) or ".", exist_ok=True)
            self._csv = open(csv_path, "a", encoding="utf-8", buffering=1)
        for name, cfg in (backends or {}).items():
            try:
                self._external.append(self._make_backend(name, dict(cfg or {})))
            except ImportError:
                log.warning(f"logger backend {name!r} requested but its client "
                            f"library is not installed; skipping")
            except Exception as e:  # a backend's own failure must not stop training
                log.warning(f"logger backend {name!r} failed to initialize: {e}")

    @staticmethod
    def _make_backend(name: str, cfg: dict):
        """One external backend -> (name, log_fn(metrics, step), close_fn),
        configured as ``configs/logger/<name>.yaml`` says."""
        if name == "wandb":
            import wandb

            run = wandb.init(project=cfg.get("project", "matcha-tpu"),
                             name=cfg.get("name"), group=cfg.get("group") or None,
                             tags=cfg.get("tags") or None, reinit=True)
            return (name, lambda m, s: run.log(m, step=s), run.finish)
        if name == "mlflow":
            import mlflow

            if cfg.get("tracking_uri"):
                mlflow.set_tracking_uri(cfg["tracking_uri"])
            mlflow.start_run(run_name=cfg.get("run_name"))
            return (name, lambda m, s: mlflow.log_metrics(
                {k.replace("/", "_"): v for k, v in m.items()}, step=s), mlflow.end_run)
        if name == "neptune":
            import neptune

            run = neptune.init_run(project=cfg.get("project"))
            return (name, lambda m, s: [run[k].append(v, step=s) for k, v in m.items()],
                    run.stop)
        if name == "comet":
            import comet_ml

            exp = comet_ml.Experiment(project_name=cfg.get("project_name", "matcha-tpu"))
            return (name, lambda m, s: exp.log_metrics(m, step=s), exp.end)
        if name == "aim":
            import aim

            run = aim.Run(experiment=cfg.get("experiment", "matcha-tpu"))
            return (name, lambda m, s: [run.track(v, name=k, step=s) for k, v in m.items()],
                    run.close)
        raise ImportError(f"unknown logger backend {name!r}")

    def scalars(self, metrics: Dict[str, float], step: int) -> None:
        if self.writer:
            for k, v in metrics.items():
                self.writer.add_scalar(k, float(v), step)
        for _, log_fn, _ in self._external:
            log_fn({k: float(v) for k, v in metrics.items()}, step)
        if self._csv:
            new_fields = [k for k in sorted(metrics)
                          if self._csv_fields is None or k not in self._csv_fields]
            if self._csv_fields is None:
                self._csv_fields = ["step"] + new_fields
                self._csv.write(",".join(self._csv_fields) + "\n")
            elif new_fields:
                # the key set grew (the first validation adds its columns):
                # rewrite the file under the widened header
                self._csv_fields += new_fields
                self._csv.close()
                with open(self._csv_path, encoding="utf-8") as f:
                    lines = f.read().splitlines()
                pad = "," * len(new_fields)
                self._csv = open(self._csv_path, "w", encoding="utf-8", buffering=1)
                self._csv.write(",".join(self._csv_fields) + "\n")
                for line in lines[1:]:
                    self._csv.write(line + pad + "\n")
            row = {"step": step, **{k: float(v) for k, v in metrics.items()}}
            self._csv.write(",".join(str(row.get(f, "")) for f in self._csv_fields) + "\n")

    def image(self, tag: str, img: np.ndarray, step: int) -> None:
        """An (H, W, 3) image to tensorboard."""
        if self.writer:
            self.writer.add_image(tag, img, step, dataformats="HWC")

    def hparams(self, hparams: dict) -> None:
        if self.writer:
            text = "\n".join(f"{k}: {v}" for k, v in hparams.items())
            self.writer.add_text("hparams", "```\n" + text + "\n```", 0)

    def close(self) -> None:
        if self.writer:
            self.writer.close()
        if self._csv:
            self._csv.close()
        for name, _, close_fn in self._external:
            try:
                close_fn()
            except Exception:
                log.warning(f"logger backend {name!r} failed to close")


def summarize_params(model: torch.nn.Module, max_depth: int = 3) -> str:
    """Parameter counts grouped by module path up to ``max_depth``."""
    counts: Dict[str, int] = {}
    for name, p in model.named_parameters():
        key = ".".join(name.split(".")[:max_depth])
        counts[key] = counts.get(key, 0) + p.numel()
    width = max([len(k) for k in counts] + [6])
    lines = [f"{'module':<{width}}  params"]
    lines += [f"{k:<{width}}  {v:,}" for k, v in sorted(counts.items())]
    lines.append(f"{'TOTAL':<{width}}  {sum(counts.values()):,}")
    return "\n".join(lines)


def prefetch_iterator(iterator, depth: int = 2, pin: bool = False):
    """Batches from ``iterator`` made ahead in a background thread (numpy
    -> torch, pinned when ``pin``), so the host prepares the next batch
    while the card runs this one."""
    q: "queue.Queue" = queue.Queue(maxsize=depth)
    end = object()
    failure = []

    def convert(batch):
        out = {}
        for k, v in batch.items():
            t = None if v is None else torch.from_numpy(np.ascontiguousarray(v))
            out[k] = t.pin_memory() if pin and t is not None else t
        return out

    def producer():
        try:
            for item in iterator:
                q.put(convert(item))
        except BaseException as e:  # handed to the consumer, which re-raises it
            failure.append(e)
        finally:
            q.put(end)

    threading.Thread(target=producer, daemon=True).start()
    while True:
        item = q.get()
        if item is end:
            if failure:
                raise failure[0]
            return
        yield item


class Trainer:
    """Epoch-driven training (the Lightning Trainer analog) on ``device``,
    one rank of a data-parallel job when a process group is initialised
    (``parallel/dist.py``): then the loss runs in ``make_ddp``'s wrapper,
    each batch goes through ``share_batch``, and only rank 0 logs and
    writes."""

    def __init__(
        self,
        model: MatchaTTS,
        datamodule,
        device,
        out_size: Optional[int] = None,
        lr: float = 1e-4,
        weight_decay: float = 0.0,
        gradient_clip_val: float = 5.0,
        max_epochs: int = -1,
        max_steps: int = -1,
        check_val_every_n_epoch: int = 1,
        log_every_n_steps: int = 10,
        output_dir: str = "logs/train/runs/default",
        seed: int = 1234,
        fast_dev_run: bool = False,
        overfit_batches: int = 0,
        limit_train_batches: Optional[float] = None,
        limit_val_batches: Optional[float] = None,
        detect_anomaly: bool = False,
        save_every_n_epochs: int = 100,
        save_top_k: int = 10,
        monitor: str = "epoch",
        monitor_mode: str = "max",
        enable_checkpointing: bool = True,
        save_last: bool = True,
        model_summary_depth: int = 0,
        enable_progress_bar: bool = False,
        precision: str = "f32",
        hparams: Optional[dict] = None,
        scheduler: Optional[dict] = None,
        loggers: Optional[dict] = None,
        profiler: Optional[str] = None,
    ):
        self.precision = precision
        if profiler not in (None, "", "jax"):
            log.warning(f"trainer.profiler={profiler!r} is not known (only 'jax': a "
                        "torch.profiler trace of steps 1-3); no trace is taken")
        self.profiler = profiler
        self.device = torch.device(device)
        self.model = model.to(self.device)
        self.dm = datamodule
        self.out_size = out_size
        self.gradient_clip_val = gradient_clip_val
        self.max_epochs = max_epochs
        self.max_steps = max_steps
        self.check_val_every_n_epoch = check_val_every_n_epoch
        self.log_every_n_steps = log_every_n_steps
        self.output_dir = output_dir
        self.seed = seed
        self.fast_dev_run = fast_dev_run
        self.overfit_batches = overfit_batches
        self.limit_train_batches = limit_train_batches
        self.limit_val_batches = limit_val_batches
        self.detect_anomaly = detect_anomaly
        self.save_every_n_epochs = save_every_n_epochs
        self.save_top_k = save_top_k
        # top-k keeps the best `monitor` values: `epoch` max keeps the most
        # recent k, `loss/val` min the best-validating k
        self.monitor = monitor
        self.monitor_mode = monitor_mode
        self.enable_checkpointing = enable_checkpointing
        self.save_last = save_last
        self.model_summary_depth = model_summary_depth
        self.enable_progress_bar = enable_progress_bar
        self.hparams = hparams or {}
        self.ddp = (make_ddp(self.model, self.device, out_size, precision)
                    if dist.is_initialized() else None)
        self.optimizer, self.lr_scheduler = make_optimizer(model, lr, weight_decay, scheduler)
        self.step = 0
        self._start_epoch = 0
        self._last_val: Dict[str, float] = {}
        self._last_val_epoch = -1
        loggers = loggers if loggers is not None else {"tensorboard": {}}
        if dist.rank() != 0:
            loggers = {}
        tb_dir = os.path.join(output_dir, "tensorboard") if "tensorboard" in loggers else None
        csv_path = os.path.join(output_dir, "csv", "metrics.csv") if "csv" in loggers else None
        self.logger = MetricLogger(tb_dir, csv_path, backends={
            k: v for k, v in loggers.items() if k not in ("tensorboard", "csv")})
        # the top-k ledger survives restarts in checkpoints/topk.json, so a
        # resumed run keeps pruning the checkpoints of the earlier one
        self._ckpt_epochs: list = []
        self._ckpt_seq = 0
        self._load_topk_ledger()

    # ------------------------------------------------------------------
    def _topk_ledger_path(self) -> str:
        return os.path.join(self.output_dir, "checkpoints", "topk.json")

    def _load_topk_ledger(self) -> None:
        try:
            with open(self._topk_ledger_path()) as f:
                entries = json.load(f)
        except (OSError, ValueError):
            return
        ckpt_dir = os.path.join(self.output_dir, "checkpoints")
        for score, seq, name in entries:
            path = os.path.join(ckpt_dir, name)
            if os.path.exists(path):  # checkpoints deleted by hand drop out
                self._ckpt_epochs.append((float(score), int(seq), path))
                self._ckpt_seq = max(self._ckpt_seq, int(seq) + 1)

    def _save_topk_ledger(self) -> None:
        if dist.rank() != 0:
            return
        entries = [(s, q, os.path.basename(p)) for s, q, p in self._ckpt_epochs]
        tmp = self._topk_ledger_path() + ".tmp"
        with open(tmp, "w") as f:
            json.dump(entries, f)
        os.replace(tmp, self._topk_ledger_path())

    def restore(self, path: str) -> None:
        """Continue from a native checkpoint: weights, Adam moments, the
        schedule's position, the step and the completed epochs."""
        payload = load_native_checkpoint(path, map_location=self.device)
        self.model.load_state_dict(payload["model"])
        if "optimizer" in payload:
            self.optimizer.load_state_dict(payload["optimizer"])
        else:
            log.warning("Checkpoint has no optimizer state; re-initialising Adam moments")
        if self.lr_scheduler is not None and "scheduler" in payload:
            self.lr_scheduler.load_state_dict(payload["scheduler"])
        self.step = int(payload["step"])
        self._start_epoch = int(payload.get("epoch", 0))
        log.info(f"Restored checkpoint at step {self.step} (epoch {self._start_epoch}) "
                 f"from {path}")

    # ------------------------------------------------------------------
    def fit(self, restore_from: Optional[str] = None) -> Dict[str, float]:
        if restore_from:
            self.restore(restore_from)
        self.dm.setup()
        n_params = sum(p.numel() for p in self.model.parameters())
        log.info(f"Model parameters: {n_params / 1e6:.2f}M | device: {self.device}")
        if self.model_summary_depth > 0:
            log.info("Model summary:\n" + summarize_params(self.model, self.model_summary_depth))
        self.logger.hparams({**self.hparams, "n_params": n_params})
        pin = self.device.type == "cuda"

        last_metrics: Dict[str, float] = {}
        epoch = self._start_epoch
        max_epochs = (epoch + 1 if self.fast_dev_run  # one step, even resumed
                      else (self.max_epochs if self.max_epochs > 0 else 10**9))
        stop = False
        with torch.autograd.set_detect_anomaly(self.detect_anomaly):
            while epoch < max_epochs and not stop:
                t_epoch = time.time()
                if self.overfit_batches:
                    batches = self.dm.train_batches(0)
                    batches = [b for _, b in zip(range(self.overfit_batches), batches)]
                else:
                    batches = self.dm.train_batches(epoch, limit=self.limit_train_batches)
                trace = None
                for i, batch in enumerate(prefetch_iterator(batches, pin=pin)):
                    if self.profiler == "jax" and i == 1 and epoch == 0 and dist.rank() == 0:
                        trace = self._start_trace()
                    share = None
                    if self.ddp is not None:
                        batch, share = share_batch(batch, self.out_size)
                    metrics = train_step(self.model, self.optimizer, self.lr_scheduler,
                                         to_device(batch, self.device), self.step, self.seed,
                                         self.out_size, self.gradient_clip_val,
                                         precision=self.precision, ddp=self.ddp, share=share)
                    self.step += 1
                    if trace is not None and i == 3:
                        self._stop_trace(trace)
                        trace = None
                    if self.step % self.log_every_n_steps == 0 or self.fast_dev_run:
                        host = {k: float(v) for k, v in metrics.items()}
                        last_metrics = host
                        self.logger.scalars({
                            "step": self.step,
                            "loss/train": host["loss"],
                            "sub_loss/train_dur_loss": host["dur_loss"],
                            "sub_loss/train_prior_loss": host["prior_loss"],
                            "sub_loss/train_diff_loss": host["diff_loss"],
                            "grad_norm/total": host["grad_norm"],
                        }, self.step)
                        log.info(f"epoch {epoch} step {self.step}: loss={host['loss']:.4f} "
                                 f"(dur {host['dur_loss']:.4f} prior {host['prior_loss']:.4f} "
                                 f"diff {host['diff_loss']:.4f}) "
                                 f"grad_norm={host['grad_norm']:.3f}")
                    if self.enable_progress_bar and dist.rank() == 0 and sys.stdout.isatty():
                        print(f"\repoch {epoch} | step {self.step}", end="", flush=True)
                    if self.fast_dev_run or (self.max_steps > 0 and self.step >= self.max_steps):
                        stop = True
                        break
                if trace is not None:  # the epoch ended inside the traced steps
                    self._stop_trace(trace)

                if (epoch + 1) % self.check_val_every_n_epoch == 0 or self.fast_dev_run:
                    val = self.validate(epoch)
                    self._last_val = val
                    self._last_val_epoch = epoch + 1
                    last_metrics.update({f"val_{k}": v for k, v in val.items()})
                self._maybe_checkpoint(epochs_done=epoch + 1)
                log.info(f"epoch {epoch} done in {time.time() - t_epoch:.1f}s")
                epoch += 1

        self.logger.close()
        return {"loss/train": last_metrics.get("loss", float("nan")),
                "loss/val": last_metrics.get("val_loss", float("nan"))}

    def _start_trace(self):
        from torch.profiler import ProfilerActivity, profile

        activities = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            activities.append(ProfilerActivity.CUDA)
        trace = profile(activities=activities)
        trace.__enter__()
        return trace

    def _stop_trace(self, trace) -> str:
        """End a ``torch.profiler`` trace and write it as a Chrome trace
        under ``<output_dir>/profile``; returns its path."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        trace.__exit__(None, None, None)
        out_dir = os.path.join(self.output_dir, "profile")
        os.makedirs(out_dir, exist_ok=True)
        path = os.path.join(out_dir, f"trace_to_step_{self.step}.json")
        trace.export_chrome_trace(path)
        log.info(f"profiler trace written to {path}")
        return path

    # ------------------------------------------------------------------
    def validate(self, epoch: int) -> Dict[str, float]:
        sums: Dict[str, torch.Tensor] = {}
        count = 0
        first_batch = None
        for batch in self.dm.val_batches(limit=self.limit_val_batches):
            share = None
            if self.ddp is not None:
                batch, share = share_batch(batch, self.out_size)
            if first_batch is None:
                first_batch = batch
            m = eval_step(self.model, to_device(batch, self.device), self.out_size, share=share)
            for k, v in m.items():
                sums[k] = sums.get(k, 0.0) + v
            count += 1
            if self.fast_dev_run:
                break
        if count == 0:
            return {}
        means = {k: float(v) / count for k, v in sums.items()}
        self.logger.scalars({
            "loss/val": means["loss"],
            "sub_loss/val_dur_loss": means["dur_loss"],
            "sub_loss/val_prior_loss": means["prior_loss"],
            "sub_loss/val_diff_loss": means["diff_loss"],
        }, self.step)
        log.info(f"epoch {epoch} validation: loss={means['loss']:.4f}")
        if first_batch is not None and not self.fast_dev_run:
            self._log_images(first_batch, epoch)
        return means

    @torch.no_grad()
    def _log_images(self, batch: dict, epoch: int) -> None:
        """2 samples of the validation batch synthesised (10 steps, noise
        from seed 42) -> images of the encoder output, the decoder output
        and the alignment; in epoch 0 the ground truth too."""
        if self.logger.writer is None:
            return
        from matcha_tpu_torch.utils.utils import plot_tensor

        n = min(2, batch["x"].shape[0])
        if epoch == 0:
            for i in range(n):
                self.logger.image(f"original/{i}", plot_tensor(batch["y"][i].T), epoch)
        self.model.eval()
        spks = batch.get("spks")
        out = self.model.synthesise(
            torch.as_tensor(batch["x"][:n]).long().to(self.device),
            torch.as_tensor(batch["x_lengths"][:n]).to(self.device), n_timesteps=10,
            y_max_length=batch["y"].shape[1],
            generator=torch.Generator(self.device).manual_seed(42),
            spks=None if spks is None else torch.as_tensor(spks[:n]).to(self.device))
        for i in range(n):
            for key, tag in (("encoder_outputs", "generated_enc"),
                             ("decoder_outputs", "generated_dec"), ("attn", "alignment")):
                self.logger.image(f"{tag}/{i}", plot_tensor(out[key][i].float().cpu().numpy()),
                                  epoch)

    # ------------------------------------------------------------------
    def _monitor_score(self, epoch: int) -> float:
        """Top-k rank of a checkpoint (larger is better). A validation
        metric ranks only when it was computed this epoch; otherwise the
        epoch's recency does, below every fresh score."""
        if self.monitor == "epoch":
            val = float(epoch)
        else:
            key = self.monitor.replace("loss/val", "loss").replace("val_", "")
            val = self._last_val.get(key, float("nan"))
            if self._last_val_epoch != epoch or val != val:
                return -1e30 + float(epoch)
        if self.monitor_mode == "min":
            val = -val
        return val if val == val else float("-inf")

    def _maybe_checkpoint(self, epochs_done: int) -> None:
        if not self.enable_checkpointing:
            return
        if self.save_last:
            self._save(epochs_done, tag="last")
        if self.save_every_n_epochs and epochs_done % self.save_every_n_epochs == 0:
            path = self._save(epochs_done)
            # a re-run over the same output_dir re-saves a listed step:
            # replace its entry rather than list the path twice
            self._ckpt_epochs = [e for e in self._ckpt_epochs if e[2] != path]
            self._ckpt_epochs.append((self._monitor_score(epochs_done), self._ckpt_seq, path))
            self._ckpt_seq += 1
            if len(self._ckpt_epochs) > self.save_top_k:
                self._ckpt_epochs.sort()
                _, _, old = self._ckpt_epochs.pop(0)  # the worst score
                for stale in (old, old + ".hparams.json") if dist.rank() == 0 else ():
                    try:
                        os.remove(stale)
                    except OSError:
                        pass
            self._save_topk_ledger()

    def _save(self, epochs_done: int, tag: Optional[str] = None) -> str:
        """The full training state, so a resume continues bit for bit
        (written by rank 0; every rank returns once it is on disk)."""
        return save_native_checkpoint(
            os.path.join(self.output_dir, "checkpoints"), self.model,
            {**self.hparams, "epoch": epochs_done}, step=self.step,
            optimizer=self.optimizer, scheduler=self.lr_scheduler, epoch=epochs_done,
            name="last" if tag == "last" else None)
