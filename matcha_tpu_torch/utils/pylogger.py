"""Rank-zero logging.

The port of ``matcha_tpu/utils/pylogger.py``: in a multi-process
``torch.distributed`` job only rank 0 emits log records, so the
processes' logs do not interleave. Without an initialised process group
every record is emitted.
"""

import logging
from typing import Any


def process_rank() -> int:
    """The ``torch.distributed`` rank when a process group is initialised,
    else 0 (JAX's ``jax.process_index()``)."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_rank()
    return 0


class _RankZeroLogger(logging.LoggerAdapter):
    """Wraps a logger so every level fires on rank 0 only."""

    def log(self, level: int, msg: Any, *args: Any, **kwargs: Any) -> None:
        if self.isEnabledFor(level) and process_rank() == 0:
            kwargs.pop("rank", None)
            self.logger.log(level, msg, *args, **kwargs)


def get_pylogger(name: str = __name__) -> _RankZeroLogger:
    """A command-line logger that logs on rank 0 only."""
    return _RankZeroLogger(logging.getLogger(name), {})
