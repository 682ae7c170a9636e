"""Which data-parallel process group (if any) the current step runs under
(port of `infomax3d_tpu/parallel/context.py`'s `cross_replica_axis`).

Modules that aggregate across data shards (masked BatchNorm statistics,
the masked supervised loss) and the step's gradient mean read this while
the step runs, instead of threading a group argument through every model
signature.  The trainer sets it around each train and eval step.  The
edge- and node-partition axes of the JAX package belong to ROADMAP queue 1,
item 9b, and are not here.
"""
from __future__ import annotations

import contextlib
from contextvars import ContextVar
from typing import Optional

import torch.distributed as dist

_GROUP: ContextVar[Optional[dist.ProcessGroup]] = ContextVar(
    "data_parallel_group", default=None)


def data_parallel_group() -> Optional[dist.ProcessGroup]:
    """The data-parallel group of the running step, or None."""
    return _GROUP.get()


@contextlib.contextmanager
def using_data_parallel_group(group: Optional[dist.ProcessGroup]):
    token = _GROUP.set(group)
    try:
        yield
    finally:
        _GROUP.reset(token)
