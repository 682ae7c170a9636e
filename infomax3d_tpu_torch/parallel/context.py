"""Which process groups (if any) the current step runs under (port of
`infomax3d_tpu/parallel/context.py`: `cross_replica_axis`,
`edge_partition_axis`, `node_partition_axis`; the ``model`` axis of the
JAX package's tensor parallelism, which GSPMD reads from the layouts).

Modules that aggregate across ranks read these while the step runs,
instead of threading a group argument through every model signature; the
trainer sets them around each train and eval step.

* `data_parallel_group()`: the ranks holding the other data shards
  (``n_shards``): masked BatchNorm statistics, the masked supervised loss
  and `CrossDeviceLoss` complete over it.
* `edge_partition_group()`: the ranks holding the other edge shards of the
  same batch (``graph_shards``, `parallel/edge_partition.py`): the
  edge -> node aggregations complete their local partials over it (sums
  by an all-reduce, extrema by a gathered max), as do the BatchNorm
  statistics (node-space rows, replicated over the group, then count k
  times, as in the JAX package).
* `node_partition_group()`: the ranks holding the other node shards of
  the same batch (``node_shards``, `parallel/node_partition.py`): sender
  gathers exchange halo rows over it, the graph readout completes its
  per-shard partials over it, and so do the BatchNorm statistics;
  receiver-side aggregations complete locally (every edge lives with its
  receiver).
* `model_group()`: the ranks holding the other column shards of the same
  parameters (``model_shards``, `parallel/tp.py`): the forward gathers
  the full parameters over it; every rank of it runs the same forward on
  the same batch.
* `step_group()`: the ranks whose gradients are averaged: the data and
  the graph groups together under a partition group (the BatchNorm
  statistics complete over both), else the data-parallel group.  It never
  spans the model group: the model ranks hold different shards, and
  their BatchNorm statistics are already whole.

At most one of the partition and model groups is set.
"""
from __future__ import annotations

import contextlib
from contextvars import ContextVar
from typing import Optional

import torch.distributed as dist

_GROUP: ContextVar[Optional[dist.ProcessGroup]] = ContextVar(
    "data_parallel_group", default=None)
_EDGE: ContextVar[Optional[dist.ProcessGroup]] = ContextVar(
    "edge_partition_group", default=None)
_NODE: ContextVar[Optional[dist.ProcessGroup]] = ContextVar(
    "node_partition_group", default=None)
_STEP: ContextVar[Optional[dist.ProcessGroup]] = ContextVar(
    "step_group", default=None)
_MODEL: ContextVar[Optional[dist.ProcessGroup]] = ContextVar(
    "model_group", default=None)


def data_parallel_group() -> Optional[dist.ProcessGroup]:
    """The data-parallel group of the running step, or None."""
    return _GROUP.get()


def edge_partition_group() -> Optional[dist.ProcessGroup]:
    """The edge-partition group of the running step, or None."""
    return _EDGE.get()


def node_partition_group() -> Optional[dist.ProcessGroup]:
    """The node-partition group of the running step, or None."""
    return _NODE.get()


def model_group() -> Optional[dist.ProcessGroup]:
    """The tensor-parallel group of the running step, or None."""
    return _MODEL.get()


def step_group() -> Optional[dist.ProcessGroup]:
    """Every rank of the running step: the group spanning the data and
    the partition groups when a partition group is set, else the
    data-parallel group (or None)."""
    return _STEP.get() or _GROUP.get()


@contextlib.contextmanager
def using_groups(data: Optional[dist.ProcessGroup] = None,
                 edge: Optional[dist.ProcessGroup] = None,
                 node: Optional[dist.ProcessGroup] = None,
                 step: Optional[dist.ProcessGroup] = None,
                 model: Optional[dist.ProcessGroup] = None):
    """Set the five groups for the block (None: not set).  `step` spans
    `data` and the partition group (required with a partition group);
    `model` excludes the partition groups and `step` (the JAX CLI refuses
    ``model_shards`` with ``graph_shards`` / ``node_shards``)."""
    if edge is not None and node is not None:
        raise ValueError("edge and node partitioning exclude each other")
    if (edge is not None or node is not None) and step is None:
        raise ValueError("a partition group needs the step's group")
    if model is not None and (edge is not None or node is not None
                              or step is not None):
        raise ValueError("the model group excludes the partition groups")
    tokens = [(_GROUP, _GROUP.set(data)), (_EDGE, _EDGE.set(edge)),
              (_NODE, _NODE.set(node)), (_STEP, _STEP.set(step)),
              (_MODEL, _MODEL.set(model))]
    try:
        yield
    finally:
        for var, token in reversed(tokens):
            var.reset(token)
