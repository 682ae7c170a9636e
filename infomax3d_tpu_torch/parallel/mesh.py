"""The process groups of one host (port of `infomax3d_tpu/parallel/
mesh.py`): the one-axis ``data`` mesh (`make_group`: one process per
shard, each on its own device) and the two-axis grid (`make_grid`) of
the partitioned modes, (data, graph), and of tensor parallelism, (data,
model): `make_tp_mesh`'s ``reshape(n_data, n_model)`` order.

* NCCL (the default): every rank needs a CUDA card of its own, and NCCL
  refuses two ranks on one card, so fewer cards than ranks raises.
* gloo: taken only where the caller names it; ranks on "cpu", or on the
  host's cards in turn (several ranks may then share one card).

Nothing switches backend or device on its own.
"""
from __future__ import annotations

import dataclasses
from datetime import timedelta
from typing import List, Optional, Tuple, Union

import torch
import torch.distributed as dist

BACKENDS = ("nccl", "gloo")


def local_devices() -> List[torch.device]:
    """This host's CUDA cards."""
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def rank_devices(n_ranks: int, backend: str,
                 device: Union[str, torch.device]) -> List[torch.device]:
    """The device of each of a host's `n_ranks` local ranks under
    `backend`, the run's `device` being "cuda" or "cpu"."""
    device = torch.device(device)
    if backend not in BACKENDS:
        raise ValueError(f"backend {backend!r}: the port's data parallelism "
                         f"runs on {' or '.join(BACKENDS)}")
    if device.type not in ("cuda", "cpu"):
        raise ValueError(f"device {device}: 'cuda' or 'cpu'")
    if device.type == "cpu":
        if backend == "nccl":
            raise ValueError("NCCL runs on CUDA cards; name backend 'gloo' "
                             "to run the ranks on the CPU")
        return [torch.device("cpu")] * n_ranks
    cards = local_devices()
    if backend == "nccl" and len(cards) < n_ranks:
        raise RuntimeError(
            f"NCCL needs one CUDA card per rank: {n_ranks} ranks, "
            f"{len(cards)} card(s) (NCCL refuses two ranks on one card; "
            f"name backend 'gloo' to share cards)")
    if not cards:
        raise RuntimeError("no CUDA device available for the ranks")
    return [cards[r % len(cards)] for r in range(n_ranks)]


def make_group(n_shards: int, rank: int, init_method: str,
               backend: str = "nccl",
               device: Union[str, torch.device] = "cuda",
               local_rank: Optional[int] = None,
               timeout: Optional[timedelta] = None
               ) -> Tuple[dist.ProcessGroup, torch.device]:
    """Join the `n_shards`-rank default process group as `rank` (rendezvous
    at `init_method`: ``file://...``, ``tcp://host:port`` or ``env://``)
    and return (the group, this rank's device).  `local_rank` (default
    `rank`) picks the device among this host's (`rank_devices`);
    `timeout` bounds the rendezvous and each collective (torch's default
    without it)."""
    local = rank if local_rank is None else local_rank
    dev = rank_devices(local + 1, backend, device)[local]
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    kw = {} if timeout is None else {"timeout": timeout}
    dist.init_process_group(backend, init_method=init_method,
                            world_size=n_shards, rank=rank, **kw)
    return dist.group.WORLD, dev


def close_group() -> None:
    """Leave the default process group (if this process joined one)."""
    if dist.is_initialized():
        dist.destroy_process_group()


PARTITION_MODES = ("edge", "node")
# the grid's modes: the two partitions, and tensor parallelism
GRID_MODES = PARTITION_MODES + ("model",)


@dataclasses.dataclass(frozen=True)
class Grid:
    """This rank's place in the grid of ``n_data x k`` ranks of a
    partitioned or tensor-parallel run (the JAX package's ``("data",
    "graph")`` or ``("data", "model")`` mesh): rank ``d * k + g`` holds
    data shard d and part g.  `data` is the group of the ranks of part g
    (None for one data shard), `graph` the group of the ranks of data
    shard d, `step` every rank; `mode` "edge" (``graph_shards``), "node"
    (``node_shards``) or "model" (``model_shards``: `graph` is then the
    model group, whose ranks hold the column shards of the parameters,
    `parallel/tp.py`)."""
    n_data: int
    k: int
    mode: str
    data_index: int
    graph_index: int
    data: Optional[dist.ProcessGroup]
    graph: dist.ProcessGroup
    step: dist.ProcessGroup

    @property
    def model(self) -> Optional[dist.ProcessGroup]:
        """The model group of a tensor-parallel grid, else None."""
        return self.graph if self.mode == "model" else None


def make_grid(n_data: int, k: int, mode: str) -> Grid:
    """Split the joined default group of ``n_data * k`` ranks into the
    grid's groups.  Every rank calls it with the same arguments, since
    each `new_group` is collective: one group per graph part (the data
    groups, when ``n_data > 1``), then one per data shard (the graph or
    model groups), in the same order on every rank."""
    if mode not in GRID_MODES:
        raise ValueError(f"grid mode {mode!r}: one of {GRID_MODES}")
    world, rank = dist.get_world_size(), dist.get_rank()
    if world != n_data * k:
        raise ValueError(f"{world} ranks for a grid of {n_data} x {k}")
    d, g = divmod(rank, k)
    data = graph = None
    if n_data > 1:
        for gi in range(k):
            grp = dist.new_group([di * k + gi for di in range(n_data)])
            if gi == g:
                data = grp
    for di in range(n_data):
        grp = dist.new_group([di * k + gi for gi in range(k)])
        if di == d:
            graph = grp
    return Grid(n_data, k, mode, d, g, data, graph, dist.group.WORLD)
