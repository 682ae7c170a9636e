"""The data-parallel process group of one host (port of
`infomax3d_tpu/parallel/mesh.py`'s one-axis ``data`` mesh): one process per
shard (rank), each on its own device.

* NCCL (the default): every rank needs a CUDA card of its own, and NCCL
  refuses two ranks on one card, so fewer cards than ranks raises.
* gloo: taken only where the caller names it; ranks on "cpu", or on the
  host's cards in turn (several ranks may then share one card).

Nothing switches backend or device on its own.
"""
from __future__ import annotations

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
