"""Multi-host launch (port of `infomax3d_tpu/parallel/multihost.py`): one
process per card, on as many hosts as it takes.

`initialize_multihost` joins the process group from the environment that a
launcher sets, either torchrun's (`MASTER_ADDR`, `MASTER_PORT`, `RANK`,
`WORLD_SIZE`, `LOCAL_RANK`, `LOCAL_WORLD_SIZE`) or the JAX package's
(`COORDINATOR_ADDRESS` host:port, `NUM_PROCESSES`, `PROCESS_ID`, with
`LOCAL_RANK` where a host runs more than one process).  Each rank takes
card `LOCAL_RANK` (`mesh.rank_devices`).  `host_shard_indices` gives each
process a disjoint stride of one seeded permutation, so the union is the
dataset and the epochs stay globally shuffled.
"""
from __future__ import annotations

import os
from typing import Optional, Tuple, Union

import numpy as np
import torch
import torch.distributed as dist

from infomax3d_tpu_torch.parallel.mesh import make_group, rank_devices


def launch_environment() -> Optional[dict]:
    """The launch a launcher describes in the environment: rank, world
    size, local rank, local world size and the rendezvous (init_method);
    None when the environment names none."""
    env = os.environ
    if "WORLD_SIZE" in env:
        world = int(env["WORLD_SIZE"])
        return dict(rank=int(env.get("RANK", 0)), world=world,
                    local_rank=int(env.get("LOCAL_RANK", 0)),
                    local_world=int(env.get("LOCAL_WORLD_SIZE", world)),
                    init_method="env://")
    if "COORDINATOR_ADDRESS" in env:
        world = int(env["NUM_PROCESSES"])
        return dict(rank=int(env["PROCESS_ID"]), world=world,
                    local_rank=int(env.get("LOCAL_RANK", 0)),
                    local_world=int(env.get("LOCAL_WORLD_SIZE", 1)),
                    init_method=f"tcp://{env['COORDINATOR_ADDRESS']}")
    return None


def initialize_multihost(backend: str = "nccl",
                         device: Union[str, torch.device] = "cuda"
                         ) -> Tuple[dist.ProcessGroup, torch.device]:
    """Join the process group the environment describes
    (`launch_environment`); returns (group, this rank's device).  Raises when the environment describes no launch, and under
    NCCL when the host has fewer cards than local ranks."""
    launch = launch_environment()
    if launch is None:
        raise RuntimeError(
            "no launch in the environment: set torchrun's WORLD_SIZE / RANK "
            "/ MASTER_ADDR / MASTER_PORT (or COORDINATOR_ADDRESS / "
            "NUM_PROCESSES / PROCESS_ID)")
    rank_devices(launch["local_world"], backend, device)
    group, dev = make_group(launch["world"], launch["rank"],
                            launch["init_method"], backend, device,
                            local_rank=launch["local_rank"])
    return group, dev


def host_shard_indices(n_items: int, seed: int = 0,
                       process_index: Optional[int] = None,
                       process_count: Optional[int] = None) -> np.ndarray:
    """Deterministic disjoint per-process index shards: every process
    permutes the SAME way (same seed), then takes its stride slice.  The
    index and count default to this process's rank and the world size
    (0 and 1 outside a process group).  The copy of the JAX package's
    launch helper: no loader or CLI path of the port uses it yet (the
    shard loader splits each global batch instead)."""
    joined = dist.is_available() and dist.is_initialized()
    pi = (dist.get_rank() if joined else 0) if process_index is None \
        else process_index
    pc = (dist.get_world_size() if joined else 1) if process_count is None \
        else process_count
    perm = np.random.default_rng(seed).permutation(n_items)
    return perm[pi::pc]
