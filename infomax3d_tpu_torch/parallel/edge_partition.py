"""Edge-partitioned graph parallelism, the ``graph_shards`` mode (port of
`infomax3d_tpu/parallel/edge_partition.py`).

The edge set of a batch is cut over the k ranks of an edge-partition group
while the node arrays stay whole on every rank: each rank runs the edge
network (the message MLPs) on its edge shard and reduces into a node-sized
partial, which an all-reduce over the group completes (the aggregations
of `ops/aggregate.py` under `parallel.context.edge_partition_group`).

`partition_edges` and `shard_edge_arrays` are the JAX package's host
helpers (a greedy per-molecule bin packing); the training mode itself
takes the round-robin cut of `shard_batch_edges`.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence

import numpy as np
import torch

from infomax3d_tpu_torch.graphs.batch import CSR_FIELDS
from infomax3d_tpu_torch.ops.segment import segment_sum
from infomax3d_tpu_torch.parallel.collectives import all_reduce_sum


def partition_edges(edge_graph: np.ndarray, edge_mask: np.ndarray,
                    n_shards: int) -> np.ndarray:
    """Greedy per-molecule bin packing of edges into `n_shards` balanced
    shards: each edge's shard id (padding edges round-robin)."""
    E = edge_graph.shape[0]
    shard_of_edge = np.zeros(E, np.int32)
    loads = np.zeros(n_shards, np.int64)
    graphs, counts = np.unique(edge_graph[edge_mask], return_counts=True)
    for gi in np.argsort(-counts):
        s = int(np.argmin(loads))
        shard_of_edge[(edge_graph == graphs[gi]) & edge_mask] = s
        loads[s] += counts[gi]
    pad_idx = np.nonzero(~edge_mask)[0]
    shard_of_edge[pad_idx] = np.arange(len(pad_idx)) % n_shards
    return shard_of_edge


def shard_edge_arrays(arrays: Dict[str, np.ndarray], shard_of_edge: np.ndarray,
                      n_shards: int, keys: Sequence[str]
                      ) -> Dict[str, np.ndarray]:
    """The edge arrays `keys` regrouped and padded into [n_shards,
    E_shard] stacks (E_shard the largest shard, rounded up to 8; sender
    and receiver padding far out of range), with ``edge_shard_mask``."""
    out = {}
    per_shard: List[np.ndarray] = [np.nonzero(shard_of_edge == s)[0]
                                   for s in range(n_shards)]
    e_shard = int(np.ceil(max(len(idx) for idx in per_shard) / 8) * 8)
    for k in keys:
        a = arrays[k]
        pads = np.zeros((n_shards, e_shard) + a.shape[1:], a.dtype)
        if a.dtype == np.int32 and k in ("senders", "receivers"):
            pads[:] = np.iinfo(np.int32).max // 2
        for s, idx in enumerate(per_shard):
            pads[s, :len(idx)] = a[idx]
        out[k] = pads
    edge_mask = arrays.get("edge_mask",
                           np.ones(shard_of_edge.shape[0], bool))
    mask = np.zeros((n_shards, e_shard), bool)
    for s, idx in enumerate(per_shard):
        mask[s, :len(idx)] = edge_mask[idx]
    out["edge_shard_mask"] = mask
    return out


# the edge-keyed fields a shard keeps, each cut round-robin
EDGE_FIELDS = ("senders", "receivers", "edge_mask", "edge_feat", "edge_dist")


def shard_batch_edges(g, k: int, index: int):
    """Rank `index`'s round-robin edge shard of the batch `g` (a
    `GraphBatch`, or a collated view's host arrays; edge e goes to rank
    ``e % k``): the edge fields cut, the node and graph fields whole, the
    batch's `in_degree` (the whole batch's degree, which the completed
    aggregations read) kept, the CSR arrays dropped (they index the whole
    edge order).  The padded layout puts real edges first, so the stride
    balances real edges within one."""
    view = isinstance(g, dict)
    E = (g["senders"] if view else g.senders).shape[0]
    if E % k:
        raise ValueError(f"edge capacity {E} not divisible by graph_shards "
                         f"{k}")

    def cut(a):
        a = a.reshape((E // k, k) + tuple(a.shape[1:]))[:, index]
        return np.ascontiguousarray(a) if view else a.contiguous()
    if view:
        out = {f: a for f, a in g.items()
               if f not in CSR_FIELDS + ("csr_pos",)}
        out.update({f: cut(g[f]) for f in EDGE_FIELDS if f in g})
        return out
    return dataclasses.replace(
        g, **{f: cut(getattr(g, f)) for f in EDGE_FIELDS
              if getattr(g, f) is not None},
        **{f: None for f in CSR_FIELDS})


def edge_partitioned_segment_sum(messages: torch.Tensor,
                                 receivers: torch.Tensor, num_nodes: int,
                                 group) -> torch.Tensor:
    """The local partial segment sum of an edge shard, completed by an
    all-reduce over `group`: the sum over the whole edge set."""
    return all_reduce_sum(segment_sum(messages, receivers, num_nodes), group)
