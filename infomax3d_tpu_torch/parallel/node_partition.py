"""Node-sharded graph partitioning with a halo exchange, the
``node_shards`` mode (port of `infomax3d_tpu/parallel/node_partition.py`).

The node set of a batch is cut over the k ranks of a node-partition group,
so each rank's arrays shrink to about 1/k: nodes are owned in contiguous
ranges of ``Nl = ceil(N / k)`` (rounded up to 8), and every edge lives on
the rank that owns its receiver, so a node's whole in-edge set is local
and the receiver-side aggregations complete without a collective.  Only
sender-side rows cross ranks: the host plan (`build_node_partition`)
lists, for each exchange round r (rank s sends to ``s + r``), the owned
rows each rank sends, and edges address their senders through a local
index into ``[owned ‖ ghosts of round 1 ‖ ... ‖ ghosts of round k-1]``.

`shard_graph_batch` cuts a host batch down to one rank's shard (the JAX
package stacks all k shards on a leading axis for `shard_map`; a rank
here needs only its own, and its arrays equal the JAX stack's slice).
`halo_exchange` builds the extended table on the ranks
(`torch.distributed.batch_isend_irecv`, which gloo and NCCL both serve);
its backward returns the ghost rows' cotangents to their owners, which
add them into the owned rows.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from infomax3d_tpu_torch.graphs.batch import HALO_KEY
from infomax3d_tpu_torch.ops.segment import segment_sum


@dataclass
class NodePartitionPlan:
    """Host-built partition arrays, one row per shard (the JAX plan)."""
    k: int
    n_local: int                      # Nl: owned nodes per shard (padded)
    halo_sizes: List[int]             # H_r per round, r = 1 .. k-1
    node_idx: np.ndarray              # [k, Nl] global id of each owned row
    node_mask: np.ndarray             # [k, Nl] owned-row validity
    senders_loc: np.ndarray           # [k, El] index into extended table
    receivers_loc: np.ndarray         # [k, El] index into owned rows
    edge_mask: np.ndarray             # [k, El]
    edge_perm: np.ndarray             # [k, El] global edge id (padding: E)
    send_idx: List[np.ndarray]        # per round r: [k, H_r] owned rows
    node_payload: Dict[str, np.ndarray] = field(default_factory=dict)
    edge_payload: Dict[str, np.ndarray] = field(default_factory=dict)

    @property
    def extended_rows(self) -> int:
        return self.n_local + sum(self.halo_sizes)


def build_node_partition(senders: np.ndarray, receivers: np.ndarray,
                         edge_mask: np.ndarray, num_nodes: int, k: int,
                         node_arrays: Optional[Dict[str, np.ndarray]] = None,
                         edge_arrays: Optional[Dict[str, np.ndarray]] = None,
                         el_pad: int = 0, halo_pad: int = 0
                         ) -> NodePartitionPlan:
    """Cut a batched graph's nodes into k contiguous shards and build the
    static halo-exchange plan (the JAX package's, array for array).
    ``el_pad`` / ``halo_pad`` > 0 pin the edges per shard and the halo
    rows per round (one shape across batches); a batch that needs more
    raises, as a bucket overflow does."""
    senders = np.asarray(senders)
    receivers = np.asarray(receivers)
    edge_mask = np.asarray(edge_mask, bool)
    E = senders.shape[0]
    Nl = int(np.ceil(num_nodes / k / 8) * 8)

    def owner(n):
        return np.minimum(n // Nl, k - 1) if Nl else np.zeros_like(n)

    recv_owner = owner(receivers.clip(0, num_nodes - 1))
    send_owner = owner(senders.clip(0, num_nodes - 1))
    shard_edges = [np.nonzero(edge_mask & (recv_owner == s))[0]
                   for s in range(k)]
    El = int(np.ceil(max((len(e) for e in shard_edges), default=1) / 8) * 8)
    El = max(El, 8)
    if el_pad:
        if El > el_pad:
            raise ValueError(f"node partition overflow: a shard holds {El} "
                             f"edges > el_pad {el_pad} — grow the pad")
        El = el_pad

    # need[s][o]: the sorted rows shard s reads from shard o; round r
    # sends need[(o + r) % k][o] from o, so the ghost slots line up with
    # no index traffic
    need = [[None] * k for _ in range(k)]
    for s in range(k):
        es = shard_edges[s]
        remote = es[send_owner[es] != s]
        for o in range(k):
            if o != s:
                need[s][o] = np.unique(senders[remote[send_owner[remote]
                                                      == o]])
    halo_sizes, send_idx = [], []
    for r in range(1, k):
        H = max((len(need[(o + r) % k][o]) for o in range(k)), default=0)
        H = max(int(np.ceil(max(H, 1) / 8) * 8), 8)
        if halo_pad:
            if H > halo_pad:
                raise ValueError(f"node partition overflow: halo round {r} "
                                 f"needs {H} rows > halo_pad {halo_pad}")
            H = halo_pad
        halo_sizes.append(H)
        si = np.zeros((k, H), np.int32)
        for o in range(k):
            rows = need[(o + r) % k][o]
            si[o, :len(rows)] = rows - o * Nl
        send_idx.append(si)
    ext = Nl + sum(halo_sizes)

    node_idx = np.full((k, Nl), num_nodes, np.int32)
    node_mask = np.zeros((k, Nl), bool)
    for s in range(k):
        lo, hi = s * Nl, min((s + 1) * Nl, num_nodes)
        if hi > lo:
            node_idx[s, :hi - lo] = np.arange(lo, hi, dtype=np.int32)
            node_mask[s, :hi - lo] = True

    senders_loc = np.full((k, El), ext - 1, np.int32)   # padding: last row
    receivers_loc = np.full((k, El), Nl - 1, np.int32)
    e_mask = np.zeros((k, El), bool)
    edge_perm = np.full((k, El), E, np.int32)
    for s in range(k):
        es = shard_edges[s]
        src, own = senders[es].astype(np.int64), send_owner[es]
        loc = src - s * Nl
        off = Nl
        for r in range(1, k):
            o = (s - r) % k
            sel = own == o
            loc[sel] = off + np.searchsorted(need[s][o], src[sel])
            off += halo_sizes[r - 1]
        senders_loc[s, :len(es)] = loc
        receivers_loc[s, :len(es)] = receivers[es] - s * Nl
        e_mask[s, :len(es)] = True
        edge_perm[s, :len(es)] = es

    node_payload = {}
    for key, a in (node_arrays or {}).items():
        buf = np.zeros((k, Nl) + a.shape[1:], a.dtype)
        for s in range(k):
            sel = node_idx[s][node_mask[s]]
            buf[s, :len(sel)] = a[sel]
        node_payload[key] = buf
    edge_payload = {}
    for key, a in (edge_arrays or {}).items():
        buf = np.zeros((k, El) + a.shape[1:], a.dtype)
        for s in range(k):
            buf[s, :len(shard_edges[s])] = a[shard_edges[s]]
        edge_payload[key] = buf

    return NodePartitionPlan(k=k, n_local=Nl, halo_sizes=halo_sizes,
                             node_idx=node_idx, node_mask=node_mask,
                             senders_loc=senders_loc,
                             receivers_loc=receivers_loc, edge_mask=e_mask,
                             edge_perm=edge_perm, send_idx=send_idx,
                             node_payload=node_payload,
                             edge_payload=edge_payload)


# a view's node-keyed and edge-keyed fields, each with its padding value
NODE_FIELDS = {"node_feat": 0, "node_graph": None, "node_mask": False,
               "coords": 0, "node_pos": 0, "snorm": 0, "lap_pe": 0,
               "in_degree": 0}
EDGE_FIELDS = {"edge_feat": 0, "edge_dist": 0, "edge_graph": None}
# fields replicated on every shard (the graphs')
GRAPH_FIELDS = ("graph_mask", "n_nodes", "targets")


def shard_graph_batch(arrays: Dict[str, np.ndarray], k: int, index: int,
                      el_pad: int = 0, halo_pad: int = 0
                      ) -> Dict[str, np.ndarray]:
    """Shard `index` of k of a collated graph view (`batch_graphs`'
    arrays): its owned node rows (node features, ids, mask, coordinates,
    positions, norms and `in_degree`, the global degree of each owned
    node, since its in-edges are all local), its receiver-owned edges
    (features, distances, mask; `senders` local indices into ``[owned ‖
    ghosts]``, padding -> the extended row count; `receivers` local owned
    indices, padding -> Nl), the graph fields whole, and the halo send
    lists ``halo_send_r`` ([H_r] owned rows).  The arrays equal slice
    `index` of the JAX package's stacked `shard_graph_batch`.  Every other
    array (CSR, the readout regroup) indexes the whole batch's order and
    is dropped: the shard takes the segment path and the segment
    readout (``nmax`` 0)."""
    N = arrays["node_feat"].shape[0]
    G = arrays["graph_mask"].shape[0]
    plan = build_node_partition(arrays["senders"], arrays["receivers"],
                                arrays["edge_mask"], N, k, el_pad=el_pad,
                                halo_pad=halo_pad)
    Nl, ext = plan.n_local, plan.extended_rows

    def part(a, pad, idx):
        pad_row = np.full((1,) + a.shape[1:], pad, a.dtype)
        return np.concatenate([a, pad_row])[idx]

    out = {}
    for key, pad in NODE_FIELDS.items():
        if key in arrays:
            out[key] = part(arrays[key], G if pad is None else pad,
                            plan.node_idx[index])
    for key, pad in EDGE_FIELDS.items():
        if key in arrays:
            out[key] = part(arrays[key], G if pad is None else pad,
                            plan.edge_perm[index])
    for key in GRAPH_FIELDS:
        if key in arrays:
            out[key] = arrays[key]
    emask = plan.edge_mask[index]
    out["senders"] = np.where(emask, plan.senders_loc[index],
                              ext).astype(np.int32)
    out["receivers"] = np.where(emask, plan.receivers_loc[index],
                                Nl).astype(np.int32)
    out["edge_mask"] = emask
    for r, si in enumerate(plan.send_idx):
        out[f"{HALO_KEY}{r}"] = si[index]
    out["max_deg"] = np.asarray(0, np.int64)
    out["nmax"] = np.asarray(0, np.int64)
    return out


def _p2p(rounds, group, n_ranks: int, sign: int):
    """Exchange round r's tensor with ranks ``s + sign * r`` (send) and
    ``s - sign * r`` (receive); returns the received tensors.  Under gloo
    CUDA tensors go through host copies."""
    s = dist.get_rank(group)
    staged = dist.get_backend(group) == "gloo"
    ops, recv = [], []
    for r, t in enumerate(rounds, start=1):
        src = t.contiguous()
        if staged:
            src = src.cpu()
        buf = torch.empty_like(src)
        ops.append(dist.P2POp(dist.isend, src, dist.get_global_rank(
            group, (s + sign * r) % n_ranks), group))
        ops.append(dist.P2POp(dist.irecv, buf, dist.get_global_rank(
            group, (s - sign * r) % n_ranks), group))
        recv.append(buf)
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    return [b.to(t.device) for b, t in zip(recv, rounds)]


class _HaloExchange(torch.autograd.Function):
    @staticmethod
    def forward(ctx, h, group, *send_idx):
        k = dist.get_world_size(group)
        ctx.group, ctx.k, ctx.n_local = group, k, h.shape[0]
        ctx.save_for_backward(*send_idx)
        rows = [h[si.long()] for si in send_idx]
        return torch.cat([h] + _p2p(rows, group, k, +1), dim=0)

    @staticmethod
    def backward(ctx, ct):
        send_idx = ctx.saved_tensors
        n = ctx.n_local
        ghosts = list(torch.split(ct[n:], [int(si.shape[0])
                                           for si in send_idx]))
        # each ghost block goes back to the rank it came from, and each
        # rank adds what comes back into the rows it sent
        back = _p2p(ghosts, ctx.group, ctx.k, -1)
        d_h = ct[:n].clone()
        for si, b in zip(send_idx, back):
            d_h.index_add_(0, si.long(), b)
        return (d_h, None) + (None,) * len(send_idx)


def halo_exchange(h_local: torch.Tensor, send_idx: Sequence[torch.Tensor],
                  group) -> torch.Tensor:
    """The owned rows `h_local` [Nl, D] extended with their ghost rows
    over the node-partition `group`: round r sends this rank's rows
    ``send_idx[r - 1]`` to rank ``s + r`` and receives rank ``s - r``'s,
    so the result is ``[owned ‖ ghosts of round 1 ‖ ...]``, as the plan's
    local sender indices address it.  Differentiable: the backward sends
    the ghosts' cotangents back to their owners, which `index_add_` them
    into the rows they sent."""
    return _HaloExchange.apply(h_local, group, *send_idx)


def local_segment_reduce(messages: torch.Tensor, receivers_loc: torch.Tensor,
                         edge_mask: torch.Tensor, n_local: int,
                         op: str = "sum") -> torch.Tensor:
    """Aggregation over the owned nodes, complete with no collective
    (every edge of an owned receiver is local): "sum", "mean" or "max"
    (0 where a node has no edge), padding edges masked."""
    m = torch.where(edge_mask[:, None], messages,
                    torch.zeros((), dtype=messages.dtype,
                                device=messages.device))
    if op == "sum":
        return segment_sum(m, receivers_loc, n_local)
    if op == "mean":
        s = segment_sum(m, receivers_loc, n_local)
        deg = segment_sum(edge_mask.to(m.dtype), receivers_loc, n_local)
        return s / deg.clamp(min=1.0)[:, None]
    if op == "max":
        big = 3.0e38
        mm = torch.where(edge_mask[:, None], messages,
                         torch.full((), -big, dtype=messages.dtype,
                                    device=messages.device))
        ids = receivers_loc.long()
        ids = torch.where((ids >= 0) & (ids < n_local), ids, n_local)
        out = mm.new_full((n_local + 1, mm.shape[1]), float("-inf"))
        r = out.scatter_reduce(0, ids[:, None].expand_as(mm), mm,
                               "amax")[:n_local]
        return torch.where(r <= -big, torch.zeros((), dtype=r.dtype,
                                                  device=r.device), r)
    raise ValueError(f"unsupported op: {op}")
