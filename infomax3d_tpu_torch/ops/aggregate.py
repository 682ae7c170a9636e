"""Aggregation over receiver-sorted CSR batches: the PNA aggregates (port
of `pna_csr_aggregate_parts` and its dispatch, infomax3d_tpu/ops/pallas/
spmm.py, and `pna_aggregate_parts`, infomax3d_tpu/ops/mailbox.py), the
node gathers `gather_src` / `gather_dst` and `edge_aggregate`
(`ops/mailbox.py`).

Dispatch as in the JAX package: on a CSR batch, bf16 messages with
max_deg <= 16 go to the fused stats kernel (`pna_stats`, with the pretrans
BatchNorm folded in as a column affine); float32 messages, or max_deg >
16, go to the multi-reduce kernel (`multi_reduce`) with the node-side
mean / std done here.  PNAOriginal's always-scaled aggregates go through
the same dispatch.

A batch without CSR arrays (``csr_buckets: False``, the bucket ladder,
the partitioned modes) takes the segment path, the JAX package's
`ops/segment.py::pna_multi_aggregate` in plain PyTorch on both devices:
float32 sums and sums of squares, one shared max over ``[msg, -msg]``,
the degree from the batch's `in_degree`; gathers whose backward is an
`index_add_`.  Its max / min gradient is shared evenly among tied edges,
as XLA's segment max shares it.  The JAX package's mailbox layout (a
scatter-free gather for the TPU) gives the same values and is not copied.
Under an edge-partition group (`parallel.context`) each rank holds an
edge shard: the partial sums are completed by an all-reduce and the extrema by a gathered max before
any mean, std or mask.  Under a node-partition group the sender gathers
read the halo-extended table (`parallel/node_partition.py`) and the
aggregations complete locally.
"""
from __future__ import annotations

from typing import List, NamedTuple, Sequence

import torch

from infomax3d_tpu_torch.ops.kernels import (csr_mean, csr_sum,
                                             multi_reduce, pna_stats)
from infomax3d_tpu_torch.ops.kernels.pna_stats import MAX_SLOTS
from infomax3d_tpu_torch.ops.segment import (EPS, _gathered_max,
                                             _segment_amax, gather_rows,
                                             segment_sum,
                                             take_rows, take_rows_recv)
from infomax3d_tpu_torch.parallel.context import (edge_partition_group,
                                                  node_partition_group)
from infomax3d_tpu_torch.parallel.edge_partition import \
    edge_partitioned_segment_sum


class AffinePart(NamedTuple):
    """A lazy column affine ``x * scale + shift`` (a BatchNorm apply; in
    training its scale and shift come from the batch statistics and carry
    gradients): consumers fold it into their weights or their kernel
    instead of materializing it."""
    x: torch.Tensor          # [rows, D]
    scale: torch.Tensor      # [D] float32
    shift: torch.Tensor      # [D] float32

    def materialize(self) -> torch.Tensor:
        return (self.x.float() * self.scale + self.shift).to(self.x.dtype)


def use_stats_kernel(messages: torch.Tensor, max_deg: int) -> bool:
    """The fused bf16 stats kernel packs winner slots for K <= 16."""
    return messages.dtype == torch.bfloat16 and max_deg <= MAX_SLOTS


def _stats_outs(g, x, aggregators, has, affine):
    # the sum section is written only when an aggregator reads it
    s1, mean, std, mx, mn, _ = pna_stats(x, g.csr_row_ptr, g.max_deg, affine,
                                         "sum" in aggregators)
    outs = {"sum": s1, "mean": mean, "std": std, "max": mx, "min": mn}
    if "var" in aggregators:
        outs["var"] = torch.where(has, std.float() ** 2 - EPS, 0.0)
    return outs


def _reduce_outs(g, x, deg, has, split_ties=False):
    s1, s2, mx, mn = multi_reduce(x, g.csr_row_ptr, g.max_deg,
                                  receivers=g.receivers,
                                  split_ties=split_ties)
    deg_safe = deg.clamp(min=1.0)
    mean = s1 / deg_safe
    var = torch.relu(s2 / deg_safe - mean * mean)
    zero = torch.zeros((), device=x.device)
    return {"sum": s1, "mean": torch.where(has, mean, zero), "max": mx,
            "min": mn, "var": torch.where(has, var, zero),
            "std": torch.where(has, torch.sqrt(var + EPS), zero)}


def _node_degree(g) -> torch.Tensor:
    """[N, 1] float32 in-degree: the CSR ranges' lengths, or the batch's
    `in_degree` (the whole batch's degree, also on an edge shard)."""
    if g.csr:
        rp = g.csr_row_ptr
        return (rp[1:] - rp[:-1]).float()[:, None]
    return g.in_degree.float()[:, None]


def _edge_sum(x: torch.Tensor, receivers: torch.Tensor, n: int
              ) -> torch.Tensor:
    """The segment sum of `x` by receiver, completed over the
    edge-partition group where one is set."""
    group = edge_partition_group()
    if group is None:
        return segment_sum(x, receivers, n)
    return edge_partitioned_segment_sum(x, receivers, n, group)


def _segment_outs(g, x, aggregators, deg, has):
    """The segment path's aggregates in float32 (float64 for float64
    messages; JAX `pna_multi_aggregate`), completed over an
    edge-partition group."""
    group = edge_partition_group()
    N, D = g.num_nodes, x.shape[1]
    x = x.to(torch.promote_types(x.dtype, torch.float32))
    deg_safe = deg.clamp(min=1.0)
    zero = torch.zeros((), device=x.device)
    outs = {}
    if any(a in ("std", "var") for a in aggregators):
        both = _edge_sum(torch.cat([x, x * x], dim=-1), g.receivers, N)
        s1, s2 = both[:, :D], both[:, D:]
    else:
        s1, s2 = _edge_sum(x, g.receivers, N), None
    mean = s1 / deg_safe
    outs["sum"] = s1
    outs["mean"] = torch.where(has, mean, zero)
    want = [a for a in ("max", "min") if a in aggregators]
    if want:
        # empty local segments hold -inf: the completion comes before the
        # mask, which reads the whole batch's degree
        both = _segment_amax(torch.cat(
            [x if a == "max" else -x for a in want], dim=-1),
            g.receivers, N)
        if group is not None:
            both = _gathered_max(both, group)
        for j, a in enumerate(want):
            part = both[:, j * D:(j + 1) * D]
            outs[a] = torch.where(has, part if a == "max" else -part, zero)
    if s2 is not None:
        var = torch.relu(s2 / deg_safe - mean * mean)
        outs["var"] = torch.where(has, var, zero)
        outs["std"] = torch.where(has, torch.sqrt(var + EPS), zero)
    return outs


def pna_aggregate_parts(g, messages, aggregators: Sequence[str],
                        scalers: Sequence[str], avg_d_log: float = 1.0,
                        split_ties: bool = False) -> List[torch.Tensor]:
    """The PNA aggregates of edge `messages` (a tensor or an `AffinePart`)
    at each receiver, as [N, D] blocks in scaler-major, aggregator-minor
    order, in the messages' dtype.  Nodes without edges give 0.
    `split_ties` is the multi-reduce path's tie rule (`multi_reduce`)."""
    unknown = set(aggregators) - {"sum", "mean", "max", "min", "std", "var"}
    if unknown:
        raise ValueError(f"unsupported PNA aggregators: {sorted(unknown)}")
    affine = None
    x = messages
    if isinstance(messages, AffinePart):
        x, affine = messages.x, (messages.scale, messages.shift)
    deg = _node_degree(g).to(torch.promote_types(x.dtype, torch.float32))
    has = deg > 0
    if not g.csr:
        if affine is not None:
            x = messages.materialize()
        outs = _segment_outs(g, x, aggregators, deg, has)
    elif use_stats_kernel(x, g.max_deg):
        outs = _stats_outs(g, x, aggregators, has, affine)
    else:
        if affine is not None:
            x = messages.materialize()
        outs = _reduce_outs(g, x, deg, has, split_ties)
    dt = x.dtype
    aggs = [outs[a].to(dt) for a in aggregators]
    if len(scalers) <= 1:
        return aggs
    log_deg = torch.log(deg + 1.0)
    parts = []
    for s in scalers:
        if s == "identity":
            parts.extend(aggs)
            continue
        if s == "amplification":
            scale = log_deg / avg_d_log
        elif s == "attenuation":
            scale = torch.where(has, avg_d_log / log_deg.clamp(min=EPS), 0.0)
        else:
            raise ValueError(f"unknown PNA scaler: {s}")
        scale = scale.to(dt)
        parts.extend(a * scale for a in aggs)
    return parts


def pna_aggregate_parts_always_scaled(g, messages, aggregators: Sequence[str],
                                      scalers: Sequence[str],
                                      avg_d_log: float = 1.0
                                      ) -> List[torch.Tensor]:
    """PNAOriginal's aggregates (the JAX package's
    `pna_multi_aggregate_always_scaled`): `pna_aggregate_parts` with the
    identity scaler alone, then every scaler applied, even a single one.
    The identity blocks keep the messages' dtype; the scaled ones are the
    identity block times a float32 degree factor, so they come back in
    float32 (as JAX promotes ``h * (log_deg / avg_d_log)``).  The moment
    aggregators are refused, as in JAX.  JAX aggregates PNAOriginal on
    XLA's segment ops, whose max / min gradient is shared among tied
    edges (on the multi-reduce path here too: `split_ties`; ties are
    common where the messages are rows of h itself, as in
    PNAOriginalSimple, whose dropout zeroes entries).  The bf16 statistics
    kernel's backward routes a tie's cotangent to one winner edge, as the
    JAX package's Pallas path does: the same total per node."""
    if any(a.startswith("moment") for a in aggregators):
        raise ValueError("moment aggregators are not supported by "
                         "PNAOriginal (the reference implementation "
                         "collapses them)")
    aggs = pna_aggregate_parts(g, messages, aggregators, ("identity",),
                               avg_d_log, split_ties=True)
    deg = _node_degree(g)
    has = deg > 0
    log_deg = torch.log(deg + 1.0)
    parts = []
    for s in scalers:
        if s == "identity":
            parts.extend(aggs)
        elif s == "amplification":
            parts.extend(a * (log_deg / avg_d_log) for a in aggs)
        elif s == "attenuation":
            att = avg_d_log / log_deg.clamp(min=EPS)
            parts.extend(torch.where(has, a * att, 0.0) for a in aggs)
        else:
            raise ValueError(f"unknown PNA scaler: {s}")
    return parts


def gather_src(g, h: torch.Tensor) -> torch.Tensor:
    """``h[senders]``; on a CSR batch its backward is the sender-keyed
    segment sum over the batch's CSC arrays (`ops/segment.py::take_rows`),
    as the JAX package's `gather_src` on CSR batches; on the segment path
    a gather whose backward is an `index_add_`; on a node shard the
    gather reads the halo-extended table ``[owned ‖ ghosts]``."""
    if g.csr:
        return take_rows(h, g.senders, g.csc_row_ptr, g.csc_perm)
    return gather_rows(halo_extended(g.halo_send, h), g.senders)


def gather_dst(g, h: torch.Tensor) -> torch.Tensor:
    """``h[receivers]``; on a CSR batch its backward is the CSR segment
    sum over the batch's `csr_row_ptr` (`ops/segment.py::take_rows_recv`),
    as the JAX package's `gather_dst` on CSR batches; on the segment path
    a gather whose backward is an `index_add_`."""
    if g.csr:
        return take_rows_recv(h, g.receivers, g.csr_row_ptr)
    return gather_rows(h, g.receivers)


def halo_extended(halo_send, h: torch.Tensor) -> torch.Tensor:
    """`h` extended with its ghost rows over the node-partition group
    (`parallel/node_partition.py::halo_exchange`) where the batch is a
    node shard (it carries `halo_send`), else `h`."""
    group = node_partition_group()
    if halo_send is None or group is None:
        return h
    from infomax3d_tpu_torch.parallel.node_partition import halo_exchange
    return halo_exchange(h, halo_send, group)


def combine_plain(hd: torch.Tensor, hs: torch.Tensor, pe: torch.Tensor,
                  receivers: torch.Tensor, senders: torch.Tensor,
                  halo_send=None) -> torch.Tensor:
    """The edge combine's segment path ``hd[receivers] + hs[senders] +
    pe`` (the JAX `SplitDense` over `GatherPart`s on a batch without CSR
    arrays): both gathers' backward an `index_add_`; on a node shard the
    sender side reads `hs`'s halo-extended table."""
    return (gather_rows(hd, receivers)
            + gather_rows(halo_extended(halo_send, hs), senders) + pe)


def edge_aggregate(g, messages: torch.Tensor, op: str) -> torch.Tensor:
    """Edge messages reduced at each receiver: "sum" in float32 whatever
    the messages' dtype (float64 for float64 messages on the segment
    path), "mean" in the messages' dtype; nodes without
    edges give 0.  On a CSR batch `csr_sum` / `csr_mean`; on the segment
    path an `index_add_` in float32 (completed over an edge-partition
    group), the mean over the batch's `in_degree`."""
    if op not in ("sum", "mean"):
        raise ValueError(f"unsupported edge aggregation: {op!r}")
    if g.csr:
        fn = csr_sum if op == "sum" else csr_mean
        return fn(messages, g.csr_row_ptr, g.receivers)
    s = _edge_sum(messages.to(torch.promote_types(messages.dtype,
                                                  torch.float32)),
                  g.receivers, g.num_nodes)
    if op == "sum":
        return s
    return (s / g.in_degree.float().clamp(min=1.0)[:, None]).to(
        messages.dtype)
