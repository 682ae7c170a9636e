"""Aggregation over receiver-sorted CSR batches: the PNA aggregates (port
of `pna_csr_aggregate_parts` and its dispatch, infomax3d_tpu/ops/pallas/
spmm.py, and `pna_aggregate_parts`, infomax3d_tpu/ops/mailbox.py), the
node gathers `gather_src` / `gather_dst` and `edge_aggregate`
(`ops/mailbox.py`).

Dispatch as in the JAX package: bf16 messages with max_deg <= 16 go to the
fused stats kernel (`pna_stats`, with the pretrans BatchNorm folded in as a
column affine); float32 messages, or max_deg > 16, go to the multi-reduce
kernel (`multi_reduce`) with the node-side mean / std done here.
PNAOriginal's always-scaled aggregates go through the same dispatch.  The
port has CSR batches only (no mailbox or segment-scatter path).
"""
from __future__ import annotations

from typing import List, NamedTuple, Sequence

import torch

from infomax3d_tpu_torch.ops.kernels import (csr_mean, csr_sum,
                                             multi_reduce, pna_stats)
from infomax3d_tpu_torch.ops.kernels.pna_stats import MAX_SLOTS
from infomax3d_tpu_torch.ops.segment import EPS, take_rows, take_rows_recv


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
    rp = g.csr_row_ptr
    deg = (rp[1:] - rp[:-1]).float()[:, None]
    has = deg > 0
    if use_stats_kernel(x, g.max_deg):
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
    rp = g.csr_row_ptr
    deg = (rp[1:] - rp[:-1]).float()[:, None]
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
    """``h[senders]``; its backward is the sender-keyed segment sum over the
    batch's CSC arrays (`ops/segment.py::take_rows`), as the JAX package's
    `gather_src` on CSR batches."""
    return take_rows(h, g.senders, g.csc_row_ptr, g.csc_perm)


def gather_dst(g, h: torch.Tensor) -> torch.Tensor:
    """``h[receivers]``; its backward is the CSR segment sum over the
    batch's `csr_row_ptr` (`ops/segment.py::take_rows_recv`), as the JAX
    package's `gather_dst` on CSR batches."""
    return take_rows_recv(h, g.receivers, g.csr_row_ptr)


def edge_aggregate(g, messages: torch.Tensor, op: str) -> torch.Tensor:
    """Edge messages reduced at each receiver: "sum" is `csr_sum` (float32
    whatever the messages' dtype), "mean" is `csr_mean` (the messages'
    dtype); nodes without edges give 0."""
    if op == "sum":
        return csr_sum(messages, g.csr_row_ptr, g.receivers)
    if op == "mean":
        return csr_mean(messages, g.csr_row_ptr, g.receivers)
    raise ValueError(f"unsupported edge aggregation: {op!r}")
