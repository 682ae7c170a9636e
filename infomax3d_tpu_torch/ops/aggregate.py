"""Aggregation over receiver-sorted CSR batches: the PNA aggregates (port
of `pna_csr_aggregate_parts` and its dispatch, infomax3d_tpu/ops/pallas/
spmm.py, and `pna_aggregate_parts`, infomax3d_tpu/ops/mailbox.py), the
node gathers `gather_src` / `gather_dst` and `edge_aggregate`
(`ops/mailbox.py`).

Dispatch as in the JAX package: bf16 messages with max_deg <= 16 go to the
fused stats kernel (`pna_stats`, with the pretrans BatchNorm folded in as a
column affine); float32 messages, or max_deg > 16, go to the multi-reduce
kernel (`multi_reduce`) with the node-side mean / std done here.  The port
has CSR batches only (no mailbox or segment-scatter path).
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


def _reduce_outs(g, x, deg, has):
    s1, s2, mx, mn = multi_reduce(x, g.csr_row_ptr, g.max_deg,
                                  receivers=g.receivers)
    deg_safe = deg.clamp(min=1.0)
    mean = s1 / deg_safe
    var = torch.relu(s2 / deg_safe - mean * mean)
    zero = torch.zeros((), device=x.device)
    return {"sum": s1, "mean": torch.where(has, mean, zero), "max": mx,
            "min": mn, "var": torch.where(has, var, zero),
            "std": torch.where(has, torch.sqrt(var + EPS), zero)}


def pna_aggregate_parts(g, messages, aggregators: Sequence[str],
                        scalers: Sequence[str], avg_d_log: float = 1.0
                        ) -> List[torch.Tensor]:
    """The PNA aggregates of edge `messages` (a tensor or an `AffinePart`)
    at each receiver, as [N, D] blocks in scaler-major, aggregator-minor
    order, in the messages' dtype.  Nodes without edges give 0."""
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
        outs = _reduce_outs(g, x, deg, has)
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
