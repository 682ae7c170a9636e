"""Graph readout, the node gathers and plain segment reductions (port of
`infomax3d_tpu/ops/segment.py`: the dense-regroup path `_regroup` /
`_graph_readout_dense` / `batch_readout`, the segment readout
`graph_readout` (batches without the regroup, and node shards, whose
per-shard partials it completes over the node-partition group),
`take_rows` over the senders and over the receivers, the plain gather
`gather_rows`, the clipped `take`, `segment_sum` / `segment_mean` /
`segment_max` / `segment_min` / `segment_softmax`)."""
from __future__ import annotations

from typing import Optional, Sequence

import torch

# before the kernel imports: the kernels' modules read it from here
EPS = 1e-5  # reference models/pna.py:14

from infomax3d_tpu_torch.ops.kernels.csr_segment_sum import csr_segment_sum  # noqa: E402
from infomax3d_tpu_torch.ops.kernels.snd_segment_sum import snd_segment_sum  # noqa: E402
from infomax3d_tpu_torch.parallel.collectives import (  # noqa: E402
    all_gather_rows, all_reduce_sum)
from infomax3d_tpu_torch.parallel.context import node_partition_group  # noqa: E402


def take_clipped(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``x[idx.clamp(0, len(x) - 1)]``: padding ids read the last row, as
    the JAX package's clipped `take` does (their rows are masked)."""
    return x[idx.clamp(0, x.shape[0] - 1).long()]


def segment_sum(data: torch.Tensor, segment_ids: torch.Tensor,
                num_segments: int) -> torch.Tensor:
    """``[num_segments, ...]``: the rows of `data` summed by segment id
    (`index_add_`); ids outside [0, num_segments) are dropped, as XLA's
    scatter drops them (padding rows carry id ``num_segments``)."""
    ids = segment_ids.long()
    ids = torch.where((ids >= 0) & (ids < num_segments), ids, num_segments)
    out = data.new_zeros((num_segments + 1,) + tuple(data.shape[1:]))
    return out.index_add(0, ids, data)[:num_segments]


def degree(segment_ids: torch.Tensor, num_segments: int,
           mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """[num_segments] float32: the rows per segment id (those where `mask`
    is true, given one); out-of-range ids are dropped."""
    ones = torch.ones(segment_ids.shape[0], device=segment_ids.device)
    if mask is not None:
        ones = ones * mask.float()
    return segment_sum(ones, segment_ids, num_segments)


def segment_mean(data: torch.Tensor, segment_ids: torch.Tensor,
                 num_segments: int) -> torch.Tensor:
    """`segment_sum` over each segment's row count (at least 1)."""
    deg = degree(segment_ids, num_segments).clamp(min=1.0)
    return segment_sum(data, segment_ids, num_segments) / deg.reshape(
        (-1,) + (1,) * (data.ndim - 1))


class _SegmentAmax(torch.autograd.Function):
    """`scatter_reduce` "amax" into a -inf table, with XLA's segment-max
    gradient: each row that ties its segment's max gets the cotangent
    times ``1 / (rows tied)``, as the JAX package's `segment_max` (which
    torch's own backward divides instead, an ulp away)."""

    @staticmethod
    def forward(ctx, data, ids, rows):
        out = data.new_full((rows,) + tuple(data.shape[1:]), float("-inf"))
        out = out.scatter_reduce(0, ids, data, "amax")
        ctx.save_for_backward(data, ids, out)
        return out

    @staticmethod
    def backward(ctx, ct):
        data, ids, out = ctx.saved_tensors
        win = data == out.gather(0, ids)
        ties = torch.zeros_like(out).scatter_add_(0, ids, win.to(out.dtype))
        coef = torch.where(win, (1.0 / ties).gather(0, ids),
                           torch.zeros((), dtype=out.dtype,
                                       device=out.device))
        return coef * ct.gather(0, ids), None, None


def _segment_amax(data: torch.Tensor, segment_ids: torch.Tensor,
                  num_segments: int) -> torch.Tensor:
    """Each segment's max of its rows, -inf for a segment without rows
    (XLA's segment max, and its gradient: `_SegmentAmax`); out-of-range
    ids are dropped."""
    ids = segment_ids.long()
    ids = torch.where((ids >= 0) & (ids < num_segments), ids, num_segments)
    ids = ids.reshape((-1,) + (1,) * (data.ndim - 1)).expand_as(data)
    return _SegmentAmax.apply(data, ids.contiguous(),
                              num_segments + 1)[:num_segments]


def segment_max(data: torch.Tensor, segment_ids: torch.Tensor,
                num_segments: int, empty_value: float = 0.0) -> torch.Tensor:
    """Each segment's max of its rows; `empty_value` where it has none."""
    has = degree(segment_ids, num_segments) > 0
    if data.ndim > 1:
        has = has.reshape((-1,) + (1,) * (data.ndim - 1))
    return torch.where(has, _segment_amax(data, segment_ids, num_segments),
                       torch.full((), empty_value, dtype=data.dtype,
                                  device=data.device))


def segment_min(data: torch.Tensor, segment_ids: torch.Tensor,
                num_segments: int, empty_value: float = 0.0) -> torch.Tensor:
    """Each segment's min of its rows; `empty_value` where it has none."""
    return -segment_max(-data, segment_ids, num_segments, -empty_value)


def segment_softmax(logits: torch.Tensor, segment_ids: torch.Tensor,
                    num_segments: int, mask: Optional[torch.Tensor] = None
                    ) -> torch.Tensor:
    """Softmax of `logits` within each segment (graph attention), as the
    JAX package computes it: masked logits set to the type's lowest value
    and their exponentials to 0, the segment max (0 where it is not
    finite) subtracted, the sum held at least 1e-16."""
    m = None
    if mask is not None:
        m = mask if logits.ndim == 1 else mask[:, None]
        logits = torch.where(m, logits, torch.full(
            (), torch.finfo(logits.dtype).min, dtype=logits.dtype,
            device=logits.device))
    seg_max = _segment_amax(logits, segment_ids, num_segments)
    seg_max = torch.where(torch.isfinite(seg_max), seg_max,
                          torch.zeros((), dtype=seg_max.dtype,
                                      device=seg_max.device))
    expv = torch.exp(logits - take_clipped(seg_max, segment_ids))
    if m is not None:
        expv = torch.where(m, expv, torch.zeros((), dtype=expv.dtype,
                                                device=expv.device))
    seg_sum = segment_sum(expv, segment_ids, num_segments)
    return expv / take_clipped(seg_sum, segment_ids).clamp(min=1e-16)


class GatherRows(torch.autograd.Function):
    """``nodes[idx.clamp(0, N - 1)]``; the backward adds each row's
    cotangent into its node (`index_add_`), and drops those of ids outside
    [0, N) (padding edges), as XLA's scatter drops them."""

    @staticmethod
    def forward(ctx, nodes, idx):
        ctx.save_for_backward(idx)
        ctx.n = nodes.shape[0]
        return nodes[idx.clamp(0, nodes.shape[0] - 1).long()]

    @staticmethod
    def backward(ctx, ct):
        idx, = ctx.saved_tensors
        return segment_sum(ct, idx, ctx.n), None


def gather_rows(nodes: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """`nodes [N, D]` gathered at `idx [E]` (padding -> N) -> [E, D], the
    gradient summed back by `index_add_` (the segment path's gather: the
    JAX package's `jnp.take` on a batch without CSR arrays)."""
    return GatherRows.apply(nodes, idx)


class TakeRowsRecv(torch.autograd.Function):
    """``nodes[idx.clamp(0, N - 1)]`` for the batch's receivers `idx`
    (receiver-sorted, padding last); the backward sums each node's CSR range
    of the cotangent (`csr_segment_sum`: the CSR segment-sum kernel on the
    card), so no scatter runs.  Padding edges lie past ``row_ptr[N]``: their
    cotangent is dropped, as the JAX package's `take_rows` drops it."""

    @staticmethod
    def forward(ctx, nodes, idx, row_ptr):
        ctx.save_for_backward(row_ptr)
        return nodes[idx.clamp(0, nodes.shape[0] - 1).long()]

    @staticmethod
    def backward(ctx, ct):
        row_ptr, = ctx.saved_tensors
        return csr_segment_sum(ct.contiguous(), row_ptr), None, None


def take_rows_recv(nodes: torch.Tensor, receivers: torch.Tensor,
                   row_ptr: torch.Tensor) -> torch.Tensor:
    """`nodes [N, D]` gathered at the receiver-sorted `receivers [E]`
    (padding -> N) -> [E, D]; the gradient is the CSR segment sum over
    `row_ptr` (the JAX package's `take_rows(..., row_ptr, perm=None)`), in
    bf16 and float32 alike."""
    return TakeRowsRecv.apply(nodes, receivers, row_ptr)


class TakeRows(torch.autograd.Function):
    """``nodes[idx.clamp(0, N - 1)]`` for the batch's senders `idx`; the
    backward sums each node's sent rows through the CSC order
    (`snd_segment_sum`: the sender-keyed segment-sum kernel on the card),
    so no scatter runs.  Padding edges (sender N) lie past
    ``csc_row_ptr[N]``: their cotangent is dropped, as the JAX package's
    `take_rows` drops it (padding edges never reach the loss)."""

    @staticmethod
    def forward(ctx, nodes, idx, csc_row_ptr, csc_perm):
        ctx.save_for_backward(csc_row_ptr, csc_perm)
        return nodes[idx.clamp(0, nodes.shape[0] - 1).long()]

    @staticmethod
    def backward(ctx, ct):
        csc_row_ptr, csc_perm = ctx.saved_tensors
        return (snd_segment_sum(ct.contiguous(), csc_row_ptr, csc_perm),
                None, None, None)


def take_rows(nodes: torch.Tensor, senders: torch.Tensor,
              csc_row_ptr: torch.Tensor, csc_perm: torch.Tensor
              ) -> torch.Tensor:
    """`nodes [N, D]` gathered at `senders [E]` (padding -> N) -> [E, D];
    the gradient is the sender-keyed segment sum over `csc_row_ptr` /
    `csc_perm` (the batch's CSC arrays), in bf16 and float32 alike."""
    return TakeRows.apply(nodes, senders, csc_row_ptr, csc_perm)


class Regroup(torch.autograd.Function):
    """Node rows into their [G, nmax, D] dense graph slots (`idx2d`,
    padding -> N, zero rows); the backward is the inverse gather through
    `inv_flat` (node -> g * nmax + slot, padding -> G * nmax), so no
    scatter runs in either direction (the JAX package's `_regroup`)."""

    @staticmethod
    def forward(ctx, node_feat, idx2d, inv_flat):
        ctx.save_for_backward(inv_flat)
        n = node_feat.shape[0]
        dense = node_feat[idx2d.clamp(0, n - 1).long()]
        return torch.where((idx2d < n)[..., None], dense,
                           torch.zeros((), dtype=dense.dtype,
                                       device=dense.device))

    @staticmethod
    def backward(ctx, ct):
        inv_flat, = ctx.saved_tensors
        G, nm, D = ct.shape
        flat = torch.cat([ct.reshape(G * nm, D), ct.new_zeros(1, D)])
        return flat[inv_flat.clamp(0, G * nm).long()], None, None


def graph_readout_dense(node_feat: torch.Tensor, idx2d: torch.Tensor,
                        inv_flat: torch.Tensor, aggregators: Sequence[str],
                        sizes: torch.Tensor) -> torch.Tensor:
    """Regroup node rows into [G, nmax, D] graph slots (`idx2d`, padding ->
    N; the gradient gathers back through `inv_flat`, see `Regroup`) and
    reduce each graph: concat of the `aggregators` in order, from sum /
    mean / max / min.  Empty graphs give 0."""
    mask = (idx2d < node_feat.shape[0])[..., None]             # [G, nmax, 1]
    dense = Regroup.apply(node_feat, idx2d, inv_flat)          # [G, nmax, D]
    sizes_f = sizes.to(node_feat.dtype)
    has = (sizes_f > 0)[:, None]
    zero = torch.zeros((), dtype=node_feat.dtype, device=node_feat.device)
    big = torch.finfo(node_feat.dtype).max
    outs = {}
    if "sum" in aggregators or "mean" in aggregators:
        s = dense.sum(dim=1)
        outs["sum"] = s
        outs["mean"] = torch.where(has, s / sizes_f.clamp(min=1.0)[:, None],
                                   zero)
    if "max" in aggregators:
        outs["max"] = torch.where(
            has, dense.masked_fill(~mask, -big).amax(dim=1), zero)
    if "min" in aggregators:
        outs["min"] = torch.where(
            has, dense.masked_fill(~mask, big).amin(dim=1), zero)
    for a in aggregators:
        if a not in outs:
            raise ValueError(f"unknown readout aggregator: {a}")
    return torch.cat([outs[a] for a in aggregators], dim=-1)


def _gathered_max(x: torch.Tensor, group) -> torch.Tensor:
    """The elementwise max over the ranks of `group` (differentiable: an
    all-gather, then the max, whose gradient routes to the winning rank's
    rows, as the JAX package's ``max(all_gather(...))``)."""
    return all_gather_rows(x[None], group).amax(dim=0)


def graph_readout(node_feat: torch.Tensor, node_graph: torch.Tensor,
                  num_graphs: int, aggregators: Sequence[str]
                  ) -> torch.Tensor:
    """The segment readout (the JAX package's `graph_readout` without the
    dense regroup): the concat of `aggregators` (sum / mean / max / min)
    of each graph's node rows (`node_graph`, padding -> G).  Empty graphs
    give 0.  Under a node-partition group (a node shard) the sums, the
    node counts and the extrema are completed over the group (an
    all-reduce; a gathered max) before any mean or mask."""
    group = node_partition_group()
    D = node_feat.shape[-1]
    sizes = degree(node_graph, num_graphs)
    if group is not None:
        sizes = all_reduce_sum(sizes, group)
    sizes_f = sizes.to(node_feat.dtype)
    has = (sizes_f > 0)[:, None]
    zero = torch.zeros((), dtype=node_feat.dtype, device=node_feat.device)
    outs = {}
    if "sum" in aggregators or "mean" in aggregators:
        s = segment_sum(node_feat, node_graph, num_graphs)
        if group is not None:
            s = all_reduce_sum(s, group)
        outs["sum"] = s
        outs["mean"] = torch.where(has, s / sizes_f.clamp(min=1.0)[:, None],
                                   zero)
    want = [a for a in ("max", "min") if a in aggregators]
    if want:
        # one shared max over [h, -h]; empty graphs hold -inf until masked
        both = _segment_amax(torch.cat(
            [node_feat if a == "max" else -node_feat for a in want],
            dim=-1), node_graph, num_graphs)
        if group is not None:
            both = _gathered_max(both, group)
        for j, a in enumerate(want):
            part = both[:, j * D:(j + 1) * D]
            outs[a] = torch.where(has, part if a == "max" else -part, zero)
    for a in aggregators:
        if a not in outs:
            raise ValueError(f"unknown readout aggregator: {a}")
    return torch.cat([outs[a] for a in aggregators], dim=-1)


def batch_readout(g, node_feat: torch.Tensor,
                  aggregators: Sequence[str]) -> torch.Tensor:
    """The readout of a `GraphBatch`: `graph_readout_dense`, sized by its
    `n_nodes`, where the batch carries the regroup (``nmax > 0``), else
    the segment readout `graph_readout` (as the JAX `batch_readout`)."""
    if g.rd_node_idx is not None:
        return graph_readout_dense(node_feat, g.rd_node_idx, g.rd_inv_flat,
                                   aggregators, g.n_nodes)
    return graph_readout(node_feat, g.node_graph, g.graph_mask.shape[0],
                         aggregators)
