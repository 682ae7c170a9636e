"""Graph readout (port of `infomax3d_tpu/ops/segment.py`, the dense-regroup
path `_regroup` / `_graph_readout_dense` / `batch_readout`)."""
from __future__ import annotations

from typing import Sequence

import torch

EPS = 1e-5  # reference models/pna.py:14


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


def batch_readout(g, node_feat: torch.Tensor,
                  aggregators: Sequence[str]) -> torch.Tensor:
    """`graph_readout_dense` over a `GraphBatch`, sized by its `n_nodes`."""
    return graph_readout_dense(node_feat, g.rd_node_idx, g.rd_inv_flat,
                               aggregators, g.n_nodes)
