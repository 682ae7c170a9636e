"""Collectives of the data-parallel step with the JAX package's transposes
(port of `infomax3d_tpu/parallel/collectives.py` and of the `psum` /
`all_gather` / `pmean` calls of its shard_map step).

`NTXent` and friends need the GLOBAL batch in the denominator; under data
parallelism each rank holds a shard of the embeddings, so `CrossDeviceLoss`
all-gathers both views and evaluates the wrapped loss on the global batch:
the same value on every rank.

The two autograd Functions differentiate the per-rank SUM of the ranks'
losses, as JAX's collective transposes do:

* `all_gather_rows`: rows of every rank, in rank order; its backward sums
  the cotangents of the ranks for this rank's rows (all-reduce the whole
  cotangent, then take this rank's slice: the transpose of JAX's tiled
  `all_gather`);
* `all_reduce_sum`: the sum over ranks; its backward is the sum over ranks
  of the cotangents (the transpose of `psum`).

With every rank's loss equal, each rank's gradient is then k times its
share of d(loss)/d(params), and the mean over ranks (`mean_over_ranks`, one
all-reduce of the flat gradients) is exactly d(loss)/d(params).

Tensor parallelism (`parallel/tp.py`) adds `gather_shards`: the whole
leaves from the model ranks' column shards, one flat all-gather per dtype.
Its backward is NOT `all_gather_rows`': every model rank of a data shard
runs the same forward on the same batch, so the cotangent of a whole leaf
is already the same on each of them, and its backward takes this rank's
slice of it with no collective.  Summing over the model ranks there, as
the data-parallel transpose does, would count the loss k times.

Under gloo a CUDA tensor goes through a host copy for the collective (the
two ranks of one card in `chip_smoke.py`); NCCL reduces on the card.  The
port does not use `torch.distributed.nn.functional`.
"""
from __future__ import annotations

from typing import Callable, List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist


def _host_staged(group, t: torch.Tensor) -> bool:
    return t.is_cuda and dist.get_backend(group) == "gloo"


def all_reduce_(t: torch.Tensor, group) -> torch.Tensor:
    """Sum `t` over the ranks of `group`, in place (no autograd)."""
    if _host_staged(group, t):
        h = t.cpu()
        dist.all_reduce(h, group=group)
        t.copy_(h)
    else:
        dist.all_reduce(t, group=group)
    return t


def gather_rows(t: torch.Tensor, group) -> torch.Tensor:
    """Every rank's `t` concatenated along dim 0 in rank order (no
    autograd); every rank's `t` has the same shape."""
    src = t.detach().contiguous()
    if _host_staged(group, src):
        src = src.cpu()
    parts = [torch.empty_like(src)
             for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, src, group=group)
    return torch.cat(parts, dim=0).to(t.device)


def broadcast_(t: torch.Tensor, group, src: int = 0) -> torch.Tensor:
    """Overwrite `t` with group rank `src`'s `t`, in place (no autograd)."""
    root = dist.get_global_rank(group, src)
    with torch.no_grad():
        if _host_staged(group, t):
            h = t.detach().cpu()
            dist.broadcast(h, root, group=group)
            t.copy_(h)
        else:
            dist.broadcast(t.data, root, group=group)
    return t


def gather_host(a, group, blocks: int = 1):
    """Every rank's host array `a` (any number of rows) concatenated along
    axis 0 in rank order; with `blocks` = p, `a` is p equal blocks of rows
    and each block is gathered over the ranks in turn."""
    parts = [None] * dist.get_world_size(group)
    dist.all_gather_object(parts, a, group=group)
    if blocks == 1:
        return np.concatenate(parts, axis=0)
    split = [np.split(p, blocks, axis=0) for p in parts]
    return np.concatenate([s[b] for b in range(blocks) for s in split],
                          axis=0)


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_reduce_(x.detach().clone(), group)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_(g.contiguous().clone(), ctx.group), None


class _AllGatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        ctx.rows = slice(dist.get_rank(group) * x.shape[0],
                         (dist.get_rank(group) + 1) * x.shape[0])
        return gather_rows(x, group)

    @staticmethod
    def backward(ctx, g):
        g = all_reduce_(g.contiguous().clone(), ctx.group)
        return g[ctx.rows], None


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of `x` over the ranks (differentiable: `psum`)."""
    return _AllReduceSum.apply(x, group)


def all_gather_rows(x: torch.Tensor, group) -> torch.Tensor:
    """Every rank's rows of `x`, in rank order (differentiable: tiled
    `all_gather`)."""
    return _AllGatherRows.apply(x, group)


def mean_over_ranks(tensors: Sequence[torch.Tensor], group
                    ) -> List[torch.Tensor]:
    """The mean over ranks of each of `tensors`, written back in place:
    one all-reduce per dtype of their concatenation (`pmean`)."""
    world = dist.get_world_size(group)
    by_dtype = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    for ts in by_dtype.values():
        flat = torch.cat([t.reshape(-1) for t in ts])
        all_reduce_(flat, group).div_(world)
        for t, v in zip(ts, flat.split([t.numel() for t in ts])):
            t.copy_(v.view_as(t))
    return list(tensors)


def _gather_flat(flat: torch.Tensor, group) -> torch.Tensor:
    """[k, n]: every rank's 1D `flat` in group-rank order, moved as bytes
    (any float dtype, on either backend), one all-gather."""
    k = dist.get_world_size(group)
    src = flat.contiguous().view(torch.uint8)
    if _host_staged(group, src):
        src = src.cpu()
    out = torch.empty((k, src.numel()), dtype=torch.uint8, device=src.device)
    dist.all_gather(list(out.unbind(0)), src, group=group)
    return out.to(flat.device).view(flat.dtype)


def _whole(parts: torch.Tensor, shape, dim: int) -> torch.Tensor:
    """[k, *shape] shards in rank order -> one tensor concatenated along
    `dim`."""
    k = parts.shape[0]
    full = list(shape)
    full[dim] *= k
    return parts.movedim(0, dim).reshape(full)


def gather_leaves(shards: Sequence[torch.Tensor], dims: Sequence[int],
                  group) -> List[torch.Tensor]:
    """Each of `shards` whole: the model ranks' shards concatenated along
    its dim in group-rank order (no autograd); one flat all-gather per
    dtype."""
    out: List[Optional[torch.Tensor]] = [None] * len(shards)
    by_dtype = {}
    for i, t in enumerate(shards):
        by_dtype.setdefault(t.dtype, []).append(i)
    for idx in by_dtype.values():
        flat = torch.cat([shards[i].detach().reshape(-1) for i in idx])
        parts = _gather_flat(flat, group)
        sizes = [shards[i].numel() for i in idx]
        for i, p in zip(idx, parts.split(sizes, dim=1)):
            out[i] = _whole(p.reshape((parts.shape[0],)
                                      + tuple(shards[i].shape)),
                            shards[i].shape, dims[i])
    return out


class _GatherShards(torch.autograd.Function):
    @staticmethod
    def forward(ctx, group, dims, *shards):
        ctx.group, ctx.dims = group, dims
        ctx.k, ctx.index = dist.get_world_size(group), dist.get_rank(group)
        return tuple(gather_leaves(shards, dims, group))

    @staticmethod
    def backward(ctx, *cts):
        # every model rank holds the same whole cotangent: its slice, no
        # collective
        return (None, None) + tuple(
            None if ct is None else
            ct.chunk(ctx.k, d)[ctx.index].contiguous()
            for ct, d in zip(cts, ctx.dims))


def gather_shards(shards: Sequence[torch.Tensor], dims: Sequence[int],
                  group) -> List[torch.Tensor]:
    """The whole leaves of the model ranks' `shards` (each cut along its
    entry of `dims`), differentiable: the backward takes this rank's slice
    of each cotangent (module docstring)."""
    return list(_GatherShards.apply(group, tuple(dims), *shards))


def broadcast_flat_(tensors: Sequence[torch.Tensor], group, src: int = 0
                    ) -> None:
    """Overwrite each of `tensors` with group rank `src`'s, in place: one
    broadcast per dtype of their concatenation (no autograd)."""
    by_dtype = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    for ts in by_dtype.values():
        flat = torch.cat([t.reshape(-1) for t in ts])
        broadcast_(flat, group, src)
        for t, v in zip(ts, flat.split([t.numel() for t in ts])):
            t.copy_(v.view_as(t))


# the row-aligned keywords gathered with z1 and z2: the Local losses' node
# mask, the autoencoder loss's distances, predictions and pair mask
ROW_KEYWORDS = ("node_mask", "distances", "distance_pred", "mask")


class CrossDeviceLoss:
    """The wrapped loss on the rows of every rank: z1 and z2 all-gathered;
    for the node-level ("Local") losses `node_graph` (offset by the rank
    times `n_graphs_local`, so graph ids stay globally unique) and the
    `ROW_KEYWORDS` too.  `z2_blocks` = p gathers z2 as p equal blocks,
    each over the ranks, so the global z2 keeps its blocks in order (the
    noisy negatives' [z2; z_noisy]).  Other keywords reach the loss as
    they are (local).

    The JAX package's `CrossDeviceLoss` passes the autoencoder loss's
    distances, predictions and mask ungathered, so its reconstruction
    term is each shard's own and the step's loss the mean of those over
    the shards; gathering them here keeps the step equal to one process's
    on the concatenated batch."""

    def __init__(self, loss: Callable, group):
        self.loss = loss
        self.group = group

    def __getattr__(self, item):
        if item in ("loss", "group"):
            raise AttributeError(item)
        return getattr(self.loss, item)

    def __call__(self, z1, z2, *, z2_blocks: int = 1,
                 n_graphs_local: Optional[int] = None, **kw):
        group = self.group
        z1g = all_gather_rows(z1, group)
        z2g = torch.cat([all_gather_rows(p, group)
                         for p in z2.chunk(z2_blocks, dim=0)], dim=0) \
            if z2_blocks > 1 else all_gather_rows(z2, group)
        gathered = {}
        for k, v in kw.items():
            if k == "node_graph":
                if n_graphs_local:
                    v = v + dist.get_rank(group) * int(n_graphs_local)
                gathered[k] = gather_rows(v, group)
            elif k in ROW_KEYWORDS and v is not None:
                gathered[k] = all_gather_rows(v, group) \
                    if v.requires_grad else gather_rows(v, group)
            else:
                gathered[k] = v
        return self.loss(z1g, z2g, **gathered)
