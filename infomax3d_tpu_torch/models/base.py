"""Shared model blocks (port of `infomax3d_tpu/models/base.py`): activations,
masked BatchNorm, `FCLayer` / `MLP` with the JAX package's lazy BatchNorm
folds, the atom / bond encoders, `MLPReadout` and flax's `GRUCell`.

Module and attribute names follow the reference repository's state_dict
(`fully_connected.{i}.linear`, `batch_norm`, `atom_embedding_list.{i}`), so
`load_state_dict(strict=True)` takes its checkpoints and `interop.
params_from_jax` output alike.  BatchNorm normalizes with the batch
statistics of the rows its mask selects in training mode (and updates its
running statistics), and with the running statistics in eval mode.
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch
import torch.nn.functional as F
from torch import nn

from infomax3d_tpu_torch.data.synthetic import (FULL_ATOM_FEATURE_DIMS,
                                                FULL_BOND_FEATURE_DIMS)
from infomax3d_tpu_torch.models.noise import dropout as drop
from infomax3d_tpu_torch.ops.aggregate import AffinePart, combine_plain
from infomax3d_tpu_torch.ops.kernels import edge_combine
from infomax3d_tpu_torch.parallel.collectives import all_reduce_sum
from infomax3d_tpu_torch.parallel.context import step_group
from infomax3d_tpu_torch.train.remat import recomputing

ACTIVATIONS = {
    "relu": F.relu,
    "sigmoid": torch.sigmoid,
    "tanh": torch.tanh,
    "elu": F.elu,
    "selu": F.selu,
    "leakyrelu": lambda x: F.leaky_relu(x, negative_slope=0.01),
    "softplus": F.softplus,
    "silu": F.silu,
    "glu": lambda x: F.glu(x, dim=-1),
    "gelu": lambda x: F.gelu(x, approximate="tanh"),   # jax.nn.gelu default
    "none": lambda x: x,
}


def get_activation(act: str) -> Callable:
    if act.lower() not in ACTIVATIONS:
        raise ValueError(f"unsupported activation: {act}")
    return ACTIVATIONS[act.lower()]


def _stats_dtype(x: torch.Tensor) -> torch.dtype:
    """BatchNorm arithmetic: float32, or float64 for float64 inputs."""
    return torch.promote_types(x.dtype, torch.float32)


class MaskedBatchNorm(nn.Module):
    """BatchNorm over rows with padding rows excluded from the statistics
    (torch semantics, as the JAX package's `MaskedBatchNorm`).

    Training: mean and biased variance of the rows where `mask` is true
    normalize; the running statistics move to ``(1 - m) · running + m ·
    batch`` with the unbiased variance (count / (count - 1)), outside
    autograd.  Eval: the running statistics normalize.  ``y = (x - mean) ·
    rsqrt(var + eps) · weight + bias`` is computed in float32 (float64 for
    float64 inputs) and returned in x's dtype; the running statistics stay
    float32 under the bf16 recipe.  Under a data-parallel group
    (`parallel.context`) the count and the sums are all-reduced first, so
    the statistics, the unbiased correction and the running statistics are
    the global batch's; under a partition group too, over the step's
    ranks (data and graph), as the JAX package's psum over both axes: on
    an edge shard the node-space rows, replicated over the graph group,
    count k times (mean and variance unchanged, the unbiased correction's
    count k times larger, as in JAX).  The recompute of a `remat` forward
    (`train/remat.py`) leaves the running statistics where the first pass
    left them."""

    def __init__(self, num_features: int, momentum: float = 0.1,
                 eps: float = 1e-5):
        super().__init__()
        self.momentum = momentum
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))
        self.register_buffer("num_batches_tracked",
                             torch.tensor(0, dtype=torch.long))

    def _statistics(self, x: torch.Tensor, mask: Optional[torch.Tensor]):
        """(mean, var) that normalize x: the masked batch statistics in
        training (updating the running ones), else the running ones."""
        if not self.training:
            return self.running_mean, self.running_var
        xf = x.to(_stats_dtype(x))
        red = tuple(range(xf.ndim - 1))
        if mask is not None:
            m = mask.float()
            while m.ndim < xf.ndim:
                m = m[..., None]
            count = m.sum()
            s1 = (xf * m).sum(dim=red)
            s2 = (xf * xf * m).sum(dim=red)
        else:
            count = torch.tensor(float(x.numel() // x.shape[-1]),
                                 device=x.device)
            s1 = xf.sum(dim=red)
            s2 = (xf * xf).sum(dim=red)
        group = step_group()
        if group is not None:
            # data parallel (and graph partitions): statistics over the
            # global batch, one all-reduce of [count, s1, s2]
            both = all_reduce_sum(torch.cat(
                [count.to(s1.dtype).reshape(1), s1, s2]), group)
            count, s1, s2 = both[0], both[1:1 + s1.shape[0]], \
                both[1 + s1.shape[0]:]
        count = count.clamp(min=1.0)
        mean = s1 / count
        var = (s2 / count - mean * mean).clamp(min=0.0)
        if recomputing():
            return mean, var
        with torch.no_grad():
            mom = self.momentum
            unbiased = var * count / (count - 1.0).clamp(min=1.0)
            self.running_mean.copy_((1 - mom) * self.running_mean
                                    + mom * mean)
            self.running_var.copy_((1 - mom) * self.running_var
                                   + mom * unbiased)
            self.num_batches_tracked.add_(1)
        return mean, var

    def affine(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None):
        """(a, b), float32 [D], with ``BN(x) == x * a + b`` (the JAX
        package's ``affine_out``); in training both depend on x's batch
        statistics and carry their gradients back to x."""
        mean, var = self._statistics(x, mask)
        dt = _stats_dtype(x)
        a = self.weight.to(dt) * torch.rsqrt(var + self.eps)
        return a, self.bias.to(dt) - mean * a

    def forward(self, x: torch.Tensor,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        mean, var = self._statistics(x, mask)
        dt = _stats_dtype(x)
        y = (x.to(dt) - mean) * torch.rsqrt(var + self.eps)
        return (y * self.weight.to(dt) + self.bias.to(dt)).to(x.dtype)


class PromotingLinear(nn.Linear):
    """`nn.Linear` with flax `Dense`'s dtype promotion: the input, weight
    and bias are cast to their common type first, so a float32 input meets
    bf16 weights (the bf16 recipe) in float32 where PyTorch's `Linear`
    would refuse the mix.  Under `functional_call` the gradient reaches the
    float32 master through both casts."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = torch.promote_types(x.dtype, self.weight.dtype)
        bias = None if self.bias is None else self.bias.to(dt)
        return F.linear(x.to(dt), self.weight.to(dt), bias)


class EdgeInput(NamedTuple):
    """The message-MLP input ``[h[senders] ‖ h[receivers] ‖ e]`` of a PNA
    layer, never concatenated: `FCLayer` projects h in node space and the
    edge-combine kernel sums the gathered rows (`ops/kernels/
    edge_combine.py`); the CSR and CSC arrays carry its backward.  `e` may
    have width 0: the symmetrised distance nets' pair input ``[h[senders]
    ‖ h[receivers]]``.  With `swap` the input is ``[h[receivers] ‖
    h[senders] ‖ e]`` (the distance nets' other half): the first weight
    columns meet the receivers, the same index arrays serve.  `d` is PNA's
    `pairwise_distances` column [E, 1] (each edge's squared distance),
    the last weight columns' input, projected beside `e`.  Without
    `row_ptr` (a batch without CSR arrays) the gathers are plain
    (`ops/aggregate.py::combine_plain`); `halo` is a node shard's halo
    send lists, whose exchange extends the sender side."""
    h: torch.Tensor           # [N, Dh]
    senders: torch.Tensor     # [E] int32 (pad -> N)
    receivers: torch.Tensor   # [E] int32 (pad -> N)
    e: torch.Tensor           # [E, De]
    row_ptr: Optional[torch.Tensor] = None       # [N + 1] int32
    csc_row_ptr: Optional[torch.Tensor] = None   # [N + 1] int32
    csc_perm: Optional[torch.Tensor] = None      # [E] int32
    swap: bool = False
    d: Optional[torch.Tensor] = None             # [E, 1]
    halo: Optional[tuple] = None                 # [H_r] int32 per round


class PairGridInput(NamedTuple):
    """The Net3DDense message-MLP input ``[h_i ‖ h_j ‖ e_ij]`` on the dense
    [G, n, n] pair grid, never concatenated: `FCLayer` projects h in node
    space and broadcasts the sender (axis 1) and receiver (axis 2) blocks
    into the grid."""
    h: torch.Tensor           # [G, n, Dh]
    e: torch.Tensor           # [G, n, n, De]


def split_linear(linear: nn.Linear, parts) -> torch.Tensor:
    """``linear`` applied to the concatenation of `parts` along the last
    axis without forming it (the JAX `SplitDense`): each part times its
    block of weight columns, in their common type with the weight, the
    blocks summed in order (broadcasting), then the bias.  The pair grid's
    ``[h_i ‖ h_j ‖ e_ij]`` is ``(h[:, :, None], h[:, None], e)``."""
    w, off, y = linear.weight, 0, None
    for p in parts:
        dt = torch.promote_types(p.dtype, w.dtype)
        t = F.linear(p.to(dt), w[:, off:off + p.shape[-1]].to(dt))
        y = t if y is None else y + t
        off += p.shape[-1]
    return y + linear.bias.to(y.dtype)


class FCLayer(nn.Module):
    """Linear -> activation -> dropout -> BatchNorm (reference FCLayer
    order); the dropout masks come from the noise source `forward` is
    given (`models/noise.py`)."""

    def __init__(self, in_dim: int, out_dim: int, activation: str = "relu",
                 batch_norm: bool = False, batch_norm_momentum: float = 0.1,
                 dropout: float = 0.0):
        super().__init__()
        self.linear = nn.Linear(in_dim, out_dim)
        self.activation = get_activation(activation)
        self.dropout = dropout
        self.batch_norm = (MaskedBatchNorm(out_dim, batch_norm_momentum)
                           if batch_norm else None)

    def dense(self, x) -> torch.Tensor:
        w, bias = self.linear.weight, self.linear.bias
        if isinstance(x, EdgeInput):
            # weight columns: [0:Dh] sender, [Dh:2Dh] receiver, [2Dh:] edge
            # (all in their common type, as flax promotes: the flat Net3D's
            # "sum" aggregate makes h float32 under bf16 weights)
            dh, de = x.h.shape[1], 2 * x.h.shape[1] + x.e.shape[1]
            dt = torch.promote_types(torch.promote_types(x.h.dtype,
                                                         x.e.dtype), w.dtype)
            if x.d is not None:
                dt = torch.promote_types(dt, x.d.dtype)
            w, bias, h = w.to(dt), bias.to(dt), x.h.to(dt)
            first, second = F.linear(h, w[:, :dh]), F.linear(h, w[:, dh:2 * dh])
            hs, hd = (second, first) if x.swap else (first, second)
            if x.d is not None:
                # the JAX combine's pe: each plain part's projection summed
                # in order, then the bias
                pe = F.linear(x.e.to(dt), w[:, 2 * dh:de]) + F.linear(
                    x.d.to(dt), w[:, de:]) + bias
            elif x.e.shape[1]:
                pe = F.linear(x.e.to(dt), w[:, 2 * dh:], bias)
            else:
                pe = bias.expand(x.e.shape[0], -1).contiguous()
            if x.row_ptr is None:
                return combine_plain(hd, hs, pe, x.receivers, x.senders,
                                     x.halo)
            return edge_combine(hd, hs, pe, x.receivers, x.senders,
                                x.row_ptr, x.csc_row_ptr, x.csc_perm)
        if isinstance(x, PairGridInput):
            return split_linear(self.linear, (x.h[:, :, None], x.h[:, None],
                                              x.e))
        if isinstance(x, AffinePart):
            # fold the column affine into the weights:
            # (x * a + b) @ W^T == x @ (W * a)^T + W @ b
            wf = (w.float() * x.scale[None, :]).to(x.x.dtype)
            row = w.float() @ x.shift
            return (F.linear(x.x, wf).float() + row).to(x.x.dtype) + bias
        # flax Dense's promotion, as above
        dt = torch.promote_types(x.dtype, w.dtype)
        return F.linear(x.to(dt), w.to(dt), bias.to(dt))

    def forward(self, x, mask: Optional[torch.Tensor] = None,
                lazy_out: bool = False, noise=None):
        """`x`: a tensor, an `AffinePart` or an `EdgeInput`; `mask` selects
        the rows of the BatchNorm statistics.  With `lazy_out`, the
        BatchNorm comes back as an `AffinePart` for the consumer to fold.
        `noise` draws the dropout masks in training mode."""
        h = drop(self.activation(self.dense(x)), self.dropout, noise,
                 self.training)
        if self.batch_norm is None:
            return h
        if lazy_out:
            return AffinePart(h, *self.batch_norm.affine(h, mask))
        return self.batch_norm(h, mask)


class MLP(nn.Module):
    """Stack of FCLayers (reference MLP), each with the same `dropout`.
    Mid-layer BatchNorms fold into the next layer's weights; with
    `lazy_out` the last one is returned as an `AffinePart`."""

    def __init__(self, in_dim: int, out_dim: int, layers: int,
                 hidden_size: Optional[int] = None,
                 mid_activation: str = "relu", last_activation: str = "none",
                 mid_batch_norm: bool = False, last_batch_norm: bool = False,
                 batch_norm_momentum: float = 0.1, dropout: float = 0.0):
        super().__init__()
        hidden = hidden_size or out_dim
        dims = [in_dim] + [hidden] * (layers - 1) + [out_dim]
        n = len(dims) - 1
        self.fully_connected = nn.ModuleList(
            FCLayer(dims[j], dims[j + 1],
                    last_activation if j == n - 1 else mid_activation,
                    last_batch_norm if j == n - 1 else mid_batch_norm,
                    batch_norm_momentum=batch_norm_momentum, dropout=dropout)
            for j in range(n))

    def forward(self, x, mask: Optional[torch.Tensor] = None,
                lazy_out: bool = False, noise=None):
        for fc in self.fully_connected[:-1]:
            x = fc(x, mask, lazy_out=True, noise=noise)
        return self.fully_connected[-1](x, mask, lazy_out=lazy_out,
                                        noise=noise)


def _embedding_sum(tables: nn.ModuleList, codes: torch.Tensor) -> torch.Tensor:
    """Sum of one lookup per categorical column, codes clipped to each
    table's vocabulary; summed in float32 and rounded once.  The lookup
    reads a float32 view of the table, so its gradient accumulates in
    float32 (the JAX package's multi-hot matmul does the same)."""
    out = None
    for i, emb in enumerate(tables):
        idx = codes[:, i].long().clamp(0, emb.num_embeddings - 1)
        t = F.embedding(idx, emb.weight.float())
        out = t if out is None else out + t
    return out.to(tables[0].weight.dtype)


class _CategoricalEncoder(nn.Module):
    """Sum of one embedding table per categorical column, the tables in
    ``{kind}_embedding_list``.  The kind is the one the JAX package's
    `convert_state_dict` reads off the flax path: "atom" where a
    component of the encoder's path contains "atom", else "bond" (so
    PNAOriginal's ``embedding_h`` and SMP's ``emb`` hold atom codes in a
    ``bond_embedding_list``)."""

    def __init__(self, dims, emb_dim: int, kind: str):
        super().__init__()
        self.list_name = f"{kind}_embedding_list"
        self.add_module(self.list_name, nn.ModuleList(
            nn.Embedding(d, emb_dim) for d in dims))

    def forward(self, codes):
        return _embedding_sum(getattr(self, self.list_name), codes)


class AtomEncoder(_CategoricalEncoder):
    """Reference `commons/mol_encoder.py` AtomEncoder (9 OGB atom codes)."""

    def __init__(self, emb_dim: int, kind: str = "atom"):
        super().__init__(FULL_ATOM_FEATURE_DIMS, emb_dim, kind)


class BondEncoder(_CategoricalEncoder):
    """Reference `commons/mol_encoder.py` BondEncoder (3 OGB bond codes)."""

    def __init__(self, emb_dim: int):
        super().__init__(FULL_BOND_FEATURE_DIMS, emb_dim, "bond")


class MLPReadout(nn.Module):
    """The halving-width readout (reference `models/base_layers.py:
    149-164`, the JAX package's `MLPReadout`): `num_hidden` Linears of
    widths ``input_dim // 2 ** (l + 1)``, each followed by a ReLU, then the
    output Linear; no BatchNorm.  The Linears carry flax's auto names
    ``Dense_{l}`` and promote their input as flax `Dense` does."""

    def __init__(self, input_dim: int, output_dim: int, num_hidden: int = 2):
        super().__init__()
        dims = [input_dim] + [input_dim // 2 ** (l + 1)
                              for l in range(num_hidden)] + [output_dim]
        self.num_hidden = num_hidden
        for l in range(num_hidden + 1):
            self.add_module(f"Dense_{l}", PromotingLinear(dims[l],
                                                          dims[l + 1]))

    def forward(self, x):
        for l in range(self.num_hidden):
            x = F.relu(getattr(self, f"Dense_{l}")(x))
        return getattr(self, f"Dense_{self.num_hidden}")(x)


class GRUCell(nn.Module):
    """flax's `GRUCell` with its parameter layout: the input Denses
    ``ir``, ``iz``, ``in`` with biases, the hidden ones ``hr``, ``hz``
    without and ``hn`` with one (so `torch.nn.GRUCell`, whose hidden
    biases all train, is not it).  ``forward(h, x)`` takes the carry `h`
    and the input `x` and returns the new carry::

        r = sigmoid(ir(x) + hr(h)),  z = sigmoid(iz(x) + hz(h)),
        n = tanh(in(x) + r * hn(h)),  h' = (1 - z) * n + z * h."""

    def __init__(self, in_dim: int, features: int):
        super().__init__()
        for name in ("ir", "iz", "in"):
            self.add_module(name, PromotingLinear(in_dim, features))
        for name, bias in (("hr", False), ("hz", False), ("hn", True)):
            self.add_module(name, PromotingLinear(features, features,
                                                  bias=bias))

    def forward(self, h: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        gate = {n: getattr(self, n) for n in ("ir", "iz", "in", "hr", "hz",
                                              "hn")}
        r = torch.sigmoid(gate["ir"](x) + gate["hr"](h))
        z = torch.sigmoid(gate["iz"](x) + gate["hz"](h))
        n = torch.tanh(gate["in"](x) + r * gate["hn"](h))
        return (1.0 - z) * n + z * h
