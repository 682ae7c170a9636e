"""Shared model blocks (port of `infomax3d_tpu/models/base.py`): activations,
eval-mode masked BatchNorm, `FCLayer` / `MLP` with the JAX package's lazy
BatchNorm folds, and the atom / bond encoders.

Module and attribute names follow the reference repository's state_dict
(`fully_connected.{i}.linear`, `batch_norm`, `atom_embedding_list.{i}`), so
`load_state_dict(strict=True)` takes its checkpoints and `interop.
params_from_jax` output alike.  BatchNorm here normalizes with the running
statistics only (serving); batch-statistics mode comes with training.
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch
import torch.nn.functional as F
from torch import nn

from infomax3d_tpu_torch.data.synthetic import (FULL_ATOM_FEATURE_DIMS,
                                                FULL_BOND_FEATURE_DIMS)
from infomax3d_tpu_torch.ops.aggregate import AffinePart
from infomax3d_tpu_torch.ops.kernels import edge_combine

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


class MaskedBatchNorm(nn.Module):
    """BatchNorm over rows, in eval mode: ``y = (x - running_mean) /
    sqrt(running_var + eps) * weight + bias`` computed in float32 and
    returned in x's dtype.  The running statistics stay float32 under the
    bf16 recipe.  `momentum` is kept for the training slice (batch
    statistics, padding rows excluded), which this module does not run."""

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

    def _require_eval(self):
        if self.training:
            raise NotImplementedError(
                "MaskedBatchNorm runs in eval mode (running statistics) "
                "only; call .eval() — batch statistics come with training")

    def affine(self):
        """(a, b), float32 [D], with ``BN(x) == x * a + b``."""
        self._require_eval()
        a = self.weight.float() * torch.rsqrt(self.running_var + self.eps)
        return a, self.bias.float() - self.running_mean * a

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        self._require_eval()
        y = (x.float() - self.running_mean) * torch.rsqrt(
            self.running_var + self.eps)
        return (y * self.weight.float() + self.bias.float()).to(x.dtype)


class EdgeInput(NamedTuple):
    """The message-MLP input ``[h[senders] ‖ h[receivers] ‖ e]`` of a PNA
    layer, never concatenated: `FCLayer` projects h in node space and the
    edge-combine kernel sums the gathered rows (`ops/kernels/
    edge_combine.py`)."""
    h: torch.Tensor           # [N, Dh]
    senders: torch.Tensor     # [E] int32 (pad -> N)
    receivers: torch.Tensor   # [E] int32 (pad -> N)
    e: torch.Tensor           # [E, De]


class FCLayer(nn.Module):
    """Linear -> activation -> BatchNorm (reference FCLayer order).  Dropout
    is the identity in eval mode and is not applied."""

    def __init__(self, in_dim: int, out_dim: int, activation: str = "relu",
                 batch_norm: bool = False, batch_norm_momentum: float = 0.1):
        super().__init__()
        self.linear = nn.Linear(in_dim, out_dim)
        self.activation = get_activation(activation)
        self.batch_norm = (MaskedBatchNorm(out_dim, batch_norm_momentum)
                           if batch_norm else None)

    def dense(self, x) -> torch.Tensor:
        w, bias = self.linear.weight, self.linear.bias
        if isinstance(x, EdgeInput):
            # weight columns: [0:Dh] sender, [Dh:2Dh] receiver, [2Dh:] edge
            dh = x.h.shape[1]
            hs = F.linear(x.h, w[:, :dh])
            hd = F.linear(x.h, w[:, dh:2 * dh])
            pe = F.linear(x.e, w[:, 2 * dh:], bias)
            return edge_combine(hd, hs, pe, x.receivers, x.senders)
        if isinstance(x, AffinePart):
            # fold the column affine into the weights:
            # (x * a + b) @ W^T == x @ (W * a)^T + W @ b
            wf = (w.float() * x.scale[None, :]).to(x.x.dtype)
            row = w.float() @ x.shift
            return (F.linear(x.x, wf).float() + row).to(x.x.dtype) + bias
        return F.linear(x, w, bias)

    def forward(self, x, lazy_out: bool = False):
        """`x`: a tensor, an `AffinePart` or an `EdgeInput`.  With
        `lazy_out`, the BatchNorm comes back as an `AffinePart` for the
        consumer to fold."""
        h = self.activation(self.dense(x))
        if self.batch_norm is None:
            return h
        if lazy_out:
            return AffinePart(h, *self.batch_norm.affine())
        return self.batch_norm(h)


class MLP(nn.Module):
    """Stack of FCLayers (reference MLP).  Mid-layer BatchNorms fold into
    the next layer's weights; with `lazy_out` the last one is returned as
    an `AffinePart`."""

    def __init__(self, in_dim: int, out_dim: int, layers: int,
                 hidden_size: Optional[int] = None,
                 mid_activation: str = "relu", last_activation: str = "none",
                 mid_batch_norm: bool = False, last_batch_norm: bool = False,
                 batch_norm_momentum: float = 0.1):
        super().__init__()
        hidden = hidden_size or out_dim
        dims = [in_dim] + [hidden] * (layers - 1) + [out_dim]
        n = len(dims) - 1
        self.fully_connected = nn.ModuleList(
            FCLayer(dims[j], dims[j + 1],
                    last_activation if j == n - 1 else mid_activation,
                    last_batch_norm if j == n - 1 else mid_batch_norm,
                    batch_norm_momentum=batch_norm_momentum)
            for j in range(n))

    def forward(self, x, lazy_out: bool = False):
        for fc in self.fully_connected[:-1]:
            x = fc(x, lazy_out=True)
        return self.fully_connected[-1](x, lazy_out=lazy_out)


def _embedding_sum(tables: nn.ModuleList, codes: torch.Tensor) -> torch.Tensor:
    """Sum of one lookup per categorical column, codes clipped to each
    table's vocabulary; summed in float32 and rounded once."""
    out = None
    for i, emb in enumerate(tables):
        idx = codes[:, i].long().clamp(0, emb.num_embeddings - 1)
        t = emb.weight[idx].float()
        out = t if out is None else out + t
    return out.to(tables[0].weight.dtype)


class AtomEncoder(nn.Module):
    """Reference `commons/mol_encoder.py` AtomEncoder (9 OGB atom codes)."""

    def __init__(self, emb_dim: int):
        super().__init__()
        self.atom_embedding_list = nn.ModuleList(
            nn.Embedding(d, emb_dim) for d in FULL_ATOM_FEATURE_DIMS)

    def forward(self, codes):
        return _embedding_sum(self.atom_embedding_list, codes)


class BondEncoder(nn.Module):
    """Reference `commons/mol_encoder.py` BondEncoder (3 OGB bond codes)."""

    def __init__(self, emb_dim: int):
        super().__init__()
        self.bond_embedding_list = nn.ModuleList(
            nn.Embedding(d, emb_dim) for d in FULL_BOND_FEATURE_DIMS)

    def forward(self, codes):
        return _embedding_sum(self.bond_embedding_list, codes)
