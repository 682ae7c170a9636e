"""The dense padded EGNN (port of `infomax3d_tpu/models/egnn_dense.py`:
`DenseEGCL`, `DenseEGNN`, registered as "EGNNTorch"; reference
models/egnn_torch.py:7-207), on `egnn_padded_collate`'s dense batch.

Each molecule is one row of [G, n] node slots; every pair of real,
distinct atoms is an edge.  A layer forms the messages
``act(edge_mlp_2(act(edge_mlp_1([h_i ‖ h_j ‖ |x_i - x_j|²]))))`` on the
[G, n, n] grid (``edge_mlp_1``'s node blocks projected in node space and
broadcast, as the JAX `SplitDense` does), optionally gated by
``att_mlp``, sums them over j, moves the coordinates by ``Σ_j (x_i - x_j)
· coord_mlp_out(act(coord_mlp_1(m_ij)))`` and updates the nodes with
``node_mlp_2(act(node_mlp_1([h ‖ agg])))`` and a residual.  The graphs are
sum-pooled over their real atoms and decoded by ``node_dec`` and
``graph_dec``.  No Pallas kernel runs here in JAX, and plain PyTorch is
its port.  The input width is `in_node_nf`.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from infomax3d_tpu_torch.models.base import PromotingLinear, split_linear

_ACT = {"silu": F.silu, "relu": F.relu}


class DenseEGCL(nn.Module):
    """One E_GCL layer (reference egnn_torch.py:7-120) on dense
    [G, n, ...] tensors."""

    def __init__(self, in_dim: int, hidden_dim: int, act: str = "silu",
                 residual: bool = True, attention: bool = False,
                 coords_weight: float = 1.0):
        super().__init__()
        self.act = _ACT[act]
        self.residual, self.coords_weight = residual, coords_weight
        self.edge_mlp_1 = PromotingLinear(2 * in_dim + 1, hidden_dim)
        self.edge_mlp_2 = PromotingLinear(hidden_dim, hidden_dim)
        self.att_mlp = PromotingLinear(hidden_dim, 1) if attention else None
        self.coord_mlp_1 = PromotingLinear(hidden_dim, hidden_dim)
        self.coord_mlp_out = PromotingLinear(hidden_dim, 1, bias=False)
        self.node_mlp_1 = PromotingLinear(in_dim + hidden_dim, hidden_dim)
        self.node_mlp_2 = PromotingLinear(hidden_dim, hidden_dim)

    def forward(self, h, x, pair):
        diff = x[:, :, None, :] - x[:, None, :, :]              # [G, n, n, 3]
        radial = (diff ** 2).sum(dim=-1, keepdim=True)
        m = self.act(split_linear(self.edge_mlp_1, (
            h[:, :, None, :], h[:, None, :, :], radial)))
        m = self.act(self.edge_mlp_2(m))
        if self.att_mlp is not None:
            m = m * torch.sigmoid(self.att_mlp(m))
        zero = torch.zeros((), dtype=m.dtype, device=m.device)
        m = torch.where(pair[..., None], m, zero)
        agg = m.sum(dim=2)                                       # [G, n, D]
        trans = diff * self.coord_mlp_out(self.act(self.coord_mlp_1(m)))
        trans = torch.where(pair[..., None], trans,
                            torch.zeros((), dtype=trans.dtype,
                                        device=trans.device))
        x = x + trans.sum(dim=2) * self.coords_weight
        out = self.node_mlp_2(self.act(split_linear(self.node_mlp_1,
                                                    (h, agg))))
        return (h + out if self.residual else out), x


class DenseEGNN(nn.Module):
    """The JAX `DenseEGNN` (reference egnn_torch.py:124-187); keyword
    arguments are its fields with its defaults (`node_attr` is one it never
    reads)."""

    FIELDS = ("in_node_nf", "hidden_dim", "target_dim", "n_layers", "act",
              "residual", "attention", "coords_weight", "node_attr")

    def __init__(self, in_node_nf: int, hidden_dim: int, target_dim: int,
                 n_layers: int = 4, act: str = "silu", residual: bool = True,
                 attention: bool = False, coords_weight: float = 1.0,
                 node_attr: bool = False):
        super().__init__()
        del node_attr
        self.embedding = PromotingLinear(in_node_nf, hidden_dim)
        for i in range(n_layers):
            self.add_module(f"gcl_{i}", DenseEGCL(
                hidden_dim, hidden_dim, act, residual, attention,
                coords_weight))
        self.n_layers = n_layers
        self.node_dec = PromotingLinear(hidden_dim, hidden_dim)
        self.graph_dec = PromotingLinear(hidden_dim, target_dim)

    def forward(self, g, noise=None) -> torch.Tensor:
        n = g.node_mask.shape[1]
        h = self.embedding(g.node_feat.float())
        x = g.coords
        eye = torch.eye(n, dtype=torch.bool, device=g.node_mask.device)
        pair = g.node_mask[:, :, None] & g.node_mask[:, None, :] & ~eye
        for i in range(self.n_layers):
            h, x = getattr(self, f"gcl_{i}")(h, x, pair)
        h = torch.where(g.node_mask[..., None], h,
                        torch.zeros((), dtype=h.dtype, device=h.device))
        return self.graph_dec(F.silu(self.node_dec(h.sum(dim=1))))
