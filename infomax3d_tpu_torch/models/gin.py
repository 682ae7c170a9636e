"""OGB GNN baseline: GIN convolutions without a virtual node (port of
`infomax3d_tpu/models/gin.py`: `GINConv`, `GNNNode`, `OGBGNN`) on CSR
batches, in training mode (masked batch statistics) and in eval mode.

Per layer: messages ``relu(h[senders] + bond_emb)`` (the sender gather,
whose backward is the sender-keyed segment-sum kernel), their float32 sum
at each receiver (the CSR-sum kernel), ``(1 + eps) * h + agg`` and the MLP
``Linear -> BatchNorm -> relu -> Linear``; then the layer's BatchNorm and a
relu on all but the last layer.  The model reads out the last layer ("last"
jumping knowledge) per graph and applies `graph_pred_linear`.

The dtype flow is the JAX package's: under the bf16 recipe the CSR sum
returns float32, so ``(1 + eps) * h + agg`` is float32 and every `Linear`
promotes its bf16 weights to float32 (`PromotingLinear`, as flax `Dense`
does); only the atom and bond encoders and layer 0's messages stay bf16.
"""
from __future__ import annotations

from typing import Any, Mapping

import torch
import torch.nn.functional as F
from torch import nn

from infomax3d_tpu_torch.models.base import (AtomEncoder, BondEncoder,
                                             MaskedBatchNorm,
                                             PromotingLinear)
from infomax3d_tpu_torch.ops.aggregate import edge_aggregate, gather_src
from infomax3d_tpu_torch.ops.segment import batch_readout


class GINConv(nn.Module):
    """GIN convolution (reference `models/gin.py:85-110`): `mlp` is the
    reference's ``Sequential(Linear, BatchNorm1d, ReLU, Linear)``, called
    step by step so the BatchNorm gets the node mask."""

    def __init__(self, hidden_dim: int, batch_norm_momentum: float = 0.1):
        super().__init__()
        self.bond_encoder = BondEncoder(hidden_dim)
        self.eps = nn.Parameter(torch.zeros(1))
        self.mlp = nn.ModuleList([
            PromotingLinear(hidden_dim, hidden_dim),
            MaskedBatchNorm(hidden_dim, batch_norm_momentum), nn.ReLU(),
            PromotingLinear(hidden_dim, hidden_dim)])

    def forward(self, g, h: torch.Tensor) -> torch.Tensor:
        emb = self.bond_encoder(g.edge_feat)
        msg = F.relu(gather_src(g, h) + emb)
        z = (1.0 + self.eps) * h + edge_aggregate(g, msg, "sum")
        lin0, bn, relu, lin1 = self.mlp
        return lin1(relu(bn(lin0(z), g.node_mask)))


class GNNNode(nn.Module):
    """Atom embedding + stack of GINConvs, each followed by its BatchNorm
    and (but the last) a relu; "last" jumping knowledge (reference
    `models/gin.py:146-210`, no dropout, no residual)."""

    def __init__(self, num_layers: int, hidden_dim: int,
                 batch_norm_momentum: float = 0.1):
        super().__init__()
        self.atom_encoder = AtomEncoder(hidden_dim)
        self.convs = nn.ModuleList(
            GINConv(hidden_dim, batch_norm_momentum)
            for _ in range(num_layers))
        self.batch_norms = nn.ModuleList(
            MaskedBatchNorm(hidden_dim, batch_norm_momentum)
            for _ in range(num_layers))

    def forward(self, g) -> torch.Tensor:
        h = self.atom_encoder(g.node_feat)
        last = len(self.convs) - 1
        for i, (conv, bn) in enumerate(zip(self.convs, self.batch_norms)):
            h = bn(conv(g, h), g.node_mask)
            if i != last:
                h = F.relu(h)
        return h


class OGBGNN(nn.Module):
    """Reference OGBGNN (`models/gin.py:17-81`): GIN node stack, graph
    pooling, `graph_pred_linear`.  Keyword arguments are the JAX module's
    fields with its defaults.  What the port does not have yet raises:
    a virtual node, GCN convolutions, dropout, residual connections,
    jumping knowledge other than "last", pooling other than sum / mean /
    max."""

    def __init__(self, target_dim: int = 1, num_layers: int = 5,
                 hidden_dim: int = 300, gnn_type: str = "gin",
                 virtual_node: bool = True, residual: bool = False,
                 dropout: float = 0.0, JK: str = "last",
                 graph_pooling: str = "sum",
                 batch_norm_momentum: float = 0.1):
        super().__init__()
        unsupported = {"virtual_node": virtual_node,
                       "gnn_type": gnn_type != "gin" and gnn_type,
                       "dropout": dropout > 0 and dropout,
                       "residual": residual, "JK": JK != "last" and JK,
                       "graph_pooling": graph_pooling not in (
                           "sum", "mean", "max") and graph_pooling}
        bad = {k: v for k, v in unsupported.items() if v}
        if bad:
            raise NotImplementedError(f"OGBGNN options not ported: {bad}")
        self.graph_pooling = graph_pooling
        self.node_gnn = GNNNode(num_layers, hidden_dim, batch_norm_momentum)
        self.graph_pred_linear = PromotingLinear(hidden_dim, target_dim)

    # the JAX module's fields: other keys of a config are dropped, as the
    # JAX package's `_adapt_model_params` drops them (e.g. `emb_dim`)
    FIELDS = ("target_dim", "num_layers", "hidden_dim", "gnn_type",
              "virtual_node", "residual", "dropout", "JK", "graph_pooling",
              "batch_norm_momentum")

    @classmethod
    def from_config(cls, model_parameters: Mapping[str, Any]) -> "OGBGNN":
        return cls(**{k: v for k, v in model_parameters.items()
                      if k in cls.FIELDS})

    def forward(self, g) -> torch.Tensor:
        h = self.node_gnn(g)
        return self.graph_pred_linear(
            batch_readout(g, h, [self.graph_pooling]))
