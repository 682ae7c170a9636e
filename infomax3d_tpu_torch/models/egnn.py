"""EGNN, the E(n)-invariant 3D encoder on a CSR batch of complete graphs
(port of `infomax3d_tpu/models/egnn.py`: `EGCLayer`, `EGNN`; reference
models/egnn.py:13-140).

Each layer recomputes every edge's squared distance ``||x_s - x_r||²``
from the batch's coordinates (`GraphBatch.coords`), feeds the message MLP
``[h[s] ‖ h[r] ‖ d²]`` through `FCLayer`'s `EdgeInput` (the edge-combine
kernel forward, the pair segment sum backward, with an edge part of width
1), gates the messages by ``sigmoid(soft_edge_network(m))``, reduces them
at each receiver with `edge_aggregate` (the CSR sum kernel: "sum" or
"mean") and updates the nodes with a residual.  The input MLP reads the
batch's node features cast to float32 (the complete graph's atom codes;
its width is `node_dim`, which the JAX module infers from the data), then
SiLU; after the layers come the node-wise output MLP, `batch_readout` and
the readout MLP over the real graphs.  BatchNorms take the real edges'
or nodes' statistics.  Under the bf16 recipe the float32 node features
promote every product to float32, as they do in JAX.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from infomax3d_tpu_torch.models.base import MLP, EdgeInput, PromotingLinear
from infomax3d_tpu_torch.ops.aggregate import edge_aggregate
from infomax3d_tpu_torch.ops.segment import batch_readout


def squared_distances(g) -> torch.Tensor:
    """[E, 1] ``||coords[s] - coords[r]||²`` per edge, the indices clipped
    into range (padding edges read the last node)."""
    N = g.coords.shape[0]
    xs = g.coords[g.senders.long().clamp(0, N - 1)]
    xd = g.coords[g.receivers.long().clamp(0, N - 1)]
    return ((xs - xd) ** 2).sum(dim=-1, keepdim=True)


class EGCLayer(nn.Module):
    """One EGNN layer (the JAX `EGCLayer`)."""

    def __init__(self, hidden_dim: int, batch_norm: bool = False,
                 batch_norm_momentum: float = 0.1, dropout: float = 0.0,
                 mid_activation: str = "SiLU", reduce_func: str = "sum"):
        super().__init__()
        if reduce_func not in ("sum", "mean"):
            raise ValueError(f"reduce function not supported: {reduce_func}")
        self.reduce_func = reduce_func
        bn = dict(hidden_size=hidden_dim, mid_activation=mid_activation,
                  mid_batch_norm=batch_norm, last_batch_norm=batch_norm,
                  batch_norm_momentum=batch_norm_momentum, dropout=dropout)
        self.message_network = MLP(2 * hidden_dim + 1, hidden_dim, 2,
                                   last_activation=mid_activation, **bn)
        self.soft_edge_network = PromotingLinear(hidden_dim, 1)
        self.update_network = MLP(hidden_dim, hidden_dim, 2,
                                  last_activation="none", **bn)

    def forward(self, g, h: torch.Tensor, noise=None) -> torch.Tensor:
        msg = self.message_network(
            EdgeInput(h, g.senders, g.receivers, squared_distances(g),
                      g.csr_row_ptr, g.csc_row_ptr, g.csc_perm,
                      halo=g.halo_send),
            g.edge_mask, noise=noise)
        gated = msg * torch.sigmoid(self.soft_edge_network(msg))
        agg = edge_aggregate(g, gated, self.reduce_func)
        return self.update_network(agg + h, g.node_mask, noise=noise) + h


class EGNN(nn.Module):
    """The JAX `EGNN`; keyword arguments are its fields with its defaults
    (`edge_dim` and `fourier_encodings` are fields it never reads)."""

    FIELDS = ("node_dim", "hidden_dim", "target_dim", "readout_aggregators",
              "edge_dim", "batch_norm", "readout_batchnorm",
              "batch_norm_momentum", "reduce_func", "dropout",
              "propagation_depth", "readout_layers", "readout_hidden_dim",
              "fourier_encodings", "mid_activation")

    def __init__(self, node_dim: int, hidden_dim: int, target_dim: int,
                 readout_aggregators: Sequence[str], edge_dim: int = 0,
                 batch_norm: bool = False, readout_batchnorm: bool = True,
                 batch_norm_momentum: float = 0.1, reduce_func: str = "sum",
                 dropout: float = 0.0, propagation_depth: int = 4,
                 readout_layers: int = 2,
                 readout_hidden_dim: Optional[int] = None,
                 fourier_encodings: int = 0, mid_activation: str = "SiLU"):
        super().__init__()
        del edge_dim, fourier_encodings
        self.readout_aggregators = tuple(readout_aggregators)
        bn = dict(hidden_size=hidden_dim, mid_activation=mid_activation,
                  mid_batch_norm=batch_norm, last_batch_norm=batch_norm,
                  batch_norm_momentum=batch_norm_momentum, dropout=dropout)
        self.input = MLP(node_dim, hidden_dim, 1, last_activation="none",
                         **bn)
        self.mp_layers = nn.ModuleList(
            EGCLayer(hidden_dim, batch_norm, batch_norm_momentum, dropout,
                     mid_activation, reduce_func)
            for _ in range(propagation_depth))
        self.node_wise_output_network = MLP(hidden_dim, hidden_dim, 2,
                                            last_activation="none", **bn)
        self.output = MLP(hidden_dim * len(self.readout_aggregators),
                          target_dim, readout_layers,
                          hidden_size=readout_hidden_dim or hidden_dim,
                          mid_batch_norm=readout_batchnorm,
                          batch_norm_momentum=batch_norm_momentum)

    def forward(self, g, noise=None) -> torch.Tensor:
        h = F.silu(self.input(g.node_feat.float(), g.node_mask,
                              noise=noise))
        for layer in self.mp_layers:
            h = layer(g, h, noise)
        h = self.node_wise_output_network(h, g.node_mask, noise=noise)
        return self.output(batch_readout(g, h, self.readout_aggregators),
                           g.graph_mask, noise=noise)
