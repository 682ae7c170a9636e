"""PNA — Principal Neighbourhood Aggregation 2D encoder (port of
`infomax3d_tpu/models/pna.py`) on CSR batches, in training mode (batch
statistics, masked to real edges / nodes / graphs) and in eval mode.

Per layer: the pretrans MLP on ``[h[src] ‖ h[dst] ‖ e]`` (its first layer
through the edge-combine kernel, its BatchNorms folded), the PNA
aggregators and degree scalers at each receiver (the stats or multi-reduce
kernel, `ops/aggregate.py`), the posttrans MLP on ``[h ‖ aggregates]``, and
the residual.  With `pairwise_distances` each edge's squared distance
(from the batch's `coords`, in their dtype) joins the pretrans input as
a last column, projected beside the edge features into the edge-combine
kernel's per-edge part.  Both MLPs run their dropout (Linear -> activation ->
dropout -> BatchNorm, the masks over every edge or node row, padding
included, from the noise source the forward is given): in the pretrans
MLP a mask falls between the edge-combine kernel's output and the
BatchNorm affine that the stats kernel folds in, so the kernels' backward
runs on the masked cotangent.  The model reads out min / max / mean per
graph and applies the output MLP.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from infomax3d_tpu_torch.models.base import (MLP, AtomEncoder, BondEncoder,
                                             EdgeInput)
from infomax3d_tpu_torch.ops.aggregate import pna_aggregate_parts
from infomax3d_tpu_torch.ops.segment import batch_readout, take_clipped


class PNALayer(nn.Module):
    """One PNA message-passing layer (reference `models/pna.py:169-252`)."""

    def __init__(self, in_dim: int, out_dim: int, in_dim_edges: int,
                 aggregators: Sequence[str], scalers: Sequence[str],
                 activation: str = "relu", last_activation: str = "none",
                 residual: bool = True, mid_batch_norm: bool = False,
                 last_batch_norm: bool = False,
                 batch_norm_momentum: float = 0.1, avg_d_log: float = 1.0,
                 posttrans_layers: int = 2, pretrans_layers: int = 1,
                 dropout: float = 0.0, pairwise_distances: bool = False):
        super().__init__()
        self.aggregators = tuple(aggregators)
        self.scalers = tuple(scalers)
        self.avg_d_log = avg_d_log
        self.residual = residual and in_dim == out_dim
        self.pairwise_distances = pairwise_distances
        bn = dict(mid_batch_norm=mid_batch_norm,
                  last_batch_norm=last_batch_norm,
                  batch_norm_momentum=batch_norm_momentum,
                  mid_activation=activation, last_activation=last_activation,
                  dropout=dropout)
        self.pretrans = MLP(2 * in_dim + in_dim_edges + pairwise_distances,
                            in_dim,
                            pretrans_layers, hidden_size=in_dim, **bn)
        n_parts = len(self.aggregators) * len(self.scalers) + 1
        self.posttrans = MLP(n_parts * in_dim, out_dim, posttrans_layers,
                             hidden_size=out_dim, **bn)

    def forward(self, g, h: torch.Tensor, e: torch.Tensor,
                noise=None) -> torch.Tensor:
        # the pretrans last BatchNorm stays lazy: the stats kernel folds it
        d = None
        if self.pairwise_distances:
            diff = take_clipped(g.coords, g.senders) - take_clipped(
                g.coords, g.receivers)
            d = (diff ** 2).sum(dim=-1, keepdim=True)
        msg = self.pretrans(EdgeInput(h, g.senders, g.receivers, e,
                                      g.csr_row_ptr, g.csc_row_ptr,
                                      g.csc_perm, d=d, halo=g.halo_send),
                            g.edge_mask, lazy_out=True, noise=noise)
        parts = pna_aggregate_parts(g, msg, self.aggregators, self.scalers,
                                    self.avg_d_log)
        h_new = self.posttrans(torch.cat([h] + parts, dim=-1), g.node_mask,
                               noise=noise)
        return h_new + h if self.residual else h_new


class PNAGNN(nn.Module):
    """Atom / bond embedding + stack of PNALayers (reference
    `models/pna.py:138-166`; registered as ``PNAGNN``, whose output is the
    node embeddings [N, hidden_dim])."""

    FIELDS = ("hidden_dim", "aggregators", "scalers", "residual",
              "pairwise_distances", "activation", "last_activation",
              "mid_batch_norm", "last_batch_norm", "batch_norm_momentum",
              "propagation_depth", "dropout", "posttrans_layers",
              "pretrans_layers")

    def __init__(self, hidden_dim: int, aggregators: Sequence[str],
                 scalers: Sequence[str], residual: bool = True,
                 activation: str = "relu", last_activation: str = "none",
                 mid_batch_norm: bool = False, last_batch_norm: bool = False,
                 batch_norm_momentum: float = 0.1,
                 propagation_depth: int = 5, posttrans_layers: int = 1,
                 pretrans_layers: int = 1, dropout: float = 0.0,
                 pairwise_distances: bool = False):
        super().__init__()
        self.atom_encoder = AtomEncoder(hidden_dim)
        self.bond_encoder = BondEncoder(hidden_dim)
        self.mp_layers = nn.ModuleList(
            PNALayer(hidden_dim, hidden_dim, hidden_dim, aggregators,
                     scalers, activation=activation,
                     last_activation=last_activation, residual=residual,
                     mid_batch_norm=mid_batch_norm,
                     last_batch_norm=last_batch_norm,
                     batch_norm_momentum=batch_norm_momentum, avg_d_log=1.0,
                     posttrans_layers=posttrans_layers,
                     pretrans_layers=pretrans_layers, dropout=dropout,
                     pairwise_distances=pairwise_distances)
            for _ in range(propagation_depth))

    def forward(self, g, noise=None) -> torch.Tensor:
        h = self.atom_encoder(g.node_feat)
        e = self.bond_encoder(g.edge_feat)
        for layer in self.mp_layers:
            h = layer(g, h, e, noise)
        return h


class PNA(nn.Module):
    """GNN + multi-aggregator readout + output MLP (reference
    `models/pna.py:90-135`).  Keyword arguments are the `model_parameters`
    of the reference configs; the dropout masks come from the noise source
    the forward is given (required in training with `dropout` > 0)."""

    def __init__(self, hidden_dim: int, target_dim: int,
                 aggregators: Sequence[str], scalers: Sequence[str],
                 readout_aggregators: Sequence[str],
                 readout_batchnorm: bool = True,
                 readout_hidden_dim: Optional[int] = None,
                 readout_layers: int = 2, residual: bool = True,
                 activation: str = "relu", last_activation: str = "none",
                 mid_batch_norm: bool = False, last_batch_norm: bool = False,
                 propagation_depth: int = 5, dropout: float = 0.0,
                 posttrans_layers: int = 1, pretrans_layers: int = 1,
                 batch_norm_momentum: float = 0.1,
                 pairwise_distances: bool = False):
        super().__init__()
        self.readout_aggregators = tuple(readout_aggregators)
        self.node_gnn = PNAGNN(
            hidden_dim, aggregators, scalers, residual=residual,
            activation=activation, last_activation=last_activation,
            mid_batch_norm=mid_batch_norm, last_batch_norm=last_batch_norm,
            batch_norm_momentum=batch_norm_momentum,
            propagation_depth=propagation_depth,
            posttrans_layers=posttrans_layers,
            pretrans_layers=pretrans_layers, dropout=dropout,
            pairwise_distances=pairwise_distances)
        self.output = MLP(hidden_dim * len(self.readout_aggregators),
                          target_dim, readout_layers,
                          hidden_size=readout_hidden_dim or hidden_dim,
                          mid_batch_norm=readout_batchnorm,
                          batch_norm_momentum=batch_norm_momentum)

    def forward(self, g, noise=None) -> torch.Tensor:
        h = self.node_gnn(g, noise)
        return self.output(batch_readout(g, h, self.readout_aggregators),
                           g.graph_mask)
