"""PNAOriginal, the PNA paper's own model with towers, a GRU and graph
norm, and PNAOriginalSimple (port of `infomax3d_tpu/models/
pna_original.py`, the reference's `models/pna_original.py`) on CSR
batches.

Against `models/pna.py`'s PNA: the scalers are always applied, even a
single one (`ops/aggregate.py::pna_aggregate_parts_always_scaled`), and
`avg_d` is a scalar.  A layer splits into `towers` independent
convolutions (each reading an equal slice of h, or with `divide_input`
off the whole of it) whose outputs a Linear and a leaky ReLU mix; a GRU
may carry h from layer to layer; `graph_norm` scales each node by its
graph's 1 / sqrt(n) (the batch's `snorm`).  A tower's pretrans MLP reads
``[h[src] ‖ h[dst] ‖ e ‖ |x_src - x_dst|]`` (the distance with `use_3d`):
its first Linear projects h in node space and the edge-combine kernel
sums the gathered rows, as in `PNALayer`.  PNAOriginalSimple aggregates
the gathered neighbour rows themselves (its backward is the
sender-keyed segment sum) and has no edge network.

Under the bf16 recipe the scaled aggregates come back in float32 (a bf16
block times a float32 degree factor, as JAX promotes it), so the
posttrans MLP and everything after it run in float32: from the second
layer on, the messages are float32 and aggregate through the multi-reduce
kernel, as the JAX step computes.  Dropout (the input features' and each
tower's or layer's output) draws its masks from the noise source the
forward is given, in the JAX module's order.

Module names are the flax ones (``embedding_h``, ``embedding_e``,
``layer_{i}``, ``tower_{t}``, ``pretrans``, ``posttrans``,
``mixing_network``, ``gru``, ``output``), which the JAX package's
`convert_state_dict` keeps as they are.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from infomax3d_tpu_torch.models.base import (MLP, AtomEncoder, BondEncoder,
                                             EdgeInput, GRUCell, MLPReadout,
                                             PromotingLinear)
from infomax3d_tpu_torch.models.noise import dropout as drop
from infomax3d_tpu_torch.ops.aggregate import (gather_src,
                                               pna_aggregate_parts_always_scaled)
from infomax3d_tpu_torch.ops.segment import batch_readout


class PNATower(nn.Module):
    """One tower (reference `PNATower`): pretrans MLP over the edges (no
    BatchNorm), the always-scaled aggregates, posttrans MLP over ``[h ‖
    aggregates]`` on the real nodes, graph norm, dropout."""

    def __init__(self, in_dim: int, out_dim: int, edge_dim: int,
                 aggregators: Sequence[str], scalers: Sequence[str],
                 avg_d: float, dropout: float = 0.0, graph_norm: bool = False,
                 mid_batch_norm: bool = False, last_batch_norm: bool = False,
                 use_3d: bool = False, pretrans_layers: int = 1,
                 posttrans_layers: int = 1):
        super().__init__()
        self.aggregators, self.scalers = tuple(aggregators), tuple(scalers)
        self.avg_d, self.dropout = avg_d, dropout
        self.graph_norm, self.use_3d = graph_norm, use_3d
        self.pretrans = MLP(2 * in_dim + edge_dim + int(use_3d), in_dim,
                            pretrans_layers, hidden_size=in_dim)
        n_parts = len(self.aggregators) * len(self.scalers) + 1
        self.posttrans = MLP(n_parts * in_dim, out_dim, posttrans_layers,
                             hidden_size=out_dim,
                             mid_batch_norm=mid_batch_norm,
                             last_batch_norm=last_batch_norm)

    def forward(self, g, h: torch.Tensor, e: Optional[torch.Tensor],
                noise=None) -> torch.Tensor:
        cols = [] if e is None else [e]
        if self.use_3d:
            pos = g.coords
            d = pos[g.senders.clamp(max=pos.shape[0] - 1).long()] - \
                pos[g.receivers.clamp(max=pos.shape[0] - 1).long()]
            cols.append(torch.linalg.vector_norm(d, dim=-1, keepdim=True))
        edge = (torch.cat(cols, dim=-1) if cols
                else h.new_zeros((g.senders.shape[0], 0)))
        msg = self.pretrans(EdgeInput(h, g.senders, g.receivers, edge,
                                      g.csr_row_ptr, g.csc_row_ptr,
                                      g.csc_perm, halo=g.halo_send),
                            g.edge_mask)
        parts = pna_aggregate_parts_always_scaled(
            g, msg, self.aggregators, self.scalers, self.avg_d)
        out = self.posttrans(torch.cat([h] + parts, dim=-1), g.node_mask)
        if self.graph_norm:
            out = out * g.snorm
        return drop(out, self.dropout, noise, self.training)


class PNAOriginalLayer(nn.Module):
    """`towers` PNATowers (``tower_{t}``), their outputs concatenated and
    mixed by ``mixing_network`` and a leaky ReLU (slope 0.01), plus h
    where in and out widths agree and `residual` is set."""

    def __init__(self, in_dim: int, out_dim: int, edge_dim: int,
                 aggregators: Sequence[str], scalers: Sequence[str],
                 avg_d: float, dropout: float = 0.0, graph_norm: bool = False,
                 mid_batch_norm: bool = False, last_batch_norm: bool = False,
                 use_3d: bool = False, towers: int = 1,
                 pretrans_layers: int = 1, posttrans_layers: int = 1,
                 divide_input: bool = True, residual: bool = False):
        super().__init__()
        self.residual = residual and in_dim == out_dim
        self.towers, self.divide_input = towers, divide_input
        self.in_tower = in_dim // towers if divide_input else in_dim
        out_tower = out_dim // towers
        for t in range(towers):
            self.add_module(f"tower_{t}", PNATower(
                self.in_tower, out_tower, edge_dim, aggregators, scalers,
                avg_d, dropout=dropout, graph_norm=graph_norm,
                mid_batch_norm=mid_batch_norm,
                last_batch_norm=last_batch_norm, use_3d=use_3d,
                pretrans_layers=pretrans_layers,
                posttrans_layers=posttrans_layers))
        self.mixing_network = PromotingLinear(out_tower * towers, out_dim)

    def forward(self, g, h: torch.Tensor, e: Optional[torch.Tensor],
                noise=None) -> torch.Tensor:
        w = self.in_tower
        outs = [getattr(self, f"tower_{t}")(
                    g, h[:, t * w:(t + 1) * w] if self.divide_input else h,
                    e, noise)
                for t in range(self.towers)]
        h_out = F.leaky_relu(self.mixing_network(torch.cat(outs, dim=-1)),
                             0.01)
        return h + h_out if self.residual else h_out


class PNAOriginal(nn.Module):
    """Atom (and bond) embeddings, `propagation_depth` PNAOriginalLayers
    (the last one `last_layer_dim` wide and split by `divide_input_last`,
    the others by `divide_input_first`), the GRU between layers (``h =
    gru(h, h_t)``, not after the last), the readout and `MLPReadout`.
    `readout_hidden_dim` and `readout_layers` are accepted and unused, as
    in JAX."""

    FIELDS = ("hidden_dim", "last_layer_dim", "target_dim",
              "readout_aggregators", "avg_d", "in_feat_dropout", "dropout",
              "last_batch_norm", "mid_batch_norm", "propagation_depth",
              "readout_hidden_dim", "readout_layers", "aggregators",
              "scalers", "residual", "posttrans_layers", "pretrans_layers",
              "edge_hidden_dim", "graph_norm", "use_3d", "gru_enable",
              "divide_input_last", "divide_input_first", "edge_feat",
              "towers")

    def __init__(self, hidden_dim: int, last_layer_dim: int, target_dim: int,
                 readout_aggregators: Sequence[str], avg_d: float = 1.0,
                 in_feat_dropout: float = 0.0, dropout: float = 0.0,
                 last_batch_norm: bool = False, mid_batch_norm: bool = False,
                 propagation_depth: int = 4,
                 readout_hidden_dim: Optional[int] = None,
                 readout_layers: int = 2,
                 aggregators: Sequence[str] = ("mean", "max", "min", "std"),
                 scalers: Sequence[str] = ("identity", "amplification",
                                           "attenuation"),
                 residual: bool = False, posttrans_layers: int = 1,
                 pretrans_layers: int = 1, edge_hidden_dim: int = 0,
                 graph_norm: bool = False, use_3d: bool = False,
                 gru_enable: bool = False, divide_input_last: bool = True,
                 divide_input_first: bool = True, edge_feat: bool = True,
                 towers: int = 1):
        super().__init__()
        self.readout_aggregators = tuple(readout_aggregators)
        self.in_feat_dropout = in_feat_dropout
        self.depth = propagation_depth
        e_dim = edge_hidden_dim or hidden_dim
        # the JAX package's converter names tables without "atom" in their
        # path bond tables (`models/base.py::_CategoricalEncoder`)
        self.embedding_h = AtomEncoder(hidden_dim, kind="bond")
        self.embedding_e = BondEncoder(e_dim) if edge_feat else None
        self.gru = GRUCell(hidden_dim, hidden_dim) if gru_enable else None
        for i in range(propagation_depth):
            last = i == propagation_depth - 1
            self.add_module(f"layer_{i}", PNAOriginalLayer(
                hidden_dim, last_layer_dim if last else hidden_dim,
                e_dim if edge_feat else 0, aggregators, scalers, avg_d,
                dropout=dropout, graph_norm=graph_norm,
                mid_batch_norm=mid_batch_norm,
                last_batch_norm=last_batch_norm, use_3d=use_3d,
                towers=towers, pretrans_layers=pretrans_layers,
                posttrans_layers=posttrans_layers,
                divide_input=divide_input_last if last
                else divide_input_first, residual=residual))
        self.output = MLPReadout(last_layer_dim * len(readout_aggregators),
                                 target_dim)

    def forward(self, g, noise=None) -> torch.Tensor:
        h = drop(self.embedding_h(g.node_feat), self.in_feat_dropout, noise,
                 self.training)
        e = None if self.embedding_e is None else \
            self.embedding_e(g.edge_feat)
        for i in range(self.depth):
            h_t = getattr(self, f"layer_{i}")(g, h, e, noise)
            if self.gru is not None and i < self.depth - 1:
                h_t = self.gru(h, h_t)
            h = h_t
        return self.output(batch_readout(g, h, self.readout_aggregators))


class PNASimpleLayer(nn.Module):
    """The neighbours' rows aggregated as they are (the gather's backward
    is the sender-keyed segment sum), the posttrans MLP over the
    aggregates, a ReLU, the residual where widths agree, dropout."""

    def __init__(self, in_dim: int, out_dim: int, aggregators: Sequence[str],
                 scalers: Sequence[str], avg_d: float, dropout: float = 0.0,
                 last_batch_norm: bool = False, mid_batch_norm: bool = False,
                 residual: bool = False, posttrans_layers: int = 1):
        super().__init__()
        self.aggregators, self.scalers = tuple(aggregators), tuple(scalers)
        self.avg_d, self.dropout = avg_d, dropout
        self.residual = residual and in_dim == out_dim
        n_parts = len(self.aggregators) * len(self.scalers)
        self.posttrans = MLP(n_parts * in_dim, out_dim, posttrans_layers,
                             hidden_size=out_dim,
                             mid_batch_norm=mid_batch_norm,
                             last_batch_norm=last_batch_norm)

    def forward(self, g, h: torch.Tensor, noise=None) -> torch.Tensor:
        parts = pna_aggregate_parts_always_scaled(
            g, gather_src(g, h), self.aggregators, self.scalers, self.avg_d)
        out = F.relu(self.posttrans(torch.cat(parts, dim=-1), g.node_mask))
        if self.residual:
            out = h + out
        return drop(out, self.dropout, noise, self.training)


class PNAOriginalSimple(nn.Module):
    """Atom embedding, `propagation_depth` PNASimpleLayers, the readout and
    the masked output MLP (mid BatchNorm per `readout_batchnorm`)."""

    FIELDS = ("hidden_dim", "last_layer_dim", "target_dim",
              "readout_aggregators", "avg_d", "in_feat_dropout", "dropout",
              "last_batch_norm", "mid_batch_norm", "propagation_depth",
              "readout_hidden_dim", "readout_layers", "readout_batchnorm",
              "batch_norm_momentum", "aggregators", "scalers", "residual",
              "posttrans_layers")

    def __init__(self, hidden_dim: int, last_layer_dim: int, target_dim: int,
                 readout_aggregators: Sequence[str], avg_d: float = 1.0,
                 in_feat_dropout: float = 0.0, dropout: float = 0.0,
                 last_batch_norm: bool = False, mid_batch_norm: bool = False,
                 propagation_depth: int = 4,
                 readout_hidden_dim: Optional[int] = None,
                 readout_layers: int = 2, readout_batchnorm: bool = True,
                 batch_norm_momentum: float = 0.1,
                 aggregators: Sequence[str] = ("mean", "max", "min", "std"),
                 scalers: Sequence[str] = ("identity", "amplification",
                                           "attenuation"),
                 residual: bool = False, posttrans_layers: int = 1):
        super().__init__()
        self.readout_aggregators = tuple(readout_aggregators)
        self.in_feat_dropout = in_feat_dropout
        self.depth = propagation_depth
        self.embedding_h = AtomEncoder(hidden_dim, kind="bond")
        for i in range(propagation_depth):
            last = i == propagation_depth - 1
            self.add_module(f"layer_{i}", PNASimpleLayer(
                hidden_dim, last_layer_dim if last else hidden_dim,
                aggregators, scalers, avg_d, dropout=dropout,
                last_batch_norm=last_batch_norm,
                mid_batch_norm=mid_batch_norm, residual=residual,
                posttrans_layers=posttrans_layers))
        self.output = MLP(last_layer_dim * len(readout_aggregators),
                          target_dim, readout_layers,
                          hidden_size=readout_hidden_dim or hidden_dim,
                          mid_batch_norm=readout_batchnorm,
                          batch_norm_momentum=batch_norm_momentum)

    def embed(self, g, noise=None) -> torch.Tensor:
        return self.embedding_h(g.node_feat)

    def forward(self, g, noise=None) -> torch.Tensor:
        h = drop(self.embed(g, noise), self.in_feat_dropout, noise,
                 self.training)
        for i in range(self.depth):
            h = getattr(self, f"layer_{i}")(g, h, noise)
        return self.output(batch_readout(g, h, self.readout_aggregators),
                           g.graph_mask)
