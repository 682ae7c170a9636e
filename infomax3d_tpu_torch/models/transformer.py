"""The dense transformers and the distance-supervised baselines (port of
`TransformerGNN`, `TransformerPlain`, `PNATransformer`,
`DistancePredictor`, `PNADistancePredictor` and the flat <-> dense
exchange of `infomax3d_tpu/models/transformer.py`).

`TransformerPlain` runs on the dense batch (`graphs/dense.py`): the atom
codes' embedding beside the Laplacian PE (``pos_enc_mlp`` on each
(eigenvalue, eigenvector entry) pair, masked by ``lap_pe_mask`` and summed
over the frequencies), a prepended virtual token ``v_node``, the encoder
blocks (flax ``mp_{i}``, ``mp_layers.{i}``) over the real atoms and the
token, and the readout MLP
on the token.  `PNATransformer` is the JAX package's redesign of the
reference's hybrid, not its layout: per layer a sparse PNA layer
(``pna_{i}``, the port's `PNALayer` and its kernels) on the CSR batch and
an encoder block (``attn_{i}``) over the layer's input moved to the dense
slots, merged by one Linear over ``[h_sparse, h_dense]`` (``combine_{i}``,
its kernel [2D, D] as the JAX `SplitDense` keeps it); the graphs are read
out by aggregation (mean by default) where the reference reads a virtual
token.  Both refuse a hidden width that is not a multiple of `nhead`.

`DistancePredictor` runs the 2D PNA GNN, optionally one dense transformer
layer over each molecule's atoms, and predicts a distance for every pair
of a pair view (`data/loader.py::pairwise_distance_collate`: the CSR
complete graph laid out on the 2D batch's node slots).  The symmetrised
distance net ``softplus(dn([h_s ‖ h_r]) + dn([h_r ‖ h_s]))`` takes its
input through `FCLayer`'s `EdgeInput` with an edge part of width 0: both
halves project h in node space and the edge-combine kernel gathers the
rows per pair (the pair segment sum is its backward), one half with the
weight columns swapped.

The dense exchange keeps the JAX semantics: node n goes to slot
``node_graph[n] * max_nodes + node_pos[n]`` of the [G * max_nodes] slots,
so the atoms of a molecule above `max_nodes` spill into the next graph's
slots; where several nodes land on one slot the last in node order keeps
it (the JAX drop-mode scatter on the CPU), and slots past the last graph
are dropped.  `dense_to_flat` reads each node back from its own slot,
clipped into range.  The transformer block and the dense gathers are
plain XLA in the JAX package, and plain PyTorch here.
"""
from __future__ import annotations

from typing import Any, Mapping, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from infomax3d_tpu_torch.models.attention import (TransformerEncoderBlock,
                                                  check_heads)
from infomax3d_tpu_torch.models.base import (MLP, AtomEncoder, BondEncoder,
                                             EdgeInput)
from infomax3d_tpu_torch.models.pna import PNAGNN, PNALayer
from infomax3d_tpu_torch.ops.segment import batch_readout



def dense_slots(g, max_nodes: int) -> torch.Tensor:
    """[G * max_nodes] int64: the node each dense slot holds, -1 for an
    empty slot (see the module docstring for spills and ties)."""
    G, N = g.graph_mask.shape[0], g.node_mask.shape[0]
    flat = g.node_graph.long() * max_nodes + g.node_pos.long()
    keep = (flat >= 0) & (flat < G * max_nodes)
    node = torch.arange(N, device=flat.device)
    slots = torch.full((G * max_nodes,), -1, dtype=torch.long,
                       device=flat.device)
    return slots.scatter_reduce(0, flat[keep], node[keep], reduce="amax")


def flat_to_dense(h: torch.Tensor, g, max_nodes: int,
                  slots: Optional[torch.Tensor] = None) -> torch.Tensor:
    """[N, D] flat node features -> [G, max_nodes, D], empty slots 0."""
    slots = dense_slots(g, max_nodes) if slots is None else slots
    rows = h[slots.clamp(min=0)]
    dense = torch.where((slots >= 0)[:, None], rows,
                        torch.zeros((), dtype=h.dtype, device=h.device))
    return dense.reshape(-1, max_nodes, h.shape[-1])


def dense_to_flat(dense: torch.Tensor, g) -> torch.Tensor:
    """[G, max_nodes, D] -> [N, D]: each node's own slot, the index
    clipped into range (padding rows read the last slot; mask them)."""
    G, max_nodes, D = dense.shape
    flat = (g.node_graph.long() * max_nodes + g.node_pos.long()).clamp(
        0, G * max_nodes - 1)
    return dense.reshape(G * max_nodes, D)[flat]


def dense_node_mask(g, max_nodes: int,
                    slots: Optional[torch.Tensor] = None) -> torch.Tensor:
    """[G, max_nodes] bool: the slots that hold a real node."""
    slots = dense_slots(g, max_nodes) if slots is None else slots
    mask = (slots >= 0) & g.node_mask[slots.clamp(min=0)]
    return mask.reshape(-1, max_nodes)


def pair_input(h: torch.Tensor, pairs, swap: bool = False) -> EdgeInput:
    """``[h[senders] ‖ h[receivers]]`` over the pairs of `pairs` (``[h[
    receivers] ‖ h[senders]]`` with `swap`), as an `EdgeInput` with an
    edge part of width 0."""
    return EdgeInput(h, pairs.senders, pairs.receivers,
                     h.new_zeros((pairs.senders.shape[0], 0)),
                     pairs.csr_row_ptr, pairs.csc_row_ptr, pairs.csc_perm,
                     swap)


def symmetric_distances(dn: MLP, h: torch.Tensor, pairs) -> torch.Tensor:
    """``softplus(dn([h_s ‖ h_r]) + dn([h_r ‖ h_s]))`` per pair, [E, out];
    the BatchNorm statistics over the real pairs."""
    fwd = dn(pair_input(h, pairs), pairs.edge_mask)
    bwd = dn(pair_input(h, pairs, swap=True), pairs.edge_mask)
    return F.softplus(fwd + bwd)


def embedding_distances(h: torch.Tensor, pairs) -> torch.Tensor:
    """``||h[s] - h[r]||`` per pair, [E]; indices clipped into range."""
    N = h.shape[0]
    s = pairs.senders.long().clamp(0, N - 1)
    r = pairs.receivers.long().clamp(0, N - 1)
    return torch.linalg.vector_norm(h[s] - h[r], dim=-1)


class DistancePredictor(nn.Module):
    """2D GNN -> pairwise distances (reference `models/distance_predictor.
    py:14-86`, the JAX `DistancePredictor`).  ``forward(g, pairs)``
    returns [E_pairs, target_dim] over the pair view's edges.  The PNA's
    `dropout` acts in its layers and in the transformer block, the masks
    from the noise source the forward is given."""

    def __init__(self, pna_args: Mapping[str, Any], target_dim: int = 1,
                 projection_dim: int = 3, distance_net: bool = False,
                 projection_layers: int = 1, transformer_layer: bool = True,
                 nhead: int = 16, dim_feedforward: int = 256,
                 activation: str = "relu", max_nodes: int = 40):
        super().__init__()
        # the configs pass the full PNA's arguments, readout keys included
        pna = {k: v for k, v in dict(pna_args).items() if k in PNAGNN.FIELDS}
        self.max_nodes = max_nodes
        hidden = pna["hidden_dim"]
        self.node_gnn = PNAGNN(**pna)
        self.transformer_layer = (TransformerEncoderBlock(
            hidden, nhead, dim_feedforward, activation,
            pna.get("dropout", 0.0))
            if transformer_layer else None)
        self.node_projection_net = (MLP(
            hidden, projection_dim, projection_layers, hidden_size=32,
            mid_batch_norm=True)
            if projection_dim > 0 and not distance_net else None)
        self.distance_net = (MLP(
            2 * hidden, target_dim, projection_layers,
            hidden_size=projection_dim, mid_batch_norm=True)
            if distance_net else None)

    def forward(self, g, pairs, noise=None) -> torch.Tensor:
        h = self.node_gnn(g, noise)
        if self.transformer_layer is not None:
            slots = dense_slots(g, self.max_nodes)
            dense = self.transformer_layer(
                flat_to_dense(h, g, self.max_nodes, slots),
                dense_node_mask(g, self.max_nodes, slots), noise)
            h = dense_to_flat(dense, g)
        if self.node_projection_net is not None:
            h = self.node_projection_net(h, g.node_mask)
        if self.distance_net is not None:
            return symmetric_distances(self.distance_net, h, pairs)
        return embedding_distances(h, pairs)[:, None]


class PNADistancePredictor(nn.Module):
    """Reference `models/pna_distance_predictor.py:16-80`: the flat-kwarg
    `DistancePredictor` (``predictor``) with the distance net on and no
    transformer layer.  The readout fields are accepted and unused, as in
    the JAX class."""

    def __init__(self, hidden_dim: int, aggregators: Sequence[str],
                 scalers: Sequence[str], target_dim: int = 1,
                 readout_aggregators: Sequence[str] = ("mean",),
                 residual: bool = True, pairwise_distances: bool = False,
                 activation: str = "relu", last_activation: str = "none",
                 mid_batch_norm: bool = False, last_batch_norm: bool = False,
                 propagation_depth: int = 5, dropout: float = 0.0,
                 projection_layers: int = 2, projection_dim: int = 3,
                 posttrans_layers: int = 1, pretrans_layers: int = 1,
                 batch_norm_momentum: float = 0.1,
                 readout_batchnorm: bool = True,
                 readout_hidden_dim: Optional[int] = None,
                 readout_layers: int = 2):
        super().__init__()
        del readout_aggregators, readout_batchnorm, readout_hidden_dim
        del readout_layers
        self.predictor = DistancePredictor(
            pna_args=dict(
                hidden_dim=hidden_dim, aggregators=aggregators,
                scalers=scalers, residual=residual,
                pairwise_distances=pairwise_distances, activation=activation,
                last_activation=last_activation,
                mid_batch_norm=mid_batch_norm,
                last_batch_norm=last_batch_norm,
                propagation_depth=propagation_depth, dropout=dropout,
                posttrans_layers=posttrans_layers,
                pretrans_layers=pretrans_layers,
                batch_norm_momentum=batch_norm_momentum),
            target_dim=target_dim, distance_net=True,
            projection_dim=projection_dim,
            projection_layers=projection_layers, transformer_layer=False)

    def forward(self, g, pairs, noise=None) -> torch.Tensor:
        return self.predictor(g, pairs, noise)


class TransformerGNN(nn.Module):
    """Reference `models/transformer.py:46-81` (the JAX `TransformerGNN`):
    returns [G, 1 + nmax, hidden], the virtual token first."""

    def __init__(self, hidden_dim: int, dim_feedforward: int, nhead: int = 4,
                 pos_enc_dim: int = 16, activation: str = "relu",
                 propagation_depth: int = 5, dropout: float = 0.0):
        super().__init__()
        check_heads(hidden_dim, nhead)
        self.atom_encoder = AtomEncoder(hidden_dim - pos_enc_dim)
        self.pos_enc_mlp = nn.Linear(2, pos_enc_dim)
        self.v_node = nn.Parameter(torch.randn(hidden_dim))
        self.mp_layers = nn.ModuleList(
            TransformerEncoderBlock(hidden_dim, nhead, dim_feedforward,
                                    activation, dropout)
            for _ in range(propagation_depth))

    def forward(self, g, noise=None) -> torch.Tensor:
        G, N = g.node_feat.shape[:2]
        h = self.atom_encoder(g.node_feat.reshape(G * N, -1)).reshape(
            G, N, -1)
        pe = self.pos_enc_mlp(torch.nan_to_num(g.lap_pe))      # [G, N, k, pe]
        pe = torch.where(g.lap_pe_mask[..., None], pe,
                         torch.zeros((), dtype=pe.dtype, device=pe.device))
        h = torch.cat([h, pe.sum(dim=2)], dim=-1)
        h = torch.cat([self.v_node.expand(G, 1, -1), h], dim=1)
        key_mask = torch.cat([torch.ones(G, 1, dtype=torch.bool,
                                         device=h.device), g.node_mask], 1)
        for layer in self.mp_layers:
            h = layer(h, key_mask, noise)
        return h


class TransformerPlain(nn.Module):
    """The JAX `TransformerPlain`: ``node_gnn`` (`TransformerGNN`) and the
    readout MLP ``output`` on the virtual token, its BatchNorms over the
    real graphs.  Keyword arguments are the JAX module's fields with its
    defaults (`node_dim` is one it never reads)."""

    FIELDS = ("hidden_dim", "target_dim", "dropout", "nhead",
              "dim_feedforward", "readout_batchnorm", "readout_hidden_dim",
              "activation", "readout_layers", "batch_norm_momentum",
              "propagation_depth", "pos_enc_dim", "node_dim")

    def __init__(self, hidden_dim: int, target_dim: int,
                 dropout: float = 0.0, nhead: int = 4,
                 dim_feedforward: int = 256, readout_batchnorm: bool = True,
                 readout_hidden_dim: Optional[int] = None,
                 activation: str = "relu", readout_layers: int = 2,
                 batch_norm_momentum: float = 0.1,
                 propagation_depth: int = 5, pos_enc_dim: int = 16,
                 node_dim: int = 9):
        super().__init__()
        del node_dim
        self.node_gnn = TransformerGNN(hidden_dim, dim_feedforward, nhead,
                                       pos_enc_dim, activation,
                                       propagation_depth, dropout)
        self.output = MLP(hidden_dim, target_dim, readout_layers,
                          hidden_size=readout_hidden_dim or hidden_dim,
                          mid_batch_norm=readout_batchnorm,
                          batch_norm_momentum=batch_norm_momentum)

    def forward(self, g, noise=None) -> torch.Tensor:
        h = self.node_gnn(g, noise)
        return self.output(h[:, 0, :], g.graph_mask)


class PNATransformer(nn.Module):
    """The JAX `PNATransformer` (module docstring).  Keyword arguments are
    its fields with its defaults; the dropout masks come from the noise
    source the forward is given, in the JAX forward's order (per layer
    the PNA layer's, then the encoder block's)."""

    FIELDS = ("hidden_dim", "target_dim", "aggregators", "scalers",
              "readout_aggregators", "max_nodes", "nhead", "dim_feedforward",
              "readout_batchnorm", "readout_hidden_dim", "readout_layers",
              "residual", "activation", "last_activation", "mid_batch_norm",
              "last_batch_norm", "propagation_depth", "dropout",
              "posttrans_layers", "pretrans_layers", "batch_norm_momentum")

    def __init__(self, hidden_dim: int, target_dim: int,
                 aggregators: Sequence[str], scalers: Sequence[str],
                 readout_aggregators: Sequence[str] = ("mean",),
                 max_nodes: int = 40, nhead: int = 4,
                 dim_feedforward: int = 256, readout_batchnorm: bool = True,
                 readout_hidden_dim: Optional[int] = None,
                 readout_layers: int = 2, residual: bool = True,
                 activation: str = "relu", last_activation: str = "none",
                 mid_batch_norm: bool = False, last_batch_norm: bool = False,
                 propagation_depth: int = 5, dropout: float = 0.0,
                 posttrans_layers: int = 1, pretrans_layers: int = 1,
                 batch_norm_momentum: float = 0.1):
        super().__init__()
        check_heads(hidden_dim, nhead)
        H = hidden_dim
        self.readout_aggregators = tuple(readout_aggregators)
        self.max_nodes, self.depth = max_nodes, propagation_depth
        self.atom_encoder = AtomEncoder(H)
        self.bond_encoder = BondEncoder(H)
        for i in range(propagation_depth):
            self.add_module(f"pna_{i}", PNALayer(
                H, H, H, aggregators, scalers, activation=activation,
                last_activation=last_activation, residual=residual,
                mid_batch_norm=mid_batch_norm,
                last_batch_norm=last_batch_norm,
                batch_norm_momentum=batch_norm_momentum,
                posttrans_layers=posttrans_layers,
                pretrans_layers=pretrans_layers, dropout=dropout))
            self.add_module(f"attn_{i}", TransformerEncoderBlock(
                H, nhead, dim_feedforward, activation, dropout))
            self.add_module(f"combine_{i}", MLP(2 * H, H, 1, hidden_size=H,
                                                mid_activation=activation))
        self.output = MLP(H * len(self.readout_aggregators), target_dim,
                          readout_layers,
                          hidden_size=readout_hidden_dim or H,
                          mid_batch_norm=readout_batchnorm,
                          batch_norm_momentum=batch_norm_momentum)

    def forward(self, g, noise=None) -> torch.Tensor:
        h = self.atom_encoder(g.node_feat)
        e = self.bond_encoder(g.edge_feat)
        slots = dense_slots(g, self.max_nodes)
        dmask = dense_node_mask(g, self.max_nodes, slots)
        for i in range(self.depth):
            h_sparse = getattr(self, f"pna_{i}")(g, h, e, noise)
            dense = getattr(self, f"attn_{i}")(
                flat_to_dense(h, g, self.max_nodes, slots), dmask, noise)
            h_dense = dense_to_flat(dense, g)
            h = getattr(self, f"combine_{i}")(
                torch.cat([h_sparse, h_dense], dim=-1), g.node_mask)
        return self.output(batch_readout(g, h, self.readout_aggregators),
                           g.graph_mask)
