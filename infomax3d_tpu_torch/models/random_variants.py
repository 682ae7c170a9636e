"""The random-feature models (port of `PNALayerEdgeUpdate`,
`PNAGNNRandomEdgeUpdate`, `PNARandomEdgeUpdate`, `GINConvRandom`, `GNNNodeRandom`,
`OGBGNNRandom`, `PNAOriginalRandom` and `PNAOriginalSimpleRandom`,
infomax3d_tpu/models/random_variants.py, the reference's
`models/pna_edge_update_random.py` and `models/gin_random.py`).

Per layer, in the JAX package's order: ``z = relu(edge(e) + node_in(h[s])
+ node_out(h[r]))`` (gather first, then the Linear), the pretrans MLP,
``e' = (1 + edge_eps) e + z``, messages ``posttrans_1(e')`` aggregated at
each receiver by the PNA aggregators and scalers, and ``h' = (1 +
node_eps) h + posttrans_2(agg)``.  The sender gather's backward is the
sender-keyed segment-sum kernel, the receiver gather's the CSR segment-sum
kernel, and a float32 aggregate the CSR multi-reduce kernel.

The GIN with noise columns: atom and bond encoders emit ``hidden -
random_vec_dim`` columns and one draw of node and edge noise fills the
rest, at the input (nodes) and in every convolution (edges); per layer
the GIN convolution (the sender gather, whose backward is the
sender-keyed segment-sum kernel, and the CSR-sum kernel at each
receiver), the layer's BatchNorm, a relu on all but the last layer,
dropout, the residual, and with a virtual node its per-graph MLP.

PNAOriginal's random variants: `PNAOriginalRandom` is `PNAOriginal` (the
reference draws no noise there), `PNAOriginalSimpleRandom` joins noise
columns to the atom encoder's rows before PNAOriginalSimple's layers.

Randomness comes from a noise source (`models/noise.py`: normal, uniform
and Bernoulli draws in the JAX model's order); without one the noise is
zero, as the JAX model's without its 'random' rng.  Dropout masks are
drawn in training mode only.
"""
from __future__ import annotations

from typing import Any, Mapping, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from infomax3d_tpu_torch.models.base import (MLP, AtomEncoder, BondEncoder,
                                             MaskedBatchNorm,
                                             PromotingLinear)
from infomax3d_tpu_torch.models.geomol import GeomolMLP
from infomax3d_tpu_torch.models.gin import GINConv
from infomax3d_tpu_torch.models.noise import dropout, noise_columns
from infomax3d_tpu_torch.models.pna_original import (PNAOriginal,
                                                     PNAOriginalSimple)
from infomax3d_tpu_torch.ops.aggregate import (edge_aggregate, gather_dst,
                                               gather_src,
                                               pna_aggregate_parts)
from infomax3d_tpu_torch.ops.segment import batch_readout, segment_sum


class PNALayerEdgeUpdate(nn.Module):
    """One edge-update PNA layer (module docstring).  Submodules carry the
    JAX module's names: ``edge``, ``node_in``, ``node_out`` (no bias),
    ``pretrans``, ``edge_eps``, ``posttrans_1``, ``node_eps``,
    ``posttrans_2``.  Its three MLPs carry the BatchNorms and dropout the
    layer is given (the pretrans and the messages over the real edges,
    the node update over the real nodes)."""

    def __init__(self, in_dim: int, out_dim: int, aggregators: Sequence[str],
                 scalers: Sequence[str], activation: str = "relu",
                 last_activation: str = "none", posttrans_layers: int = 2,
                 pretrans_layers: int = 1, mid_batch_norm: bool = False,
                 last_batch_norm: bool = False,
                 batch_norm_momentum: float = 0.1, dropout: float = 0.0):
        super().__init__()
        self.aggregators, self.scalers = list(aggregators), list(scalers)
        # promoting, as flax `Dense`: float32 noise columns make the node
        # and edge states float32 under the bf16 recipe
        self.edge = PromotingLinear(in_dim, in_dim)
        self.node_in = PromotingLinear(in_dim, in_dim, bias=False)
        self.node_out = PromotingLinear(in_dim, in_dim, bias=False)
        acts = dict(mid_activation=activation, last_activation=last_activation,
                    mid_batch_norm=mid_batch_norm,
                    last_batch_norm=last_batch_norm,
                    batch_norm_momentum=batch_norm_momentum, dropout=dropout)
        self.pretrans = MLP(in_dim, in_dim, pretrans_layers,
                            hidden_size=in_dim, **acts)
        self.edge_eps = nn.Parameter(torch.zeros(1))
        self.posttrans_1 = MLP(in_dim, in_dim, posttrans_layers,
                               hidden_size=out_dim, **acts)
        self.node_eps = nn.Parameter(torch.zeros(1))
        n_parts = len(aggregators) * (len(scalers) if len(scalers) > 1 else 1)
        self.posttrans_2 = MLP(n_parts * in_dim, out_dim, posttrans_layers,
                               hidden_size=out_dim, **acts)

    def forward(self, g, h: torch.Tensor, e: torch.Tensor, noise=None):
        z = F.relu(self.edge(e) + self.node_in(gather_src(g, h))
                   + self.node_out(gather_dst(g, h)))
        z = self.pretrans(z, g.edge_mask, noise=noise)
        e_out = (1.0 + self.edge_eps) * e + z
        msg = self.posttrans_1(e_out, g.edge_mask, noise=noise)
        agg = torch.cat(pna_aggregate_parts(g, msg, self.aggregators,
                                            self.scalers, avg_d_log=1.0),
                        dim=-1)
        h_out = (1.0 + self.node_eps) * h + self.posttrans_2(
            agg, g.node_mask, noise=noise)
        return h_out, e_out


class PNAGNNRandomEdgeUpdate(nn.Module):
    """The GNN-only edge-update variant: full-width atom and bond encoders,
    noise columns concatenated and projected back to `hidden_dim` by
    2-layer GeoMol MLPs (``node_init``, ``edge_init``), then
    `propagation_depth` layers (``mp_layers.{i}``).  Returns the node
    embeddings [N, hidden_dim].  Keyword arguments are the JAX module's
    fields with its defaults (`residual` is a field the JAX layer never
    reads)."""

    FIELDS = ("hidden_dim", "aggregators", "scalers", "random_vec_dim",
              "random_vec_std", "residual", "activation", "last_activation",
              "mid_batch_norm", "last_batch_norm", "propagation_depth",
              "dropout", "posttrans_layers", "pretrans_layers",
              "batch_norm_momentum")

    def __init__(self, hidden_dim: int, aggregators: Sequence[str],
                 scalers: Sequence[str], random_vec_dim: int = 10,
                 random_vec_std: float = 1.0, residual: bool = True,
                 activation: str = "relu", last_activation: str = "none",
                 mid_batch_norm: bool = False, last_batch_norm: bool = False,
                 propagation_depth: int = 5, dropout: float = 0.0,
                 posttrans_layers: int = 1, pretrans_layers: int = 1,
                 batch_norm_momentum: float = 0.1):
        super().__init__()
        self.random_vec_dim = random_vec_dim
        self.random_vec_std = random_vec_std
        self.atom_encoder = AtomEncoder(hidden_dim)
        self.bond_encoder = BondEncoder(hidden_dim)
        self.node_init = GeomolMLP(hidden_dim + random_vec_dim, hidden_dim, 2)
        self.edge_init = GeomolMLP(hidden_dim + random_vec_dim, hidden_dim, 2)
        self.mp_layers = nn.ModuleList(
            PNALayerEdgeUpdate(hidden_dim, hidden_dim, aggregators, scalers,
                               activation, last_activation, posttrans_layers,
                               pretrans_layers, mid_batch_norm,
                               last_batch_norm, batch_norm_momentum, dropout)
            for _ in range(propagation_depth))

    @classmethod
    def from_config(cls, params: Mapping[str, Any]
                    ) -> "PNAGNNRandomEdgeUpdate":
        """Other keys of a config are dropped, as the JAX package drops
        them (e.g. `readout_batchnorm`)."""
        return cls(**{k: v for k, v in params.items() if k in cls.FIELDS})

    def _noise(self, noise, rows: int, like: torch.Tensor) -> torch.Tensor:
        """float32 noise columns (zeros without a source), as the JAX
        model's: they promote the bf16 encoders' columns they join."""
        return noise_columns(noise, rows, self.random_vec_dim,
                             self.random_vec_std,
                             torch.empty(0, device=like.device))

    def forward(self, g, noise=None) -> torch.Tensor:
        h = self.atom_encoder(g.node_feat)
        e = self.bond_encoder(g.edge_feat)
        h = self.node_init(torch.cat([h, self._noise(noise, h.shape[0], h)],
                                     dim=-1))
        e = self.edge_init(torch.cat([e, self._noise(noise, e.shape[0], e)],
                                     dim=-1))
        for layer in self.mp_layers:
            h, e = layer(g, h, e, noise)
        return h


class PNARandomEdgeUpdate(PNAGNNRandomEdgeUpdate):
    """Reference `pna_edge_update_random.py:15-57` (the JAX
    `PNARandomEdgeUpdate`): `PNAGNNRandomEdgeUpdate`'s encoders, init MLPs
    and layers (at the module's root, where flax names them), then the
    readout and the ``output`` MLP.  Keyword arguments are the JAX
    module's fields.  Under the default trainers the source gives masks
    alone, so the noise columns are zeros, as the JAX trainers' are."""

    FIELDS = PNAGNNRandomEdgeUpdate.FIELDS + (
        "target_dim", "readout_aggregators", "readout_batchnorm",
        "readout_hidden_dim", "readout_layers")

    def __init__(self, hidden_dim: int, target_dim: int,
                 aggregators: Sequence[str], scalers: Sequence[str],
                 readout_aggregators: Sequence[str],
                 readout_batchnorm: bool = True,
                 readout_hidden_dim=None, readout_layers: int = 2,
                 batch_norm_momentum: float = 0.1, **gnn):
        super().__init__(hidden_dim, aggregators, scalers,
                         batch_norm_momentum=batch_norm_momentum, **gnn)
        self.readout_aggregators = tuple(readout_aggregators)
        self.output = MLP(hidden_dim * len(self.readout_aggregators),
                          target_dim, readout_layers,
                          hidden_size=readout_hidden_dim or hidden_dim,
                          mid_batch_norm=readout_batchnorm,
                          batch_norm_momentum=batch_norm_momentum)

    def forward(self, g, noise=None) -> torch.Tensor:
        h = super().forward(g, noise)
        return self.output(batch_readout(g, h, self.readout_aggregators),
                           g.graph_mask)


class GINConvRandom(GINConv):
    """GIN convolution with edge noise (reference `gin_random.py:89-117`):
    the bond encoder emits ``hidden - random_vec_dim`` columns and the
    forward's edge noise fills the rest; then `GINConv`'s messages, sum
    and MLP."""

    def __init__(self, hidden_dim: int, random_vec_dim: int,
                 batch_norm_momentum: float = 0.1):
        super().__init__(hidden_dim, batch_norm_momentum)
        self.bond_encoder = BondEncoder(hidden_dim - random_vec_dim)

    def forward(self, g, h: torch.Tensor, rand_edge: torch.Tensor
                ) -> torch.Tensor:
        emb = self.bond_encoder(g.edge_feat)
        emb = torch.cat([emb, rand_edge], dim=-1)     # promoted, as JAX
        msg = F.relu(gather_src(g, h) + emb)
        z = (1.0 + self.eps) * h + edge_aggregate(g, msg, "sum")
        lin0, bn, relu, lin1 = self.mlp
        return lin1(relu(bn(lin0(z), g.node_mask)))


class GNNNodeRandom(nn.Module):
    """The GIN node stack with noise columns (reference `gin_random.py:
    153-243`): ``convs.{i}`` (flax ``conv_{i}``), ``bn_{i}``, and with a
    virtual node ``virtualnode_embedding`` (an ``nn.Embedding(1, D)``, as
    the reference's), ``vn_mlp_{i}_0`` /
    ``vn_bn_{i}`` / ``vn_mlp_{i}_1`` between layers; jumping knowledge
    "last" or "sum" (the JAX module's sum of the stack's inputs, the
    embedding included and the last layer's output not)."""

    def __init__(self, num_layers: int, hidden_dim: int, random_vec_dim: int,
                 dropout: float = 0.5, jk: str = "last",
                 residual: bool = False, batch_norm_momentum: float = 0.1,
                 virtual_node: bool = False):
        super().__init__()
        if jk not in ("last", "sum"):
            raise ValueError(f"unknown JK mode {jk}")
        H, m = hidden_dim, batch_norm_momentum
        self.num_layers, self.dropout, self.jk = num_layers, dropout, jk
        self.residual, self.virtual_node = residual, virtual_node
        self.atom_encoder = AtomEncoder(H - random_vec_dim)
        self.convs = nn.ModuleList(GINConvRandom(H, random_vec_dim, m)
                                   for _ in range(num_layers))
        for i in range(num_layers):
            self.add_module(f"bn_{i}", MaskedBatchNorm(H, m))
        if virtual_node:
            self.virtualnode_embedding = nn.Embedding(1, H)
            nn.init.zeros_(self.virtualnode_embedding.weight)
            for i in range(num_layers - 1):
                self.add_module(f"vn_mlp_{i}_0", PromotingLinear(H, 2 * H))
                self.add_module(f"vn_bn_{i}", MaskedBatchNorm(2 * H, m))
                self.add_module(f"vn_mlp_{i}_1", PromotingLinear(2 * H, H))

    def forward(self, g, rand_x: torch.Tensor, rand_edge: torch.Tensor,
                noise=None) -> torch.Tensor:
        G = g.graph_mask.shape[0]
        h = self.atom_encoder(g.node_feat)
        h = torch.cat([h, rand_x], dim=-1)
        graph_of = g.node_graph.clamp(0, G - 1).long()
        if self.virtual_node:
            virtual = self.virtualnode_embedding.weight.expand(G, -1)
        h_list = [h]
        for i, conv in enumerate(self.convs):
            h = h_list[i]
            if self.virtual_node:
                h = h + virtual[graph_of]
            h = getattr(self, f"bn_{i}")(conv(g, h, rand_edge), g.node_mask)
            if i != self.num_layers - 1:
                h = F.relu(h)
            h = dropout(h, self.dropout, noise, self.training)
            if self.residual:
                h = h + h_list[i]
            h_list.append(h)
            if self.virtual_node and i < self.num_layers - 1:
                pooled = segment_sum(h_list[i], g.node_graph, G) + virtual
                z = getattr(self, f"vn_mlp_{i}_0")(pooled)
                z = F.relu(getattr(self, f"vn_bn_{i}")(z, g.graph_mask))
                z = F.relu(getattr(self, f"vn_mlp_{i}_1")(z))
                z = dropout(z, self.dropout, noise, self.training)
                virtual = virtual + z if self.residual else z
        if self.jk == "last":
            return h_list[-1]
        return sum(h_list[:self.num_layers])


class OGBGNNRandom(nn.Module):
    """Reference `gin_random.py:16-86` (the JAX `OGBGNNRandom`): one draw of
    node then edge noise, ``node_gnn`` (`GNNNodeRandom`), the graph
    pooling (sum, mean or max) and `graph_pred_linear`.  Keyword arguments
    are the JAX module's fields with its defaults.  Under the supervised
    trainer the source gives masks alone, so the noise columns are zeros
    (`noise.MasksOnly`), as the JAX trainer's are."""

    FIELDS = ("target_dim", "num_layers", "hidden_dim", "virtual_node",
              "residual", "dropout", "JK", "graph_pooling", "random_vec_dim",
              "random_vec_std", "batch_norm_momentum")

    def __init__(self, target_dim: int = 1, num_layers: int = 5,
                 hidden_dim: int = 300, virtual_node: bool = True,
                 residual: bool = False, dropout: float = 0.0,
                 JK: str = "last", graph_pooling: str = "sum",
                 random_vec_dim: int = 10, random_vec_std: float = 1.0,
                 batch_norm_momentum: float = 0.1):
        super().__init__()
        if graph_pooling not in ("sum", "mean", "max"):
            raise ValueError(f"unknown readout aggregator: {graph_pooling}")
        self.graph_pooling = graph_pooling
        self.random_vec_dim, self.random_vec_std = random_vec_dim, \
            random_vec_std
        self.node_gnn = GNNNodeRandom(
            num_layers, hidden_dim, random_vec_dim, dropout=dropout, jk=JK,
            residual=residual, batch_norm_momentum=batch_norm_momentum,
            virtual_node=virtual_node)
        self.graph_pred_linear = PromotingLinear(hidden_dim, target_dim)

    @classmethod
    def from_config(cls, params: Mapping[str, Any]) -> "OGBGNNRandom":
        return cls(**{k: v for k, v in params.items() if k in cls.FIELDS})

    def forward(self, g, noise=None) -> torch.Tensor:
        # float32 noise columns (zeros without a source), as the JAX
        # model's: they promote the bf16 encoders' columns they join
        like = torch.empty(0, device=g.node_feat.device)
        rand_x = noise_columns(noise, g.node_feat.shape[0],
                               self.random_vec_dim, self.random_vec_std, like)
        rand_e = noise_columns(noise, g.senders.shape[0],
                               self.random_vec_dim, self.random_vec_std, like)
        h = self.node_gnn(g, rand_x, rand_e, noise)
        return self.graph_pred_linear(
            batch_readout(g, h, [self.graph_pooling]))


# the reference's pna_original_random.py:120-150 draws no noise: the JAX
# package registers PNAOriginal itself under this name
PNAOriginalRandom = PNAOriginal


class PNAOriginalSimpleRandom(PNAOriginalSimple):
    """Reference `pna_original_random.py:328-412` (the JAX
    `PNAOriginalSimpleRandom`): the atom encoder's rows (``atom_encoder``)
    joined by `random_vec_dim` float32 noise columns and projected back to
    `hidden_dim` by a 2-layer GeoMol MLP (``node_init``), then
    PNAOriginalSimple's layers, readout and output MLP.  Under the
    supervised trainer the source gives masks alone, so the noise columns
    are zeros, as the JAX trainer's are."""

    FIELDS = PNAOriginalSimple.FIELDS + ("random_vec_dim", "random_vec_std")

    def __init__(self, hidden_dim: int, last_layer_dim: int, target_dim: int,
                 readout_aggregators: Sequence[str], random_vec_dim: int = 10,
                 random_vec_std: float = 1.0, **kw):
        super().__init__(hidden_dim, last_layer_dim, target_dim,
                         readout_aggregators, **kw)
        del self.embedding_h
        self.random_vec_dim, self.random_vec_std = random_vec_dim, \
            random_vec_std
        self.atom_encoder = AtomEncoder(hidden_dim)
        self.node_init = GeomolMLP(hidden_dim + random_vec_dim, hidden_dim, 2)

    def embed(self, g, noise=None) -> torch.Tensor:
        h = self.atom_encoder(g.node_feat)
        cols = noise_columns(noise, h.shape[0], self.random_vec_dim,
                             self.random_vec_std,
                             torch.empty(0, device=h.device))
        return self.node_init(torch.cat([h, cols], dim=-1))
