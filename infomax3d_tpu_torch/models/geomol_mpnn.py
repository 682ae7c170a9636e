"""The GeoMol MPNN family (port of infomax3d_tpu/models/geomol_mpnn.py, the
reference's `models/geomol_mpnn.py` and `geomol_mpnn_ogb_feat*`): a
meta-layer GNN with learnable-epsilon residual edge and node models.

`GeomolGNN`: ``node_init`` / ``edge_init`` MLPs, then `depth` applications
of one shared meta-layer (``edge_model``, ``node_model``, ``edge_eps``,
``node_eps``), or with `non_shared` one per depth (names suffixed
``_{d}``).  The edge model projects the nodes first (``node_in``,
``node_out``, in node space) and then gathers them at the senders and
receivers; the node model sums its edge MLP's output at each receiver.
These gathers and sums are the plain ones of `ops/segment.py`, as the JAX
package's are plain `take` and `segment_sum` (no Pallas kernel).

`GeomolGNNOGBFeat` puts full-width atom and bond encoders in front and
takes no noise (the reference's forward swallows it); `GeomolGNNOGBFeatRandom`
appends noise columns after the encoders.  Both return (node, edge)
embeddings.  `GeomolGNNWrapperOGBFeat` is the fine-tune model over
`GeomolGNNOGBFeat`: mean pool and the output MLP;
`GeomolGNNWrapperOGBFeatRandom` (and its `...NonShared` sibling, one
meta-layer per depth) the same over `GeomolGNNOGBFeatRandom`.
`GeomolGNNWrapper` reads float features (the chemprop one-hots of
`qm9_geomol`), appends noise columns and runs `GeomolGNN` on them.  The
noise columns are float32 (zeros without a source), as the JAX models':
under the bf16 recipe they promote what they join, and the Linears
promote as flax `Dense` does.
"""
from __future__ import annotations

from typing import Any, Mapping, Optional

import torch
import torch.nn.functional as F
from torch import nn

from infomax3d_tpu_torch.models.base import (MLP, AtomEncoder, BondEncoder,
                                             PromotingLinear)
from infomax3d_tpu_torch.models.geomol import GeomolMLP
from infomax3d_tpu_torch.models.noise import noise_columns
from infomax3d_tpu_torch.ops.segment import (segment_mean, segment_sum,
                                             take_clipped)


class GeomolEdgeModel(nn.Module):
    def __init__(self, hidden_dim: int, n_layers: int):
        super().__init__()
        self.edge = PromotingLinear(hidden_dim, hidden_dim)
        self.node_in = PromotingLinear(hidden_dim, hidden_dim, bias=False)
        self.node_out = PromotingLinear(hidden_dim, hidden_dim, bias=False)
        self.mlp = GeomolMLP(hidden_dim, hidden_dim, n_layers)

    def forward(self, g, x: torch.Tensor, edge_attr: torch.Tensor):
        out = F.relu(self.edge(edge_attr)
                     + take_clipped(self.node_in(x), g.senders)
                     + take_clipped(self.node_out(x), g.receivers))
        return self.mlp(out)


class GeomolNodeModel(nn.Module):
    def __init__(self, hidden_dim: int, n_layers: int):
        super().__init__()
        self.node_mlp_1 = GeomolMLP(hidden_dim, hidden_dim, n_layers)
        self.node_mlp_2 = GeomolMLP(hidden_dim, hidden_dim, n_layers)

    def forward(self, g, x: torch.Tensor, edge_attr: torch.Tensor):
        out = segment_sum(self.node_mlp_1(edge_attr), g.receivers,
                          x.shape[0])
        return self.node_mlp_2(out)


class GeomolGNN(nn.Module):
    """The meta-layer stack (module docstring)."""

    def __init__(self, node_dim: int, edge_dim: int, hidden_dim: int = 300,
                 depth: int = 3, n_layers: int = 2, non_shared: bool = False):
        super().__init__()
        self.depth, self.non_shared = depth, non_shared
        self.node_init = GeomolMLP(node_dim, hidden_dim, n_layers)
        self.edge_init = GeomolMLP(edge_dim, hidden_dim, n_layers)
        for sfx in ([f"_{d}" for d in range(depth)] if non_shared
                    else [""]):
            self.add_module(f"edge_model{sfx}",
                            GeomolEdgeModel(hidden_dim, n_layers))
            self.add_module(f"node_model{sfx}",
                            GeomolNodeModel(hidden_dim, n_layers))
            self.register_parameter(f"edge_eps{sfx}",
                                    nn.Parameter(torch.zeros(1)))
            self.register_parameter(f"node_eps{sfx}",
                                    nn.Parameter(torch.zeros(1)))

    def forward(self, g, x: torch.Tensor, edge_attr: torch.Tensor):
        x = self.node_init(x)
        edge_attr = self.edge_init(edge_attr)
        for d in range(self.depth):
            sfx = f"_{d}" if self.non_shared else ""
            edge_attr = (1 + getattr(self, f"edge_eps{sfx}")) * edge_attr + \
                getattr(self, f"edge_model{sfx}")(g, x, edge_attr)
            x = (1 + getattr(self, f"node_eps{sfx}")) * x + \
                getattr(self, f"node_model{sfx}")(g, x, edge_attr)
        return x, edge_attr


class GeomolGNNOGBFeat(nn.Module):
    """Full-width atom / bond encoders, then ``gnn`` (a `GeomolGNN`);
    returns (node, edge) embeddings.  `noise` is accepted and unused."""

    FIELDS = ("hidden_dim", "depth", "n_layers")

    def __init__(self, hidden_dim: int = 300, depth: int = 3,
                 n_layers: int = 2):
        super().__init__()
        self.atom_encoder = AtomEncoder(hidden_dim)
        self.bond_encoder = BondEncoder(hidden_dim)
        self.gnn = GeomolGNN(hidden_dim, hidden_dim, hidden_dim, depth,
                             n_layers)

    @classmethod
    def from_config(cls, params: Mapping[str, Any]):
        return cls(**{k: v for k, v in params.items() if k in cls.FIELDS})

    def forward(self, g, noise=None):
        return self.gnn(g, self.atom_encoder(g.node_feat),
                        self.bond_encoder(g.edge_feat))


class GeomolGNNOGBFeatRandom(GeomolGNNOGBFeat):
    """`GeomolGNNOGBFeat` with node and edge noise columns appended after
    the encoders (its init MLPs take hidden + random_vec_dim columns);
    `non_shared` gives each depth its own meta-layer."""

    FIELDS = ("hidden_dim", "depth", "n_layers", "random_vec_dim",
              "random_vec_std", "non_shared")

    def __init__(self, hidden_dim: int = 300, depth: int = 3,
                 n_layers: int = 2, random_vec_dim: int = 10,
                 random_vec_std: float = 1.0, non_shared: bool = False):
        nn.Module.__init__(self)
        self.random_vec_dim, self.random_vec_std = random_vec_dim, \
            random_vec_std
        wide = hidden_dim + random_vec_dim
        self.atom_encoder = AtomEncoder(hidden_dim)
        self.bond_encoder = BondEncoder(hidden_dim)
        self.gnn = GeomolGNN(wide, wide, hidden_dim, depth, n_layers,
                             non_shared=non_shared)

    def forward(self, g, noise=None):
        x, e = with_noise(self, noise, self.atom_encoder(g.node_feat),
                          self.bond_encoder(g.edge_feat))
        return self.gnn(g, x, e)


def with_noise(model, noise, x: torch.Tensor, e: torch.Tensor):
    """(x, e) each with `model.random_vec_dim` float32 noise columns
    appended (node draw first), zeros without a source."""
    f32 = torch.empty(0, device=x.device)
    return tuple(torch.cat([t, noise_columns(
        noise, t.shape[0], model.random_vec_dim, model.random_vec_std,
        f32)], dim=-1) for t in (x, e))


class GeomolGNNWrapperOGBFeat(nn.Module):
    """The OGB-feature fine-tune model (reference `geomol_mpnn_ogb_feat.
    py:39-56`): ``node_gnn`` (a `GeomolGNNOGBFeat`, the OT generator's
    backbone of that name, so a `transfer_layers: [gnn.]` transfer lines up
    after the root ``gnn.`` -> ``node_gnn.`` rename), the mean over each
    graph's nodes and the ``output`` MLP (mid BatchNorm over the real
    graphs).  Keyword arguments are the JAX module's fields."""

    FIELDS = ("hidden_dim", "depth", "n_layers", "readout_layers",
              "readout_batchnorm", "readout_hidden_dim", "target_dim")

    def __init__(self, hidden_dim: int, depth: int = 3, n_layers: int = 2,
                 readout_layers: int = 2, readout_batchnorm: bool = True,
                 readout_hidden_dim: Optional[int] = None,
                 target_dim: int = 1):
        super().__init__()
        self.node_gnn = GeomolGNNOGBFeat(hidden_dim, depth, n_layers)
        self.output = MLP(hidden_dim, target_dim, readout_layers,
                          hidden_size=readout_hidden_dim or hidden_dim,
                          mid_batch_norm=readout_batchnorm)

    def forward(self, g, noise=None) -> torch.Tensor:
        """`noise` (the supervised step's dropout source) draws nothing:
        the model has no dropout."""
        x, _ = self.node_gnn(g)
        pooled = segment_mean(x, g.node_graph, g.graph_mask.shape[0])
        return self.output(pooled, g.graph_mask)


class GeomolGNNWrapperOGBFeatRandom(GeomolGNNWrapperOGBFeat):
    """The noise-augmented sibling (reference
    `geomol_mpnn_ogb_feat_random.py:48-74`): ``node_gnn`` is a
    `GeomolGNNOGBFeatRandom` (one meta-layer per depth with `non_shared`),
    then the mean pool and the ``output`` MLP."""

    FIELDS = GeomolGNNWrapperOGBFeat.FIELDS + ("random_vec_dim",
                                               "random_vec_std",
                                               "non_shared")

    def __init__(self, hidden_dim: int, depth: int = 3, n_layers: int = 2,
                 readout_layers: int = 2, readout_batchnorm: bool = True,
                 readout_hidden_dim: Optional[int] = None,
                 target_dim: int = 1, random_vec_dim: int = 10,
                 random_vec_std: float = 1.0, non_shared: bool = False):
        super().__init__(hidden_dim, depth, n_layers, readout_layers,
                         readout_batchnorm, readout_hidden_dim, target_dim)
        self.node_gnn = GeomolGNNOGBFeatRandom(
            hidden_dim, depth, n_layers, random_vec_dim, random_vec_std,
            non_shared)

    def forward(self, g, noise=None) -> torch.Tensor:
        x, _ = self.node_gnn(g, noise)
        pooled = segment_mean(x, g.node_graph, g.graph_mask.shape[0])
        return self.output(pooled, g.graph_mask)


class GeomolGNNWrapperOGBFeatRandomNonShared(GeomolGNNWrapperOGBFeatRandom):
    """Reference `geomol_mpnn_ogb_feat_random_non_shared.py:14-76`:
    `GeomolGNNWrapperOGBFeatRandom` with its meta-layers not shared across
    depth."""

    FIELDS = GeomolGNNWrapperOGBFeat.FIELDS + ("random_vec_dim",
                                               "random_vec_std")

    def __init__(self, hidden_dim: int, target_dim: int = 1, depth: int = 3,
                 n_layers: int = 2, readout_layers: int = 2,
                 readout_batchnorm: bool = True,
                 readout_hidden_dim: Optional[int] = None,
                 random_vec_dim: int = 10, random_vec_std: float = 1.0):
        super().__init__(hidden_dim, depth, n_layers, readout_layers,
                         readout_batchnorm, readout_hidden_dim, target_dim,
                         random_vec_dim, random_vec_std, non_shared=True)


class GeomolGNNWrapper(nn.Module):
    """Reference `geomol_mpnn.py:138-164` (the JAX `GeomolGNNWrapper`): the
    float node and edge features (`node_dim`, `edge_dim` wide; the CLI
    reads them off the dataset's first molecule) with noise columns
    appended, ``gnn`` (a `GeomolGNN`), the mean over each graph's nodes
    and the ``output`` MLP of width `hidden_dim`.  Under the default
    trainers the source gives masks alone, so the noise columns are zeros,
    as the JAX trainers' are."""

    FIELDS = ("hidden_dim", "node_dim", "edge_dim", "depth", "n_layers",
              "readout_layers", "readout_batchnorm", "target_dim",
              "random_vec_dim", "random_vec_std")

    def __init__(self, hidden_dim: int, node_dim: int, edge_dim: int,
                 depth: int = 3, n_layers: int = 2, readout_layers: int = 2,
                 readout_batchnorm: bool = True, target_dim: int = 1,
                 random_vec_dim: int = 10, random_vec_std: float = 1.0):
        super().__init__()
        self.random_vec_dim, self.random_vec_std = random_vec_dim, \
            random_vec_std
        self.gnn = GeomolGNN(node_dim + random_vec_dim,
                             edge_dim + random_vec_dim, hidden_dim, depth,
                             n_layers)
        self.output = MLP(hidden_dim, target_dim, readout_layers,
                          hidden_size=hidden_dim,
                          mid_batch_norm=readout_batchnorm)

    def forward(self, g, noise=None) -> torch.Tensor:
        x, e = with_noise(self, noise, g.node_feat.float(),
                          g.edge_feat.float())
        x, _ = self.gnn(g, x, e)
        pooled = segment_mean(x, g.node_graph, g.graph_mask.shape[0])
        return self.output(pooled, g.graph_mask)
