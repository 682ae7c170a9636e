"""PNA with noise columns (port of `PNAGNNRandom` and `PNARandom`,
infomax3d_tpu/models/pna_random.py, the reference's
`models/pna_gnn_random.py`): the OT generator's default backbone, and the
full model over it.

Atom and bond encoders emit ``hidden - random_vec_dim`` columns, one draw
of node and edge noise fills the rest, then `propagation_depth` PNA layers
(`models/pna.py::PNALayer`: the edge-combine kernel, the aggregates, the
posttrans MLP and the residual, with their dropout) over the noisy node
and edge states.  The noise columns are float32, as the JAX model's
(``std * normal``, or zeros without its 'random' rng): under the bf16
recipe they promote the encoders' bf16 columns they join, so every layer
runs float32 activations on bf16 weights (the float32 aggregates of the
multi-reduce kernel).  `PNARandom` reads the nodes out (min / max / mean
...) and applies the output MLP, as `PNA` does.
"""
from __future__ import annotations

from typing import Any, Mapping, Optional, Sequence

import torch
from torch import nn

from infomax3d_tpu_torch.models.base import MLP, AtomEncoder, BondEncoder
from infomax3d_tpu_torch.models.noise import noise_columns
from infomax3d_tpu_torch.models.pna import PNALayer
from infomax3d_tpu_torch.ops.segment import batch_readout


class PNAGNNRandom(nn.Module):
    """Keyword arguments are the JAX module's fields with its defaults;
    ``mp_layers.{i}`` are flax's ``mp_{i}``.  Returns the node embeddings
    [N, hidden_dim]."""

    FIELDS = ("random_vec_dim", "hidden_dim", "aggregators", "scalers",
              "random_vec_std", "residual", "pairwise_distances",
              "activation", "last_activation", "mid_batch_norm",
              "last_batch_norm", "batch_norm_momentum", "propagation_depth",
              "dropout", "posttrans_layers", "pretrans_layers")

    def __init__(self, random_vec_dim: int, hidden_dim: int,
                 aggregators: Sequence[str], scalers: Sequence[str],
                 random_vec_std: float = 1.0, residual: bool = True,
                 pairwise_distances: bool = False, activation: str = "relu",
                 last_activation: str = "none", mid_batch_norm: bool = False,
                 last_batch_norm: bool = False,
                 batch_norm_momentum: float = 0.1,
                 propagation_depth: int = 5, dropout: float = 0.0,
                 posttrans_layers: int = 1, pretrans_layers: int = 1):
        super().__init__()
        self.random_vec_dim, self.random_vec_std = random_vec_dim, \
            random_vec_std
        small = hidden_dim - random_vec_dim
        self.atom_encoder = AtomEncoder(small)
        self.bond_encoder = BondEncoder(small)
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

    @classmethod
    def from_config(cls, params: Mapping[str, Any]) -> "PNAGNNRandom":
        return cls(**{k: v for k, v in params.items() if k in cls.FIELDS})

    def forward(self, g, noise=None) -> torch.Tensor:
        h = self.atom_encoder(g.node_feat)
        e = self.bond_encoder(g.edge_feat)
        f32 = torch.empty(0, device=h.device)
        h = torch.cat([h, noise_columns(noise, h.shape[0],
                                        self.random_vec_dim,
                                        self.random_vec_std, f32)], dim=-1)
        e = torch.cat([e, noise_columns(noise, e.shape[0],
                                        self.random_vec_dim,
                                        self.random_vec_std, f32)], dim=-1)
        for layer in self.mp_layers:
            h = layer(g, h, e, noise)
        return h


class PNARandom(nn.Module):
    """PNA over `PNAGNNRandom` (reference `pna_gnn_random.py:13-52`, the
    JAX `PNARandom`): ``node_gnn``, the readout and the ``output`` MLP.
    Keyword arguments are the JAX module's fields.  Under the default
    trainers the source gives masks alone, so the noise columns are zeros,
    as the JAX trainers' are (they pass no 'random' rng)."""

    FIELDS = ("hidden_dim", "target_dim", "random_vec_dim",
              "random_vec_std", "aggregators", "scalers",
              "readout_aggregators", "readout_batchnorm",
              "readout_hidden_dim", "readout_layers", "residual",
              "pairwise_distances", "activation", "last_activation",
              "mid_batch_norm", "last_batch_norm", "propagation_depth",
              "dropout", "posttrans_layers", "pretrans_layers",
              "batch_norm_momentum")

    def __init__(self, hidden_dim: int, target_dim: int, random_vec_dim: int,
                 random_vec_std: float, aggregators: Sequence[str],
                 scalers: Sequence[str], readout_aggregators: Sequence[str],
                 readout_batchnorm: bool = True,
                 readout_hidden_dim: Optional[int] = None,
                 readout_layers: int = 2, batch_norm_momentum: float = 0.1,
                 **gnn):
        super().__init__()
        self.readout_aggregators = tuple(readout_aggregators)
        self.node_gnn = PNAGNNRandom(
            random_vec_dim, hidden_dim, aggregators, scalers,
            random_vec_std=random_vec_std,
            batch_norm_momentum=batch_norm_momentum, **gnn)
        self.output = MLP(hidden_dim * len(self.readout_aggregators),
                          target_dim, readout_layers,
                          hidden_size=readout_hidden_dim or hidden_dim,
                          mid_batch_norm=readout_batchnorm,
                          batch_norm_momentum=batch_norm_momentum)

    def forward(self, g, noise=None) -> torch.Tensor:
        h = self.node_gnn(g, noise)
        return self.output(batch_readout(g, h, self.readout_aggregators),
                           g.graph_mask)
