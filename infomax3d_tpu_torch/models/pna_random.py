"""PNA with noise columns (port of `PNAGNNRandom`, infomax3d_tpu/models/
pna_random.py, the reference's `models/pna_gnn_random.py`): the OT
generator's default backbone.

Atom and bond encoders emit ``hidden - random_vec_dim`` columns, one draw
of node and edge noise fills the rest, then `propagation_depth` PNA layers
(`models/pna.py::PNALayer`: the edge-combine kernel, the aggregates, the
posttrans MLP and the residual, with their dropout) over the noisy node
and edge states.
"""
from __future__ import annotations

from typing import Any, Mapping, Sequence

import torch
from torch import nn

from infomax3d_tpu_torch.models.base import AtomEncoder, BondEncoder
from infomax3d_tpu_torch.models.noise import noise_columns
from infomax3d_tpu_torch.models.pna import PNALayer


class PNAGNNRandom(nn.Module):
    """Keyword arguments are the JAX module's fields with its defaults;
    ``mp_layers.{i}`` are flax's ``mp_{i}``.  Returns the node embeddings
    [N, hidden_dim].  The port's `PNALayer` has no pairwise distances:
    `pairwise_distances` raises."""

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
        if pairwise_distances:
            raise NotImplementedError(
                "PNAGNNRandom pairwise_distances is not ported (the port's "
                "PNALayer)")
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
                     pretrans_layers=pretrans_layers, dropout=dropout)
            for _ in range(propagation_depth))

    @classmethod
    def from_config(cls, params: Mapping[str, Any]) -> "PNAGNNRandom":
        return cls(**{k: v for k, v in params.items() if k in cls.FIELDS})

    def forward(self, g, noise=None) -> torch.Tensor:
        h = self.atom_encoder(g.node_feat)
        e = self.bond_encoder(g.edge_feat)
        h = torch.cat([h, noise_columns(noise, h.shape[0],
                                        self.random_vec_dim,
                                        self.random_vec_std, h)], dim=-1)
        e = torch.cat([e, noise_columns(noise, e.shape[0],
                                        self.random_vec_dim,
                                        self.random_vec_std, e)], dim=-1)
        for layer in self.mp_layers:
            h = layer(g, h, e, noise)
        return h
