"""Net3DAE — the encoder / decoder Net3D of the autoencoder trainer (port
of `Net3DAE` and `Net3DDistancePredictor`, infomax3d_tpu/models/
net3d_vae.py; reference `models/net3d_VAE.py:15-135`).

On a receiver-sorted CSR batch of complete graphs with edge distances:
the node embedding (or the atom encoder), the edge MLP on the (Fourier
encoded) distances followed by a second SiLU, as in the reference, the
encoder's flat `Net3DLayer`s (``enc_{i}``), an optional node-wise MLP, the
latent readout (the concat of the readout aggregators, no output MLP), the
decoder's layers (``dec_{i}``), and a distance for every pair: over the
graph's own complete-graph edges, or over the edges of a `pairs` view
with the same node layout.  With `distance_net` the symmetrised net
``softplus(dn([h_s ‖ h_r]) + dn([h_r ‖ h_s]))`` predicts it (the
edge-combine kernel and its pair segment sum at width 1, as in
`models/transformer.py`), else the norm of the projected embeddings'
difference.  Returns ``(latent [G, D * len(aggregators)], distances
[E])``.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from infomax3d_tpu_torch.models.base import MLP, AtomEncoder
from infomax3d_tpu_torch.models.net3d import Net3DLayer
from infomax3d_tpu_torch.models.transformer import (embedding_distances,
                                                    symmetric_distances)
from infomax3d_tpu_torch.ops.encodings import fourier_encode_dist
from infomax3d_tpu_torch.ops.segment import batch_readout


class Net3DAE(nn.Module):
    """The JAX `Net3DAE`.  `target_dim`, `readout_batchnorm`,
    `readout_layers`, `readout_hidden_dim` and `node_wise_output_layers`
    are accepted for config compatibility and unused, as there; the
    encoder's depth is `encoder_depth`, or `propagation_depth` when it is
    0.  `dropout` acts in the edge input and the encoder and decoder
    layers (not in the node-wise encoder or the distance heads, as in
    JAX); the masks come from the noise source the forward is given."""

    def __init__(self, hidden_dim: int, readout_aggregators: Sequence[str],
                 batch_norm: bool = False, node_wise_encoder_layers: int = 0,
                 node_wise_output_layers: int = 0,
                 batch_norm_momentum: float = 0.1, reduce_func: str = "sum",
                 dropout: float = 0.0, encoder_depth: int = 4,
                 decoder_depth: int = 4, projection_dim: int = 3,
                 distance_net: bool = True, projection_layers: int = 1,
                 fourier_encodings: int = 0, activation: str = "SiLU",
                 update_net_layers: int = 2, message_net_layers: int = 2,
                 use_node_features: bool = False, target_dim: int = 0,
                 readout_batchnorm: bool = True, readout_layers: int = 1,
                 readout_hidden_dim: Optional[int] = None,
                 propagation_depth: int = 0):
        super().__init__()
        del node_wise_output_layers, target_dim, readout_batchnorm
        del readout_layers, readout_hidden_dim
        self.readout_aggregators = tuple(readout_aggregators)
        self.fourier_encodings = fourier_encodings
        bn = dict(mid_batch_norm=batch_norm, last_batch_norm=batch_norm,
                  batch_norm_momentum=batch_norm_momentum,
                  mid_activation=activation)
        if use_node_features:
            self.atom_encoder = AtomEncoder(hidden_dim)
        else:
            self.node_embedding = nn.Parameter(torch.randn(hidden_dim))
        edge_in = 2 * fourier_encodings + 1 if fourier_encodings > 0 else 1
        self.edge_input = MLP(edge_in, hidden_dim, 1, hidden_size=hidden_dim,
                              last_activation=activation, dropout=dropout,
                              **bn)

        def layer():
            return Net3DLayer(hidden_dim, batch_norm, batch_norm_momentum,
                              activation, reduce_func, message_net_layers,
                              update_net_layers, dropout)
        self.encoder_depth = encoder_depth or propagation_depth
        self.decoder_depth = decoder_depth
        for i in range(self.encoder_depth):
            setattr(self, f"enc_{i}", layer())
        self.node_wise_encoder = (MLP(
            hidden_dim, hidden_dim, node_wise_encoder_layers,
            hidden_size=hidden_dim, last_activation="none", **bn)
            if node_wise_encoder_layers > 0 else None)
        for i in range(decoder_depth):
            setattr(self, f"dec_{i}", layer())
        self.distance_net = (MLP(2 * hidden_dim, 1, projection_layers,
                                 hidden_size=projection_dim,
                                 mid_batch_norm=True)
                             if distance_net else None)
        self.node_projection_net = (MLP(
            hidden_dim, projection_dim, projection_layers, hidden_size=32,
            mid_batch_norm=True)
            if not distance_net and projection_dim > 0 else None)

    def forward(self, g, pairs=None, noise=None):
        if hasattr(self, "atom_encoder"):
            h = self.atom_encoder(g.node_feat)
        else:
            h = self.node_embedding[None, :].expand(g.num_nodes, -1)
        d = g.edge_dist
        if self.fourier_encodings > 0:
            d = fourier_encode_dist(d, num_encodings=self.fourier_encodings)
        else:
            d = d[:, None]
        e = F.silu(self.edge_input(d, g.edge_mask, noise=noise))  # extra
        for i in range(self.encoder_depth):
            h, e = getattr(self, f"enc_{i}")(g, h, e, noise)
        if self.node_wise_encoder is not None:
            h = self.node_wise_encoder(h, g.node_mask)
        latent = batch_readout(g, h, self.readout_aggregators)
        for i in range(self.decoder_depth):
            h, e = getattr(self, f"dec_{i}")(g, h, e, noise)
        pg = g if pairs is None else pairs
        if self.distance_net is not None:
            return latent, symmetric_distances(self.distance_net, h, pg)[:, 0]
        if self.node_projection_net is not None:
            h = self.node_projection_net(h, g.node_mask)
        return latent, embedding_distances(h, pg)


class Net3DDistancePredictor(nn.Module):
    """Reference `models/net3d_distance_predictor.py:15-110`: `Net3DAE`
    (``net``) with the reference's flat kwargs (`propagation_depth` the
    encoder's depth).  Returns ``(latent, distances)``, or the per-pair
    predictions [E, 1] when `pairs` is given (the distance predictor
    trainer's contract)."""

    def __init__(self, hidden_dim: int, readout_aggregators: Sequence[str],
                 batch_norm: bool = False, node_wise_encoder_layers: int = 0,
                 node_wise_output_layers: int = 0,
                 batch_norm_momentum: float = 0.1, reduce_func: str = "sum",
                 dropout: float = 0.0, propagation_depth: int = 4,
                 decoder_depth: int = 0, projection_dim: int = 3,
                 distance_net: bool = True, projection_layers: int = 1,
                 fourier_encodings: int = 0, activation: str = "SiLU",
                 update_net_layers: int = 2, message_net_layers: int = 2,
                 use_node_features: bool = False):
        super().__init__()
        self.net = Net3DAE(
            hidden_dim, readout_aggregators, batch_norm=batch_norm,
            node_wise_encoder_layers=node_wise_encoder_layers,
            node_wise_output_layers=node_wise_output_layers,
            batch_norm_momentum=batch_norm_momentum, reduce_func=reduce_func,
            dropout=dropout, encoder_depth=propagation_depth,
            decoder_depth=decoder_depth, projection_dim=projection_dim,
            distance_net=distance_net, projection_layers=projection_layers,
            fourier_encodings=fourier_encodings, activation=activation,
            update_net_layers=update_net_layers,
            message_net_layers=message_net_layers,
            use_node_features=use_node_features)

    def forward(self, g, pairs=None, noise=None):
        out = self.net(g, pairs, noise)
        if pairs is not None:
            return out[1][:, None]
        return out
