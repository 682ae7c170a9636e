"""Net3D — the 3D encoder over complete graphs (port of `Net3D`,
`Net3DLayer`, `Net3DDense`, `Net3DDenseLayer` and `_dense_readout`,
infomax3d_tpu/models/net3d.py), in two layouts with the same parameters.

`Net3D` (flat) reads a receiver-sorted CSR batch of complete graphs with
each edge's distance (`GraphBatch.edge_dist`).  Each layer's message MLP
takes ``[h[src] ‖ h[dst] ‖ e]`` through `FCLayer`'s `EdgeInput` (the
edge-combine kernel forward, the pair segment sum backward), adds the
message to the edge state, gates it and reduces it at each receiver with
`edge_aggregate` (the CSR sum kernel: float32 for "sum", the messages'
dtype for "mean"), as the JAX `Net3DLayer` does on a CSR batch.  The
readout is `batch_readout` over the graphs.

Each molecule is one row of [G, n] node slots; its complete graph is the
[n, n] pair grid minus the diagonal, restricted to real atoms (`emask`).
Distances come from the coordinates in-model (NaN-free: the masked pairs
take sqrt(1)), go through Fourier encodings and the edge MLP (plus the
reference's extra silu), and each layer gates its messages, averages them
over the senders (axis 1) and updates the nodes.  The readout is min / max /
mean over real atoms.  No Pallas kernel runs in the dense layout, so plain
PyTorch is its port.  Module names follow the reference's state_dict
(`mp_layers.{i}.message_network`, `soft_edge_network`, `node_embedding`,
`atom_encoder` with `use_node_features`), in both layouts.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from infomax3d_tpu_torch.models.base import (MLP, AtomEncoder, EdgeInput,
                                             PairGridInput, PromotingLinear)
from infomax3d_tpu_torch.ops.aggregate import edge_aggregate
from infomax3d_tpu_torch.ops.encodings import fourier_encode_dist
from infomax3d_tpu_torch.ops.segment import batch_readout


def dense_readout(h: torch.Tensor, node_mask: torch.Tensor,
                  aggregators: Sequence[str],
                  sizes: torch.Tensor) -> torch.Tensor:
    """Concat of the `aggregators` (sum / mean / max / min) over the real
    atoms of each graph of a dense [G, n, D] tensor.  max / min of an empty
    graph are 0; amax / amin split a tie's gradient evenly, as jnp.max
    does."""
    m = node_mask[..., None]
    zero = torch.zeros((), dtype=h.dtype, device=h.device)
    hz = torch.where(m, h, zero)
    big = torch.finfo(h.dtype).max
    has = (sizes > 0)[:, None]
    outs = []
    for a in aggregators:
        if a == "sum":
            outs.append(hz.sum(dim=1))
        elif a == "mean":
            outs.append(hz.sum(dim=1)
                        / sizes.clamp(min=1).to(h.dtype)[:, None])
        elif a == "max":
            outs.append(torch.where(has, h.masked_fill(~m, -big).amax(dim=1),
                                    zero))
        elif a == "min":
            outs.append(torch.where(has, h.masked_fill(~m, big).amin(dim=1),
                                    zero))
        else:
            raise ValueError(f"unknown readout aggregator: {a}")
    return torch.cat(outs, dim=-1)


class Net3DDenseLayer(nn.Module):
    """One Net3D message-passing layer on the dense pair grid (reference
    `models/net3d.py` Net3DLayer)."""

    def __init__(self, hidden_dim: int, batch_norm: bool = False,
                 batch_norm_momentum: float = 0.1,
                 mid_activation: str = "SiLU", reduce_func: str = "sum",
                 message_net_layers: int = 2, update_net_layers: int = 2,
                 dropout: float = 0.0):
        super().__init__()
        if reduce_func not in ("sum", "mean"):
            raise ValueError(f"reduce function not supported: {reduce_func}")
        self.reduce_func = reduce_func
        bn = dict(mid_batch_norm=batch_norm, last_batch_norm=batch_norm,
                  batch_norm_momentum=batch_norm_momentum,
                  mid_activation=mid_activation, dropout=dropout)
        self.message_network = MLP(3 * hidden_dim, hidden_dim,
                                   message_net_layers, hidden_size=hidden_dim,
                                   last_activation=mid_activation, **bn)
        self.soft_edge_network = PromotingLinear(hidden_dim, 1)
        self.update_network = MLP(hidden_dim, hidden_dim, update_net_layers,
                                  hidden_size=hidden_dim,
                                  last_activation="none", **bn)

    def forward(self, h, e, emask, node_mask, deg, noise=None):
        message = self.message_network(PairGridInput(h, e), emask,
                                       noise=noise)
        e_new = e + message
        gate = torch.sigmoid(self.soft_edge_network(message))
        gated = torch.where(emask[..., None], message * gate,
                            torch.zeros((), dtype=message.dtype,
                                        device=message.device))
        agg = gated.sum(dim=1)                              # over senders
        if self.reduce_func == "mean":
            agg = agg / deg.clamp(min=1.0)[..., None]
        upd = self.update_network(agg + h, node_mask, noise=noise)
        return upd + h, e_new


class Net3DLayer(Net3DDenseLayer):
    """One Net3D message-passing layer on a CSR batch of complete graphs
    (reference `models/net3d.py:84-125`, the JAX `Net3DLayer`)."""

    def forward(self, g, h, e, noise=None):
        message = self.message_network(
            EdgeInput(h, g.senders, g.receivers, e, g.csr_row_ptr,
                      g.csc_row_ptr, g.csc_perm, halo=g.halo_send),
            g.edge_mask, noise=noise)
        e_new = e + message
        gate = torch.sigmoid(self.soft_edge_network(message))
        agg = edge_aggregate(g, message * gate, self.reduce_func)
        upd = self.update_network(agg + h, g.node_mask, noise=noise)
        return upd + h, e_new


class Net3DDense(nn.Module):
    """Net3D on dense complete graphs (reference `models/net3d.py:15-84`,
    the JAX package's `Net3DDense`).  Keyword arguments are the
    `model3d_parameters` of the reference configs (keys the class lacks,
    such as `hidden_edge_dim`, are dropped by `from_config`)."""

    LAYER = Net3DDenseLayer

    def __init__(self, hidden_dim: int, target_dim: int,
                 readout_aggregators: Sequence[str],
                 batch_norm: bool = False, node_wise_output_layers: int = 2,
                 readout_batchnorm: bool = True,
                 batch_norm_momentum: float = 0.1, reduce_func: str = "sum",
                 dropout: float = 0.0, propagation_depth: int = 4,
                 readout_layers: int = 2,
                 readout_hidden_dim: Optional[int] = None,
                 fourier_encodings: int = 0, activation: str = "SiLU",
                 update_net_layers: int = 2, message_net_layers: int = 2,
                 use_node_features: bool = False):
        super().__init__()
        self.readout_aggregators = tuple(readout_aggregators)
        self.fourier_encodings = fourier_encodings
        bn = dict(mid_batch_norm=batch_norm, last_batch_norm=batch_norm,
                  batch_norm_momentum=batch_norm_momentum,
                  mid_activation=activation, dropout=dropout)
        if use_node_features:
            self.atom_encoder = AtomEncoder(hidden_dim)
        else:
            self.node_embedding = nn.Parameter(torch.randn(hidden_dim))
        edge_in = 2 * fourier_encodings + 1 if fourier_encodings > 0 else 1
        self.edge_input = MLP(edge_in, hidden_dim, 1, hidden_size=hidden_dim,
                              last_activation=activation, **bn)
        self.mp_layers = nn.ModuleList(
            self.LAYER(hidden_dim, batch_norm, batch_norm_momentum,
                       activation, reduce_func, message_net_layers,
                       update_net_layers, dropout)
            for _ in range(propagation_depth))
        self.node_wise_output_network = None
        if node_wise_output_layers > 0:
            self.node_wise_output_network = MLP(
                hidden_dim, hidden_dim, node_wise_output_layers,
                hidden_size=hidden_dim, last_activation="none", **bn)
        self.output = MLP(hidden_dim * len(self.readout_aggregators),
                          target_dim, readout_layers,
                          hidden_size=readout_hidden_dim or hidden_dim,
                          mid_batch_norm=readout_batchnorm,
                          batch_norm_momentum=batch_norm_momentum)

    @classmethod
    def from_config(cls, model3d_parameters) -> "Net3DDense":
        """Build from a config's `model3d_parameters`, dropping the keys the
        class lacks (the JAX package's `cli/train.py` does the same)."""
        import inspect
        known = inspect.signature(cls.__init__).parameters
        return cls(**{k: v for k, v in dict(model3d_parameters).items()
                      if k in known and k != "self"})

    def forward(self, g, noise=None) -> torch.Tensor:
        """`noise` draws the dropout masks in training, in the JAX
        forward's order (the edge input, each layer's message and update
        networks, the node-wise output network)."""
        node_mask = g.node_mask
        G, n = node_mask.shape
        sizes = node_mask.sum(dim=1)
        eye = torch.eye(n, dtype=torch.bool, device=node_mask.device)
        emask = node_mask[:, :, None] & node_mask[:, None, :] & ~eye
        if hasattr(self, "atom_encoder"):
            h = self.atom_encoder(g.node_feat.reshape(G * n, -1)).reshape(
                G, n, -1)
        else:
            h = self.node_embedding[None, None, :].expand(G, n, -1)
        diff = g.coords[:, :, None, :] - g.coords[:, None, :, :]
        # keep sqrt off exact zeros (diagonal, padding): NaN-free gradients
        d2 = (diff * diff).sum(dim=-1)
        d = torch.sqrt(torch.where(emask, d2, torch.ones(
            (), dtype=d2.dtype, device=d2.device)))
        if self.fourier_encodings > 0:
            d = fourier_encode_dist(d, num_encodings=self.fourier_encodings)
        else:
            d = d[..., None]
        e = F.silu(self.edge_input(d, emask, noise=noise))   # extra silu
        deg = emask.sum(dim=1).to(e.dtype)                  # [G, n] in-degree
        for layer in self.mp_layers:
            h, e = layer(h, e, emask, node_mask, deg, noise)
        if self.node_wise_output_network is not None:
            h = self.node_wise_output_network(h, node_mask, noise=noise)
        readout = dense_readout(h, node_mask, self.readout_aggregators, sizes)
        return self.output(readout, g.graph_mask)


class Net3D(Net3DDense):
    """Net3D on a receiver-sorted CSR batch of complete graphs with edge
    distances (reference `models/net3d.py:14-81`, the JAX `Net3D`); the
    parameters are Net3DDense's."""

    LAYER = Net3DLayer

    def forward(self, g, noise=None) -> torch.Tensor:
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
        for layer in self.mp_layers:
            h, e = layer(g, h, e, noise)
        if self.node_wise_output_network is not None:
            h = self.node_wise_output_network(h, g.node_mask, noise=noise)
        return self.output(batch_readout(g, h, self.readout_aggregators),
                           g.graph_mask)
