"""The edge-update PNA backbone with noise columns (port of
`PNALayerEdgeUpdate` and `PNAGNNRandomEdgeUpdate`, infomax3d_tpu/models/
random_variants.py, the reference's `models/pna_edge_update_random.py`),
and the noise sources that feed it.

Per layer, in the JAX package's order: ``z = relu(edge(e) + node_in(h[s])
+ node_out(h[r]))`` (gather first, then the Linear), the pretrans MLP,
``e' = (1 + edge_eps) e + z``, messages ``posttrans_1(e')`` aggregated at
each receiver by the PNA aggregators and scalers, and ``h' = (1 +
node_eps) h + posttrans_2(agg)``.  The sender gather's backward is the
sender-keyed segment-sum kernel, the receiver gather's the CSR segment-sum
kernel, and a float32 aggregate the CSR multi-reduce kernel.

Randomness comes from a noise source with ``normal(shape)`` and
``uniform(shape)`` (float32, standard normal and U[0, 1)), called in the
JAX model's order of `jax.random` draws: `GeneratorNoise` draws from a
`torch.Generator` and records its draws, `ReplayNoise` hands out given
draws again, in order.  Without a source the noise is zero, as the JAX
model's without its 'random' rng.
"""
from __future__ import annotations

from typing import Any, List, Mapping, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from infomax3d_tpu_torch.models.base import MLP, AtomEncoder, BondEncoder
from infomax3d_tpu_torch.models.geomol import GeomolMLP
from infomax3d_tpu_torch.ops.aggregate import (gather_dst, gather_src,
                                               pna_aggregate_parts)


class GeneratorNoise:
    """Draws from `generator` on the generator's own device (a CUDA
    generator draws on the card, with no copy from the host); every draw
    is kept in `draws` as ``(kind, tensor)`` so that `ReplayNoise` can hand
    the same draws to a second pass."""

    def __init__(self, generator: torch.Generator):
        self.generator = generator
        self.draws: List[Tuple[str, torch.Tensor]] = []

    def _draw(self, kind: str, shape) -> torch.Tensor:
        fn = torch.randn if kind == "normal" else torch.rand
        t = fn(tuple(shape), generator=self.generator,
               device=self.generator.device)
        self.draws.append((kind, t))
        return t

    def normal(self, shape) -> torch.Tensor:
        return self._draw("normal", shape)

    def uniform(self, shape) -> torch.Tensor:
        return self._draw("uniform", shape)


class ReplayNoise:
    """Given draws ``(kind, tensor)`` handed out in order; a draw of another
    kind or shape than the next one raises, as does running out."""

    def __init__(self, draws: Sequence[Tuple[str, torch.Tensor]]):
        self.draws = list(draws)
        self.used = 0

    def _next(self, kind: str, shape) -> torch.Tensor:
        if self.used >= len(self.draws):
            raise RuntimeError(f"ReplayNoise: no draw left for {kind} "
                               f"{tuple(shape)}")
        k, t = self.draws[self.used]
        if k != kind or tuple(t.shape) != tuple(shape):
            raise RuntimeError(f"ReplayNoise: draw {self.used} is {k} "
                               f"{tuple(t.shape)}, asked for {kind} "
                               f"{tuple(shape)}")
        self.used += 1
        return t

    def normal(self, shape) -> torch.Tensor:
        return self._next("normal", shape)

    def uniform(self, shape) -> torch.Tensor:
        return self._next("uniform", shape)


class PNALayerEdgeUpdate(nn.Module):
    """One edge-update PNA layer (module docstring).  Submodules carry the
    JAX module's names: ``edge``, ``node_in``, ``node_out`` (no bias),
    ``pretrans``, ``edge_eps``, ``posttrans_1``, ``node_eps``,
    ``posttrans_2``."""

    def __init__(self, in_dim: int, out_dim: int, aggregators: Sequence[str],
                 scalers: Sequence[str], activation: str = "relu",
                 last_activation: str = "none", posttrans_layers: int = 2,
                 pretrans_layers: int = 1):
        super().__init__()
        self.aggregators, self.scalers = list(aggregators), list(scalers)
        self.edge = nn.Linear(in_dim, in_dim)
        self.node_in = nn.Linear(in_dim, in_dim, bias=False)
        self.node_out = nn.Linear(in_dim, in_dim, bias=False)
        acts = dict(mid_activation=activation, last_activation=last_activation)
        self.pretrans = MLP(in_dim, in_dim, pretrans_layers,
                            hidden_size=in_dim, **acts)
        self.edge_eps = nn.Parameter(torch.zeros(1))
        self.posttrans_1 = MLP(in_dim, in_dim, posttrans_layers,
                               hidden_size=out_dim, **acts)
        self.node_eps = nn.Parameter(torch.zeros(1))
        n_parts = len(aggregators) * (len(scalers) if len(scalers) > 1 else 1)
        self.posttrans_2 = MLP(n_parts * in_dim, out_dim, posttrans_layers,
                               hidden_size=out_dim, **acts)

    def forward(self, g, h: torch.Tensor, e: torch.Tensor):
        z = F.relu(self.edge(e) + self.node_in(gather_src(g, h))
                   + self.node_out(gather_dst(g, h)))
        z = self.pretrans(z, g.edge_mask)
        e_out = (1.0 + self.edge_eps) * e + z
        msg = self.posttrans_1(e_out, g.edge_mask)
        agg = torch.cat(pna_aggregate_parts(g, msg, self.aggregators,
                                            self.scalers, avg_d_log=1.0),
                        dim=-1)
        h_out = (1.0 + self.node_eps) * h + self.posttrans_2(agg, g.node_mask)
        return h_out, e_out


class PNAGNNRandomEdgeUpdate(nn.Module):
    """The GNN-only edge-update variant: full-width atom and bond encoders,
    noise columns concatenated and projected back to `hidden_dim` by
    2-layer GeoMol MLPs (``node_init``, ``edge_init``), then
    `propagation_depth` layers (``mp_layers.{i}``).  Returns the node
    embeddings [N, hidden_dim].  Keyword arguments are the JAX module's
    fields with its defaults (`residual` is a field the JAX layer never
    reads); BatchNorm in the MLPs and dropout are not ported and raise."""

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
        bad = {k: v for k, v in {"mid_batch_norm": mid_batch_norm,
                                 "last_batch_norm": last_batch_norm,
                                 "dropout": dropout > 0 and dropout}.items()
               if v}
        if bad:
            raise NotImplementedError(
                f"PNAGNNRandomEdgeUpdate options not ported: {bad}")
        self.random_vec_dim = random_vec_dim
        self.random_vec_std = random_vec_std
        self.atom_encoder = AtomEncoder(hidden_dim)
        self.bond_encoder = BondEncoder(hidden_dim)
        self.node_init = GeomolMLP(hidden_dim + random_vec_dim, hidden_dim, 2)
        self.edge_init = GeomolMLP(hidden_dim + random_vec_dim, hidden_dim, 2)
        self.mp_layers = nn.ModuleList(
            PNALayerEdgeUpdate(hidden_dim, hidden_dim, aggregators, scalers,
                               activation, last_activation, posttrans_layers,
                               pretrans_layers)
            for _ in range(propagation_depth))

    @classmethod
    def from_config(cls, params: Mapping[str, Any]
                    ) -> "PNAGNNRandomEdgeUpdate":
        """Other keys of a config are dropped, as the JAX package drops
        them (e.g. `readout_batchnorm`)."""
        return cls(**{k: v for k, v in params.items() if k in cls.FIELDS})

    def _noise(self, noise, rows: int, like: torch.Tensor) -> torch.Tensor:
        shape = (rows, self.random_vec_dim)
        if noise is None:
            return like.new_zeros(shape)
        return self.random_vec_std * noise.normal(shape).to(like.dtype)

    def forward(self, g, noise=None) -> torch.Tensor:
        h = self.atom_encoder(g.node_feat)
        e = self.bond_encoder(g.edge_feat)
        h = self.node_init(torch.cat([h, self._noise(noise, h.shape[0], h)],
                                     dim=-1))
        e = self.edge_init(torch.cat([e, self._noise(noise, e.shape[0], e)],
                                     dim=-1))
        for layer in self.mp_layers:
            h, e = layer(g, h, e)
        return h
