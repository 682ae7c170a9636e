"""PNA, the 2D encoder, as published (Corso et al. 2020, and the 3D Infomax
repository's `models/pna.py`): atom and bond embeddings summed over the
OGB code columns; per layer the pretrans MLP on each bond's
``[h[sender] ‖ h[receiver] ‖ e]``, the mean / max / min / std of the
messages at each receiver under the identity, amplification and
attenuation degree scalers, the posttrans MLP on ``[h ‖ aggregates]`` and
the residual; then the min / max / mean readout per molecule and the
output MLP.  Nodes without bonds aggregate to 0."""
from __future__ import annotations

from typing import Dict, Mapping

import torch

from bench_port.reference.nn import (Layers, Spec, embedding_spec,
                                     mlp_layout, mlp_spec, readout,
                                     scatter_extreme, scatter_mean)

ATOM_VOCAB = (119, 5, 12, 12, 10, 6, 6, 2, 2)
BOND_VOCAB = (5, 6, 2)
STD_EPS = 1e-5


class PNAShape:
    """The widths and layer layouts of a config's `model_parameters`."""

    def __init__(self, mp: Mapping):
        if float(mp.get("dropout", 0.0)) != 0.0:
            raise NotImplementedError("the reference PNA runs dropout 0")
        if mp.get("pairwise_distances"):
            raise NotImplementedError("the reference PNA has no "
                                      "pairwise_distances column")
        self.D = int(mp["hidden_dim"])
        self.depth = int(mp["propagation_depth"])
        self.aggregators = tuple(mp["aggregators"])
        self.scalers = tuple(mp["scalers"])
        self.readout_aggregators = tuple(mp["readout_aggregators"])
        self.residual = bool(mp.get("residual", True))
        self.avg_d_log = 1.0
        act = mp.get("activation", "relu")
        last = mp.get("last_activation", "none")
        mid_bn = bool(mp.get("mid_batch_norm", False))
        last_bn = bool(mp.get("last_batch_norm", False))
        D = self.D
        self.pretrans = mlp_layout(3 * D, D, int(mp.get("pretrans_layers", 1)),
                                   D, act, last, mid_bn, last_bn)
        parts = len(self.aggregators) * len(self.scalers) + 1
        self.posttrans = mlp_layout(parts * D, D,
                                    int(mp.get("posttrans_layers", 1)), D,
                                    act, last, mid_bn, last_bn)
        self.output = mlp_layout(
            D * len(self.readout_aggregators), int(mp["target_dim"]),
            int(mp.get("readout_layers", 2)),
            int(mp.get("readout_hidden_dim") or D), "relu", "none",
            bool(mp.get("readout_batchnorm", True)), False)

    def spec(self) -> Spec:
        spec: Spec = []
        for i, v in enumerate(ATOM_VOCAB):
            spec += embedding_spec(
                f"node_gnn.atom_encoder.atom_embedding_list.{i}", v, self.D)
        for i, v in enumerate(BOND_VOCAB):
            spec += embedding_spec(
                f"node_gnn.bond_encoder.bond_embedding_list.{i}", v, self.D)
        for l in range(self.depth):
            base = f"node_gnn.mp_layers.{l}"
            spec += mlp_spec(f"{base}.pretrans", self.pretrans)
            spec += mlp_spec(f"{base}.posttrans", self.posttrans)
        return spec + mlp_spec("output", self.output)


def pna_forward(shape: PNAShape, L: Layers, g: Dict[str, torch.Tensor]
                ) -> torch.Tensor:
    """[B, target_dim] from the 2D batch `g` (``atoms`` [N, 9], ``bonds``
    [E, 3], ``senders`` / ``receivers`` [E], ``node_graph`` [N],
    ``n_graphs``)."""
    N = g["atoms"].shape[0]
    src, dst = g["senders"], g["receivers"]
    h = sum(L.embed(f"node_gnn.atom_encoder.atom_embedding_list.{i}",
                    g["atoms"][:, i]) for i in range(len(ATOM_VOCAB)))
    e = sum(L.embed(f"node_gnn.bond_encoder.bond_embedding_list.{i}",
                    g["bonds"][:, i]) for i in range(len(BOND_VOCAB)))
    deg = torch.bincount(dst, minlength=N)
    has = (deg > 0)[:, None]
    log_deg = torch.log(deg.float() + 1.0)[:, None]
    scales = {"identity": None,
              "amplification": log_deg / shape.avg_d_log,
              "attenuation": torch.where(
                  has, shape.avg_d_log / log_deg.clamp(min=STD_EPS), 0.0)}
    for l in range(shape.depth):
        base = f"node_gnn.mp_layers.{l}"
        msg = L.mlp(f"{base}.pretrans", shape.pretrans,
                    torch.cat([h[src], h[dst], e], dim=-1))
        mean = scatter_mean(msg, dst, N, deg)
        sq = scatter_mean(msg * msg, dst, N, deg)
        aggs = {"mean": mean,
                "max": scatter_extreme(msg, dst, N, "amax"),
                "min": scatter_extreme(msg, dst, N, "amin"),
                "std": torch.sqrt(torch.relu(sq - mean * mean) + STD_EPS)}
        aggs = [torch.where(has, aggs[a], 0.0) for a in shape.aggregators]
        parts = []
        for s in shape.scalers:
            parts += aggs if scales[s] is None else [a * scales[s]
                                                     for a in aggs]
        h_new = L.mlp(f"{base}.posttrans", shape.posttrans,
                      torch.cat([h] + parts, dim=-1))
        h = h_new + h if shape.residual else h_new
    pooled = readout(h, g["node_graph"], g["n_graphs"],
                     shape.readout_aggregators)
    return L.mlp("output", shape.output, pooled)
