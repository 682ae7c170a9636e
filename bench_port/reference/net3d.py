"""Net3D, the 3D encoder, as published (the 3D Infomax repository's
`models/net3d.py`): on each conformer's complete graph, one learned node
embedding for every atom, each edge's distance through sin / cos Fourier
encodings at dyadic scales (plus the distance itself) and the edge MLP
(followed by one more SiLU); per layer the message MLP on ``[h[sender] ‖
h[receiver] ‖ e]``, the edge state plus the message, the message gated by
a sigmoid of one linear map, the gated messages' mean at each receiver,
the update MLP on ``aggregate + h`` and the residual; then the min / max /
mean readout per conformer and the output MLP."""
from __future__ import annotations

from typing import Dict, Mapping

import torch
import torch.nn.functional as F

from bench_port.reference.nn import (Layers, Spec, linear_spec, mlp_layout,
                                     mlp_spec, readout, scatter_mean)


class Net3DShape:
    """The widths and layer layouts of a config's `model3d_parameters`."""

    def __init__(self, mp: Mapping):
        if float(mp.get("dropout", 0.0)) != 0.0:
            raise NotImplementedError("the reference Net3D runs dropout 0")
        if int(mp.get("node_wise_output_layers", 2)) != 0 or mp.get(
                "use_node_features"):
            raise NotImplementedError("the reference Net3D has no node-wise "
                                      "output network and no atom codes")
        self.D = D = int(mp["hidden_dim"])
        self.depth = int(mp.get("propagation_depth", 4))
        self.fourier = int(mp.get("fourier_encodings", 0))
        self.reduce = mp.get("reduce_func", "sum")
        self.readout_aggregators = tuple(mp["readout_aggregators"])
        act = str(mp.get("activation", "SiLU")).lower()
        bn = bool(mp.get("batch_norm", False))
        edge_in = 2 * self.fourier + 1 if self.fourier > 0 else 1
        self.edge_input = mlp_layout(edge_in, D, 1, D, act, act, bn, bn)
        self.message = mlp_layout(3 * D, D, int(mp.get("message_net_layers",
                                                       2)), D, act, act, bn,
                                  bn)
        self.update = mlp_layout(D, D, int(mp.get("update_net_layers", 2)), D,
                                 act, "none", bn, bn)
        self.output = mlp_layout(
            D * len(self.readout_aggregators), int(mp["target_dim"]),
            int(mp.get("readout_layers", 2)),
            int(mp.get("readout_hidden_dim") or D), "relu", "none",
            bool(mp.get("readout_batchnorm", True)), False)

    def spec(self) -> Spec:
        spec: Spec = [("node_embedding", (self.D,), "normal", 1.0)]
        spec += mlp_spec("edge_input", self.edge_input)
        for l in range(self.depth):
            spec += mlp_spec(f"mp_layers.{l}.message_network", self.message)
            spec += linear_spec(f"mp_layers.{l}.soft_edge_network", self.D, 1)
            spec += mlp_spec(f"mp_layers.{l}.update_network", self.update)
        return spec + mlp_spec("output", self.output)


def fourier(d: torch.Tensor, k: int) -> torch.Tensor:
    """[E] -> [E, 2k + 1]: sin(d / 2^i), cos(d / 2^i) for i < k, then d."""
    scaled = d[:, None] / (2.0 ** torch.arange(k, device=d.device))
    return torch.cat([torch.sin(scaled), torch.cos(scaled), d[:, None]],
                     dim=-1)


def net3d_forward(shape: Net3DShape, L: Layers, g: Dict[str, torch.Tensor]
                  ) -> torch.Tensor:
    """[G, target_dim] from the 3D batch `g` (``dist`` [E], ``senders`` /
    ``receivers`` [E], ``node_graph`` [N], ``n_graphs``): one row per
    conformer, in the batch's order."""
    N = g["node_graph"].shape[0]
    src, dst = g["senders"], g["receivers"]
    h = L.P["node_embedding"][None, :].expand(N, -1)
    d = g["dist"]
    d = fourier(L.q(d), shape.fourier) if shape.fourier > 0 else d[:, None]
    e = F.silu(L.mlp("edge_input", shape.edge_input, d))
    deg = torch.bincount(dst, minlength=N)
    for l in range(shape.depth):
        base = f"mp_layers.{l}"
        message = L.mlp(f"{base}.message_network", shape.message,
                        torch.cat([h[src], h[dst], e], dim=-1))
        e = e + message
        gated = message * torch.sigmoid(
            L.linear(f"{base}.soft_edge_network", message))
        if shape.reduce == "mean":
            agg = scatter_mean(gated, dst, N, deg)
        else:
            agg = gated.new_zeros(N, shape.D).index_add(0, dst, gated)
        h = L.mlp(f"{base}.update_network", shape.update, agg + h) + h
    pooled = readout(h, g["node_graph"], g["n_graphs"],
                     shape.readout_aggregators)
    return L.mlp("output", shape.output, pooled)
