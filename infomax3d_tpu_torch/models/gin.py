"""OGB GNN baseline: GIN or GCN convolutions, with or without a virtual node
(port of `infomax3d_tpu/models/gin.py`: `GINConv`, `GCNConv`, `GNNNode`,
`GNNNodeVirtual`, `Set2Set`, `OGBGNN`) on CSR batches, in training mode
(masked batch statistics, dropout) and in eval mode.

Per layer: messages ``relu(h[senders] + bond_emb)`` (GIN) or
``norm_s * norm_r * relu(x[senders] + bond_emb)`` with ``x = linear(h)``
and ``norm = (out-degree + 1) ** -0.5`` over the real edges (GCN), both
through the sender gather, whose backward is the sender-keyed segment-sum
kernel, and their float32 sum at each receiver (the CSR-sum kernel); GIN
then applies its MLP ``Linear -> BatchNorm -> relu -> Linear`` to ``(1 +
eps) * h + agg``, GCN adds ``relu(x + root_emb) / (out-degree + 1)``.
Then the layer's BatchNorm, a relu on all but the last layer, dropout, the
residual; with a virtual node, each graph's pooled nodes through
``mlp_virtualnode_list.{k}`` (Linear -> BatchNorm -> relu -> Linear ->
BatchNorm -> relu over the real graphs) between layers.  Jumping knowledge
"last" or "sum" (the JAX module's sum of the stack's inputs: the embedding
included, the last layer's output not).  The model pools each graph (sum,
mean, max, attention or Set2Set) and applies `graph_pred_linear`.

Names follow the reference's state_dict, as the JAX package's
`convert_state_dict` reads it: ``convs.{i}``, ``batch_norms.{i}``,
``mlp_virtualnode_list.{k}.{0,1,3,4}``, ``pool.gate_nn.{0,1,3}``, and
``root_emb`` / ``virtualnode_embedding`` as ``nn.Embedding(1, D)``.  The
reference has no Set2Set: ``set2set.lstm_{i}.{ii,if,ig,io,hi,hf,hg,ho}``
are the flax `LSTMCell`'s own names.

The dtype flow is the JAX package's: under the bf16 recipe the CSR sum
returns float32, so ``(1 + eps) * h + agg`` is float32 and every `Linear`
promotes its bf16 weights to float32 (`PromotingLinear`, as flax `Dense`
does); only the atom and bond encoders and layer 0's messages stay bf16.
"""
from __future__ import annotations

from typing import Any, Mapping

import torch
import torch.nn.functional as F
from torch import nn

from infomax3d_tpu_torch.models.base import (AtomEncoder, BondEncoder,
                                             MaskedBatchNorm,
                                             PromotingLinear)
from infomax3d_tpu_torch.models.noise import dropout
from infomax3d_tpu_torch.ops.aggregate import edge_aggregate, gather_src
from infomax3d_tpu_torch.ops.segment import (batch_readout, degree,
                                             segment_softmax, segment_sum,
                                             take_clipped)


class GINConv(nn.Module):
    """GIN convolution (reference `models/gin.py:85-110`): `mlp` is the
    reference's ``Sequential(Linear, BatchNorm1d, ReLU, Linear)``, called
    step by step so the BatchNorm gets the node mask."""

    def __init__(self, hidden_dim: int, batch_norm_momentum: float = 0.1):
        super().__init__()
        self.bond_encoder = BondEncoder(hidden_dim)
        self.eps = nn.Parameter(torch.zeros(1))
        self.mlp = nn.ModuleList([
            PromotingLinear(hidden_dim, hidden_dim),
            MaskedBatchNorm(hidden_dim, batch_norm_momentum), nn.ReLU(),
            PromotingLinear(hidden_dim, hidden_dim)])

    def forward(self, g, h: torch.Tensor) -> torch.Tensor:
        emb = self.bond_encoder(g.edge_feat)
        msg = F.relu(gather_src(g, h) + emb)
        z = (1.0 + self.eps) * h + edge_aggregate(g, msg, "sum")
        lin0, bn, relu, lin1 = self.mlp
        return lin1(relu(bn(lin0(z), g.node_mask)))


def out_degree(g, num_nodes: int) -> torch.Tensor:
    """[N] float32: each node's real out-edges (the senders' count)."""
    return degree(g.senders, num_nodes, mask=g.edge_mask)


class GCNConv(nn.Module):
    """GCN convolution (reference `models/gin.py:113-143`)."""

    def __init__(self, hidden_dim: int, batch_norm_momentum: float = 0.1):
        super().__init__()
        del batch_norm_momentum      # a field of the JAX module, unused
        self.linear = PromotingLinear(hidden_dim, hidden_dim)
        self.bond_encoder = BondEncoder(hidden_dim)
        self.root_emb = nn.Embedding(1, hidden_dim)

    def forward(self, g, h: torch.Tensor) -> torch.Tensor:
        N = h.shape[0]
        x = self.linear(h)
        emb = self.bond_encoder(g.edge_feat)
        degs = out_degree(g, N) + 1.0
        norm = degs[:, None] ** -0.5
        enorm = take_clipped(norm, g.senders) * take_clipped(norm,
                                                             g.receivers)
        msg = enorm * F.relu(gather_src(g, x) + emb)
        agg = edge_aggregate(g, msg, "sum")
        return agg + F.relu(x + self.root_emb.weight) / degs[:, None]


class GNNNode(nn.Module):
    """Atom embedding + stack of GIN / GCN convolutions, each followed by
    its BatchNorm, a relu (but the last), dropout and the residual;
    jumping knowledge "last" or "sum" (reference `models/gin.py:146-210`).
    With `virtual_node`, the virtual node of `GNNNodeVirtual`."""

    def __init__(self, num_layers: int, hidden_dim: int,
                 dropout: float = 0.5, jk: str = "last",
                 residual: bool = False, gnn_type: str = "gin",
                 batch_norm_momentum: float = 0.1,
                 virtual_node: bool = False):
        super().__init__()
        if jk not in ("last", "sum"):
            raise ValueError(f"unknown JK mode {jk}")
        H, m = hidden_dim, batch_norm_momentum
        self.num_layers, self.dropout, self.jk = num_layers, dropout, jk
        self.residual = residual
        conv = GINConv if gnn_type == "gin" else GCNConv
        self.atom_encoder = AtomEncoder(H)
        self.convs = nn.ModuleList(conv(H, m) for _ in range(num_layers))
        self.batch_norms = nn.ModuleList(MaskedBatchNorm(H, m)
                                         for _ in range(num_layers))
        self.virtual_node = virtual_node
        if virtual_node:
            self.virtualnode_embedding = nn.Embedding(1, H)
            nn.init.zeros_(self.virtualnode_embedding.weight)
            self.mlp_virtualnode_list = nn.ModuleList(
                nn.ModuleList([PromotingLinear(H, H), MaskedBatchNorm(H, m),
                               nn.ReLU(), PromotingLinear(H, H),
                               MaskedBatchNorm(H, m), nn.ReLU()])
                for _ in range(num_layers - 1))

    def _virtual_update(self, g, i: int, h: torch.Tensor,
                        virtual: torch.Tensor, noise) -> torch.Tensor:
        """The virtual node after layer i: the graph's pooled nodes `h`
        plus the virtual node, through the layer's MLP and dropout."""
        G = g.graph_mask.shape[0]
        lin0, bn0, _, lin1, bn1, _ = self.mlp_virtualnode_list[i]
        z = segment_sum(h, g.node_graph, G) + virtual
        z = F.relu(bn0(lin0(z), g.graph_mask))
        z = F.relu(bn1(lin1(z), g.graph_mask))
        z = dropout(z, self.dropout, noise, self.training)
        return virtual + z if self.residual else z

    def forward(self, g, noise=None) -> torch.Tensor:
        G = g.graph_mask.shape[0]
        h_list = [self.atom_encoder(g.node_feat)]
        if self.virtual_node:
            virtual = self.virtualnode_embedding.weight.expand(G, -1)
            graph_of = g.node_graph.long().clamp(0, G - 1)
        last = self.num_layers - 1
        for i, (conv, bn) in enumerate(zip(self.convs, self.batch_norms)):
            if self.virtual_node:
                # the JAX module replaces the stack's input in place: the
                # residual, the pooling and "sum" read it with the message
                h_list[i] = h_list[i] + torch.where(
                    g.node_mask[:, None], virtual[graph_of],
                    torch.zeros((), dtype=virtual.dtype,
                                device=virtual.device))
            h = bn(conv(g, h_list[i]), g.node_mask)
            if i != last:
                h = F.relu(h)
            h = dropout(h, self.dropout, noise, self.training)
            if self.residual:
                h = h + h_list[i]
            h_list.append(h)
            if self.virtual_node and i < last:
                virtual = self._virtual_update(g, i, h_list[i], virtual,
                                               noise)
        if self.jk == "last":
            return h_list[-1]
        return sum(h_list[:self.num_layers])


class AttentionPool(nn.Module):
    """Global attention pooling (reference `models/gin.py:57-61`): the gate
    ``Sequential(Linear(H, 2H), BatchNorm1d, ReLU, Linear(2H, 1))`` over
    the real nodes, its softmax within each graph, the weighted sum."""

    def __init__(self, hidden_dim: int, batch_norm_momentum: float = 0.1):
        super().__init__()
        H = hidden_dim
        self.gate_nn = nn.ModuleList([
            PromotingLinear(H, 2 * H),
            MaskedBatchNorm(2 * H, batch_norm_momentum), nn.ReLU(),
            PromotingLinear(2 * H, 1)])

    def forward(self, g, h: torch.Tensor) -> torch.Tensor:
        G = g.graph_mask.shape[0]
        lin0, bn, _, lin1 = self.gate_nn
        gate = lin1(F.relu(bn(lin0(h), g.node_mask)))
        a = segment_softmax(gate[:, 0], g.node_graph, G, mask=g.node_mask)
        return segment_sum(a[:, None] * h, g.node_graph, G)


# a flax LSTMCell's Denses: the input's without bias, the carry's with one
LSTM_GATES = ("i", "f", "g", "o")


class Set2Set(nn.Module):
    """Set2Set pooling (the JAX `Set2Set`, dgl's): `n_layers` stacked flax
    LSTM cells from a zero carry and a zero query, `n_iters` rounds of
    attention over each graph's real nodes; output [G, 2 * hidden]."""

    def __init__(self, hidden_dim: int, n_iters: int = 2, n_layers: int = 2):
        super().__init__()
        self.hidden_dim, self.n_iters, self.n_layers = (hidden_dim, n_iters,
                                                        n_layers)
        for layer in range(n_layers):
            in_dim = 2 * hidden_dim if layer == 0 else hidden_dim
            cell = nn.ModuleDict()
            for gate in LSTM_GATES:
                cell[f"i{gate}"] = PromotingLinear(in_dim, hidden_dim,
                                                   bias=False)
                cell[f"h{gate}"] = PromotingLinear(hidden_dim, hidden_dim)
            self.add_module(f"lstm_{layer}", cell)

    def _cell(self, layer: int, carry, x):
        """flax `LSTMCell.__call__`: (new carry, output)."""
        cell = getattr(self, f"lstm_{layer}")
        c, h = carry
        i, f, gg, o = (cell[f"i{k}"](x) + cell[f"h{k}"](h)
                       for k in LSTM_GATES)
        new_c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(gg)
        new_h = torch.sigmoid(o) * torch.tanh(new_c)
        return (new_c, new_h), new_h

    def forward(self, g, h: torch.Tensor) -> torch.Tensor:
        G, D = g.graph_mask.shape[0], self.hidden_dim
        zeros = torch.zeros(G, D, device=h.device)
        carries = [(zeros, zeros)] * self.n_layers
        q_star = torch.zeros(G, 2 * D, device=h.device)
        for _ in range(self.n_iters):
            x = q_star
            for layer in range(self.n_layers):
                carries[layer], x = self._cell(layer, carries[layer], x)
            q = x
            e = (h * take_clipped(q, g.node_graph)).sum(dim=-1)
            a = segment_softmax(e, g.node_graph, G, mask=g.node_mask)
            r = segment_sum(a[:, None] * h, g.node_graph, G)
            q_star = torch.cat([q, r], dim=-1)
        return q_star


class OGBGNN(nn.Module):
    """Reference OGBGNN (`models/gin.py:17-81`): the node stack
    (``node_gnn``), graph pooling, `graph_pred_linear`.  Keyword arguments
    are the JAX module's fields with its defaults; the dropout masks come
    from the noise source the forward is given (required in training with
    `dropout` > 0)."""

    def __init__(self, target_dim: int = 1, num_layers: int = 5,
                 hidden_dim: int = 300, gnn_type: str = "gin",
                 virtual_node: bool = True, residual: bool = False,
                 dropout: float = 0.0, JK: str = "last",
                 graph_pooling: str = "sum",
                 batch_norm_momentum: float = 0.1):
        super().__init__()
        self.graph_pooling = graph_pooling
        self.node_gnn = GNNNode(num_layers, hidden_dim, dropout, JK,
                                residual, gnn_type, batch_norm_momentum,
                                virtual_node)
        out_dim = hidden_dim
        if graph_pooling == "attention":
            self.pool = AttentionPool(hidden_dim, batch_norm_momentum)
        elif graph_pooling == "set2set":
            self.set2set = Set2Set(hidden_dim)
            out_dim = 2 * hidden_dim
        elif graph_pooling not in ("sum", "mean", "max"):
            raise ValueError(f"Invalid graph pooling type {graph_pooling}")
        self.graph_pred_linear = PromotingLinear(out_dim, target_dim)

    # the JAX module's fields: other keys of a config are dropped, as the
    # JAX package's `_adapt_model_params` drops them (e.g. `emb_dim`)
    FIELDS = ("target_dim", "num_layers", "hidden_dim", "gnn_type",
              "virtual_node", "residual", "dropout", "JK", "graph_pooling",
              "batch_norm_momentum")

    @classmethod
    def from_config(cls, model_parameters: Mapping[str, Any]) -> "OGBGNN":
        return cls(**{k: v for k, v in model_parameters.items()
                      if k in cls.FIELDS})

    def pool_graphs(self, g, h: torch.Tensor) -> torch.Tensor:
        if self.graph_pooling == "attention":
            return self.pool(g, h)
        if self.graph_pooling == "set2set":
            return self.set2set(g, h)
        return batch_readout(g, h, [self.graph_pooling])

    def forward(self, g, noise=None) -> torch.Tensor:
        h = self.node_gnn(g, noise)
        return self.graph_pred_linear(self.pool_graphs(g, h))
