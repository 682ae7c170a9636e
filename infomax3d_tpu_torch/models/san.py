"""SAN, the Spectral Attention Network graph transformer (port of
`infomax3d_tpu/models/san.py`: `SANAttention`, `GraphTransformerLayer`,
`SANNodeLPE`, `SAN`; reference models/san.py:78-334), on `san_collate`'s
dense batch.

Attention is dense and masked over the [G, n, n] pairs of each molecule,
in two channels: the real bonds' (keys ``K``, queries ``Q`` and the bond
codes' projection ``E``) and, with `full_graph`, the other pairs' (``K_2``,
``Q_2``, ``E_2`` of the "no bond" code), each score
``exp(clamp(Σ_d K_j Q_i E_ij / sqrt(d), -5, 5))``, the real channel
weighted ``1 / (γ + 1)`` and the fake one ``γ / (γ + 1)``; a node attends
to no self pair.  ``h_i = Σ_j s_ij V_j / (Σ_j s_ij + 1e-6)``.  Each layer
adds ``O_h``, the residual, masked BatchNorm (or LayerNorm) and the
feed-forward block.  The learned Laplacian PE runs ``linear_A`` and
`LPE_layers` encoder blocks over each atom's (eigenvalue, eigenvector
entry) pairs and sum-pools the valid ones beside the atom embedding.  The
graphs are read out by sum / mean / max / min over their real atoms (an
empty graph gives 0) into the readout MLP.  These are products and
reductions that JAX computes outside any Pallas kernel; the port runs them
in plain PyTorch.  Dropout draws its masks from the noise source the
forward is given, in the JAX forward's order.

Submodules carry the JAX module's names: the trunk ``gnn`` with
``embedding_h`` (an atom encoder whose tables the JAX converter names
``bond_embedding_list``, since no component of its path says "atom"),
``embedding_e_real`` / ``embedding_e_fake`` (bare tables ``emb_{i}``),
``linear_A``, ``PE_Transformer_{i}``, ``layer_{i}`` (``attention/{Q, K,
V, E, Q_2, K_2, E_2}``, ``O_h``, ``batch_norm1_h``, ``FFN_h_layer1``,
``FFN_h_layer2``, ``batch_norm2_h``), and the readout ``output``.
"""
from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from infomax3d_tpu_torch.data.synthetic import FULL_BOND_FEATURE_DIMS
from infomax3d_tpu_torch.models.attention import (LAYER_NORM_EPS,
                                                  TransformerEncoderBlock)
from infomax3d_tpu_torch.models.base import (MLP, AtomEncoder,
                                             MaskedBatchNorm, PromotingLinear)
from infomax3d_tpu_torch.models.noise import dropout as drop

# the bound of each attention score before its exponential
SCORE_CLAMP = 5.0


class TableEncoder(nn.Module):
    """The JAX `CategoricalFeatureEncoder` used on its own: one table per
    categorical column as the bare parameters ``emb_{i}``, their lookups
    summed in float32 and rounded once (as `base._embedding_sum`)."""

    def __init__(self, dims: Sequence[int], emb_dim: int):
        super().__init__()
        self.n = len(dims)
        for i, d in enumerate(dims):
            self.register_parameter(f"emb_{i}", nn.Parameter(
                torch.randn(d, emb_dim)))

    def forward(self, codes: torch.Tensor) -> torch.Tensor:
        out = None
        for i in range(self.n):
            w = getattr(self, f"emb_{i}")
            t = F.embedding(codes[:, i].long().clamp(0, w.shape[0] - 1),
                            w.float())
            out = t if out is None else out + t
        return out.to(getattr(self, "emb_0").dtype)


class SANAttention(nn.Module):
    def __init__(self, in_dim: int, gamma: float, out_dim: int,
                 num_heads: int, full_graph: bool, use_bias: bool = False):
        super().__init__()
        self.gamma, self.full_graph = gamma, full_graph
        self.num_heads, self.out_dim = num_heads, out_dim
        width = out_dim * num_heads
        names = ("Q", "K", "V", "E") + (("Q_2", "K_2", "E_2")
                                        if full_graph else ())
        for name in names:
            self.add_module(name, PromotingLinear(in_dim, width,
                                                  bias=use_bias))

    def _heads(self, x):
        return x.reshape(x.shape[:-1] + (self.num_heads, self.out_dim))

    def _scores(self, h, e, q: str, k: str, proj: str):
        """[G, N, N, H]: Σ_d K_j Q_i E_ij / sqrt(d) for the pair i <- j."""
        qh, kh = self._heads(getattr(self, q)(h)), self._heads(
            getattr(self, k)(h))
        eh = self._heads(getattr(self, proj)(e))
        s = torch.einsum("gjhd,gihd->gijhd", kh, qh) / math.sqrt(self.out_dim)
        return (s * eh).sum(dim=-1)

    def forward(self, g, h, e_real, e_fake):
        N = h.shape[1]
        v = self._heads(self.V(h))
        eye = torch.eye(N, dtype=torch.bool, device=h.device)[None]
        pair = g.node_mask[:, :, None] & g.node_mask[:, None, :]
        real = g.real_edge_mask & pair & ~eye
        c = SCORE_CLAMP
        s1 = torch.exp(self._scores(h, e_real, "Q", "K", "E").clamp(-c, c))
        zero = torch.zeros((), dtype=s1.dtype, device=s1.device)
        if self.full_graph:
            s2 = torch.exp(self._scores(h, e_fake, "Q_2", "K_2",
                                        "E_2").clamp(-c, c))
            fake = pair & ~eye & ~real
            L = self.gamma
            soft = torch.where(real[..., None], s1 / (L + 1),
                               torch.where(fake[..., None], L * s2 / (L + 1),
                                           zero))
        else:
            soft = torch.where(real[..., None], s1, zero)
        wv = torch.einsum("gijh,gjhd->gihd", soft, v)
        z = soft.sum(dim=2)
        return wv / (z[..., None] + 1e-6)


class GraphTransformerLayer(nn.Module):
    def __init__(self, in_dim: int, gamma: float, out_dim: int,
                 num_heads: int, full_graph: bool, dropout: float = 0.0,
                 layer_norm: bool = False, batch_norm: bool = True,
                 residual: bool = True, use_bias: bool = False,
                 batch_norm_momentum: float = 0.1):
        super().__init__()
        self.dropout, self.residual, self.out_dim = dropout, residual, out_dim
        self.in_dim = in_dim
        self.attention = SANAttention(in_dim, gamma, out_dim // num_heads,
                                      num_heads, full_graph, use_bias)
        self.O_h = PromotingLinear(out_dim, out_dim)
        self.layer_norm1_h = self.layer_norm2_h = None
        self.batch_norm1_h = self.batch_norm2_h = None
        if layer_norm:
            self.layer_norm1_h = nn.LayerNorm(out_dim, eps=LAYER_NORM_EPS)
            self.layer_norm2_h = nn.LayerNorm(out_dim, eps=LAYER_NORM_EPS)
        if batch_norm:
            self.batch_norm1_h = MaskedBatchNorm(out_dim, batch_norm_momentum)
            self.batch_norm2_h = MaskedBatchNorm(out_dim, batch_norm_momentum)
        self.FFN_h_layer1 = PromotingLinear(out_dim, 2 * out_dim)
        self.FFN_h_layer2 = PromotingLinear(2 * out_dim, out_dim)

    def _norms(self, h, ln, bn, mask):
        if ln is not None:
            h = ln(h)
        if bn is not None:
            h = bn(h, mask)
        return h

    def forward(self, g, h, e_real, e_fake, noise=None):
        G, N = h.shape[:2]
        attn = self.attention(g, h, e_real, e_fake).reshape(G, N,
                                                            self.out_dim)
        out = self.O_h(drop(attn, self.dropout, noise, self.training))
        if self.residual and self.in_dim == self.out_dim:
            out = h + out
        out = self._norms(out, self.layer_norm1_h, self.batch_norm1_h,
                          g.node_mask)
        z = drop(F.relu(self.FFN_h_layer1(out)), self.dropout, noise,
                 self.training)
        z = self.FFN_h_layer2(z)
        out = out + z if self.residual else z
        return self._norms(out, self.layer_norm2_h, self.batch_norm2_h,
                           g.node_mask)


class SANNodeLPE(nn.Module):
    """The SAN trunk with the learned Laplacian PE (reference
    san.py:278-334)."""

    def __init__(self, gamma: float, full_graph: bool, GT_hidden_dim: int,
                 GT_n_heads: int, GT_out_dim: int, GT_layers: int,
                 LPE_n_heads: int, LPE_layers: int, LPE_dim: int,
                 residual: bool = True, in_feat_dropout: float = 0.0,
                 dropout: float = 0.0, layer_norm: bool = False,
                 batch_norm: bool = True, batch_norm_momentum: float = 0.1):
        super().__init__()
        self.in_feat_dropout, self.LPE_dim = in_feat_dropout, LPE_dim
        self.GT_layers, self.LPE_layers = GT_layers, LPE_layers
        self.embedding_h = AtomEncoder(GT_hidden_dim - LPE_dim, kind="bond")
        self.embedding_e_real = TableEncoder(FULL_BOND_FEATURE_DIMS,
                                             GT_hidden_dim)
        self.embedding_e_fake = TableEncoder(FULL_BOND_FEATURE_DIMS,
                                             GT_hidden_dim)
        self.linear_A = PromotingLinear(2, LPE_dim)
        for i in range(LPE_layers):
            self.add_module(f"PE_Transformer_{i}", TransformerEncoderBlock(
                LPE_dim, LPE_n_heads, 2048))
        layer = dict(full_graph=full_graph, dropout=dropout,
                     layer_norm=layer_norm, batch_norm=batch_norm,
                     residual=residual,
                     batch_norm_momentum=batch_norm_momentum)
        for i in range(GT_layers):
            last = i == GT_layers - 1
            self.add_module(f"layer_{i}", GraphTransformerLayer(
                GT_hidden_dim, gamma, GT_out_dim if last else GT_hidden_dim,
                GT_n_heads, **layer))

    def forward(self, g, noise=None) -> torch.Tensor:
        G, N = g.node_feat.shape[:2]
        h = self.embedding_h(g.node_feat.reshape(G * N, -1)).reshape(G, N, -1)
        e_real = self.embedding_e_real(g.edge_codes.reshape(
            G * N * N, -1)).reshape(G, N, N, -1)
        # the "no bond" code: every pair's fake-channel embedding is one row
        e_fake = self.embedding_e_fake(torch.zeros(
            (1, len(FULL_BOND_FEATURE_DIMS)), dtype=torch.long,
            device=h.device)).reshape(1, 1, 1, -1)
        pe = self.linear_A(torch.nan_to_num(g.lap_pe))        # [G, N, k, L]
        k = pe.shape[2]
        pe = pe.reshape(G * N, k, self.LPE_dim)
        pe_mask = g.lap_pe_mask.reshape(G * N, k)
        for i in range(self.LPE_layers):
            pe = getattr(self, f"PE_Transformer_{i}")(pe, pe_mask, noise)
        pe = torch.where(pe_mask[..., None], pe, torch.zeros(
            (), dtype=pe.dtype, device=pe.device)).sum(dim=1)
        h = torch.cat([h, pe.reshape(G, N, self.LPE_dim)], dim=-1)
        h = drop(h, self.in_feat_dropout, noise, self.training)
        for i in range(self.GT_layers):
            h = getattr(self, f"layer_{i}")(g, h, e_real, e_fake, noise)
        return h


class SAN(nn.Module):
    """The JAX `SAN`; keyword arguments are its fields with its
    defaults."""

    FIELDS = ("GT_out_dim", "readout_hidden_dim", "readout_aggregators",
              "target_dim", "readout_layers", "readout_batchnorm",
              "batch_norm_momentum", "gamma", "full_graph", "GT_hidden_dim",
              "GT_n_heads", "GT_layers", "LPE_n_heads", "LPE_layers",
              "LPE_dim", "residual", "in_feat_dropout", "dropout",
              "layer_norm", "batch_norm")

    def __init__(self, GT_out_dim: int, readout_hidden_dim: int,
                 readout_aggregators: Sequence[str], target_dim: int,
                 readout_layers: int = 2, readout_batchnorm: bool = True,
                 batch_norm_momentum: float = 0.1, gamma: float = 1e-5,
                 full_graph: bool = True, GT_hidden_dim: int = 64,
                 GT_n_heads: int = 8, GT_layers: int = 4,
                 LPE_n_heads: int = 4, LPE_layers: int = 2, LPE_dim: int = 8,
                 residual: bool = True, in_feat_dropout: float = 0.0,
                 dropout: float = 0.0, layer_norm: bool = False,
                 batch_norm: bool = True):
        super().__init__()
        for a in readout_aggregators:
            if a not in ("sum", "mean", "max", "min"):
                raise ValueError(f"unknown readout {a}")
        self.readout_aggregators = tuple(readout_aggregators)
        self.gnn = SANNodeLPE(gamma, full_graph, GT_hidden_dim, GT_n_heads,
                              GT_out_dim, GT_layers, LPE_n_heads, LPE_layers,
                              LPE_dim, residual, in_feat_dropout, dropout,
                              layer_norm, batch_norm, batch_norm_momentum)
        self.output = MLP(GT_out_dim * len(self.readout_aggregators),
                          target_dim, readout_layers,
                          hidden_size=readout_hidden_dim,
                          mid_batch_norm=readout_batchnorm,
                          batch_norm_momentum=batch_norm_momentum)

    def forward(self, g, noise=None) -> torch.Tensor:
        h = self.gnn(g, noise)
        m = g.node_mask[..., None]
        has = m.any(dim=1)
        zero = torch.zeros((), dtype=h.dtype, device=h.device)
        hz = torch.where(m, h, zero)
        outs = []
        for a in self.readout_aggregators:
            if a == "sum":
                outs.append(hz.sum(dim=1))
            elif a == "mean":
                # the count is float32, as JAX's ``maximum(count, 1.0)``,
                # so a bf16 h reads out in float32 there too
                outs.append(hz.sum(dim=1) / m.sum(dim=1).clamp(min=1).float())
            elif a == "max":
                outs.append(torch.where(
                    has, h.masked_fill(~m, -math.inf).amax(dim=1), zero))
            else:
                outs.append(torch.where(
                    has, h.masked_fill(~m, math.inf).amin(dim=1), zero))
        return self.output(torch.cat(outs, dim=-1), g.graph_mask)
