"""Dense masked attention (port of `infomax3d_tpu/models/attention.py`):
`masked_softmax`, `MultiHeadSelfAttention` and `TransformerEncoderBlock`,
the post-norm, batch-first `nn.TransformerEncoderLayer` semantics of the
reference's hybrid models, in plain einsum and softmax.  Submodules carry
the JAX module's names (``self_attn.in_proj``, ``out_proj``, ``norm1``,
``linear1``, ``linear2``, ``norm2``); LayerNorm uses flax's eps of 1e-6.
Dropout, in training mode, falls where the JAX modules put it and draws
its masks in their order: on the attention weights, then on the
attention's output, after the feed-forward activation and after
``linear2`` (the masks from the noise source `forward` is given,
`models/noise.py`).  A width that is not a multiple of the head count is
refused, as the JAX module's reshape refuses it.
"""
from __future__ import annotations

import math

import torch
from torch import nn

from infomax3d_tpu_torch.models.base import get_activation
from infomax3d_tpu_torch.models.noise import dropout as drop

LAYER_NORM_EPS = 1e-6   # flax LayerNorm's default


def masked_softmax(scores: torch.Tensor, mask: torch.Tensor,
                   dim: int = -1) -> torch.Tensor:
    """Softmax over the entries where `mask` is true; a row without any
    valid key gives zeros (not a uniform row)."""
    neg = torch.finfo(scores.dtype).min
    out = torch.softmax(scores.masked_fill(~mask, neg), dim=dim)
    return torch.where(mask.any(dim=dim, keepdim=True), out,
                       torch.zeros((), dtype=out.dtype, device=out.device))


def check_heads(dim: int, num_heads: int):
    """Refuse a width that the heads do not divide (the JAX module's
    reshape of [G, N, dim] into [G, N, num_heads, dim // num_heads]
    fails on it)."""
    if dim % num_heads:
        raise ValueError(f"hidden width {dim} is not a multiple of nhead "
                         f"{num_heads}")


class MultiHeadSelfAttention(nn.Module):
    def __init__(self, dim: int, num_heads: int, dropout: float = 0.0):
        super().__init__()
        check_heads(dim, num_heads)
        self.dim, self.num_heads, self.dropout = dim, num_heads, dropout
        self.in_proj = nn.Linear(dim, 3 * dim)
        self.out_proj = nn.Linear(dim, dim)

    def forward(self, x, key_mask, noise=None):
        """x [G, N, D]; key_mask [G, N], True where a key may be attended."""
        G, N, D = x.shape
        H = self.num_heads
        hd = self.dim // H
        q, k, v = (t.reshape(G, N, H, hd).transpose(1, 2)
                   for t in self.in_proj(x).split(self.dim, dim=-1))
        scores = torch.einsum("ghqd,ghkd->ghqk", q, k) / math.sqrt(hd)
        attn = masked_softmax(scores, key_mask[:, None, None, :])
        attn = drop(attn, self.dropout, noise, self.training)
        out = torch.einsum("ghqk,ghkd->ghqd", attn, v)
        return self.out_proj(out.transpose(1, 2).reshape(G, N, self.dim))


class TransformerEncoderBlock(nn.Module):
    """torch `TransformerEncoderLayer(batch_first=True, norm_first=False)`
    with its dropout (module docstring)."""

    def __init__(self, dim: int, num_heads: int, dim_feedforward: int,
                 activation: str = "relu", dropout: float = 0.0):
        super().__init__()
        self.dropout = dropout
        self.self_attn = MultiHeadSelfAttention(dim, num_heads, dropout)
        self.norm1 = nn.LayerNorm(dim, eps=LAYER_NORM_EPS)
        self.linear1 = nn.Linear(dim, dim_feedforward)
        self.linear2 = nn.Linear(dim_feedforward, dim)
        self.norm2 = nn.LayerNorm(dim, eps=LAYER_NORM_EPS)
        self.activation = get_activation(activation)

    def forward(self, x, key_mask, noise=None):
        a = drop(self.self_attn(x, key_mask, noise), self.dropout, noise,
                 self.training)
        x = self.norm1(x + a)
        h = drop(self.activation(self.linear1(x)), self.dropout, noise,
                 self.training)
        h = drop(self.linear2(h), self.dropout, noise, self.training)
        return self.norm2(x + h)
