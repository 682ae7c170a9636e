"""SMP, spherical message passing (a SphereNet / DimeNet++-style 3D
encoder; port of `infomax3d_tpu/models/smp.py`, the reference's
`models/spherical_message_passing.py:24-285`) on the radius-graph batch
of `data/loader.py::smp_collate`.

The geometry (radius graph, triplets k -> j -> i, angles, min-dihedral
torsions) comes from the host; the model evaluates the Bessel and
spherical-harmonic bases (`ops/spherical.py`) and passes messages over
edges and triplets.  The batch is receiver-sorted CSR and its triplets
are sorted by their edge j -> i, so the sums run on the port's kernels:

* ``segment_sum(e2, receivers, N)`` (`SMPUpdateV`) and the triplets'
  ``segment_sum(x_kj, idx_ji, E)`` (`SMPUpdateE`) are the CSR sum
  (`csr_sum`), over the batch's `csr_row_ptr` and over `tri_ji_ptr`; it
  returns float32, and the JAX segment sum keeps its input's dtype, so
  the result is cast back;
* the triplet gather ``x_kj[idx_kj]`` takes the triplets' CSC
  (`tri_kj_ptr`, `tri_kj_perm`): its backward is the sender-keyed
  segment sum;
* `SMPInit`'s Linear over ``[x[receivers] ‖ x[senders] ‖ rbf]`` projects
  x in node space and gathers: the backward of the receiver gather is the
  CSR segment sum, of the sender gather the sender-keyed one.

The spans ``smp.bases`` (the bases, once a forward) and ``smp.triplets``
(each block's triplet message, from the gather through the CSR sum)
mark the model's host work in a profiler's trace (`utils/spans.py`).

Padded edges take ``dist = cutoff``, where the envelope vanishes (the
Bessel bases are NaN at 0), and padded edges' and triplets' bases are
zeroed.  Linears are initialized as PyG's ``glorot_orthogonal`` (scale
2), the output Linear of each `SMPUpdateV` with zeros under
``output_init: zeros``; names are the flax ones (``init_e``, ``init_v``,
``update_e_{l}``, ``update_v_{l}``, ``dist_emb_freq`` and the Linears').
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from infomax3d_tpu_torch.models.base import AtomEncoder, PromotingLinear
from infomax3d_tpu_torch.ops.aggregate import gather_dst, gather_src
from infomax3d_tpu_torch.ops.kernels import csr_sum
from infomax3d_tpu_torch.ops.segment import segment_sum, take_rows
from infomax3d_tpu_torch.ops.spherical import (angle_emb, dist_emb,
                                               torsion_emb)
from infomax3d_tpu_torch.utils.spans import span


def glorot_orthogonal_(weight: torch.Tensor, scale: float = 2.0
                       ) -> torch.Tensor:
    """PyG's glorot_orthogonal in place: an orthogonal matrix rescaled so
    that its (population) variance is ``scale / (fan_in + fan_out)``."""
    with torch.no_grad():
        nn.init.orthogonal_(weight)
        fan_out, fan_in = weight.shape
        var = weight.var(unbiased=False).clamp(min=1e-12)
        weight.mul_(torch.sqrt(scale / (fan_in + fan_out) / var))
    return weight


def _dense(in_dim: int, out_dim: int, bias: bool = True,
           zeros: bool = False) -> PromotingLinear:
    lin = PromotingLinear(in_dim, out_dim, bias=bias)
    if zeros:
        nn.init.zeros_(lin.weight)
    else:
        glorot_orthogonal_(lin.weight)
    if bias:
        nn.init.zeros_(lin.bias)
    return lin


class ResidualLayer(nn.Module):
    def __init__(self, hidden: int):
        super().__init__()
        self.lin1 = _dense(hidden, hidden)
        self.lin2 = _dense(hidden, hidden)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x + F.silu(self.lin2(F.silu(self.lin1(x))))


class SMPInit(nn.Module):
    """The first edge embedding: atom codes (``emb``) or a learned vector
    (``node_embedding``), ``lin`` over ``[x[receivers] ‖ x[senders] ‖
    swish(lin_rbf_0(rbf))]`` and ``e2 = lin_rbf_1(rbf) * e1``."""

    def __init__(self, num_radial: int, hidden: int,
                 use_node_features: bool = True):
        super().__init__()
        self.hidden = hidden
        if use_node_features:
            # the JAX package's converter reads "bond" tables off a path
            # without "atom" (`models/base.py::_CategoricalEncoder`)
            self.emb = AtomEncoder(hidden, kind="bond")
        else:
            self.emb = None
            self.node_embedding = nn.Parameter(torch.randn(hidden))
        self.lin_rbf_0 = _dense(num_radial, hidden)
        self.lin = _dense(3 * hidden, hidden)
        self.lin_rbf_1 = _dense(num_radial, hidden, bias=False)

    def forward(self, g, rbf: torch.Tensor):
        N, H = g.num_nodes, self.hidden
        if self.emb is not None:
            x = self.emb(g.node_feat)
        else:
            x = self.node_embedding[None, :].expand(N, H)
        rbf0 = F.silu(self.lin_rbf_0(rbf))
        w = self.lin.weight

        def part(a, cols):
            """``a @ lin``'s column block, promoted as flax `Dense` does."""
            dt = torch.promote_types(a.dtype, w.dtype)
            return F.linear(a.to(dt), w[:, cols].to(dt))
        e1 = gather_dst(g, part(x, slice(0, H)))
        e1 = e1 + gather_src(g, part(x, slice(H, 2 * H)))
        e1 = F.silu(e1 + part(rbf0, slice(2 * H, 3 * H)) + self.lin.bias)
        return e1, self.lin_rbf_1(rbf) * e1


class SMPUpdateE(nn.Module):
    """One edge update: the triplet message ``x_kj[idx_kj] * sbf * t``
    summed onto each edge j -> i, the residual stack, ``e2 = lin_rbf(rbf)
    * e1``."""

    def __init__(self, hidden: int, int_emb_size: int, basis_emb_size: int,
                 num_spherical: int, num_radial: int,
                 num_before_skip: int = 1, num_after_skip: int = 2):
        super().__init__()
        self.num_before_skip, self.num_after_skip = num_before_skip, \
            num_after_skip
        self.lin_ji = _dense(hidden, hidden)
        self.lin_kj = _dense(hidden, hidden)
        self.lin_rbf1 = _dense(num_radial, basis_emb_size, bias=False)
        self.lin_rbf2 = _dense(basis_emb_size, hidden, bias=False)
        self.lin_down = _dense(hidden, int_emb_size, bias=False)
        self.lin_sbf1 = _dense(num_spherical * num_radial, basis_emb_size,
                               bias=False)
        self.lin_sbf2 = _dense(basis_emb_size, int_emb_size, bias=False)
        self.lin_t1 = _dense(num_spherical ** 2 * num_radial, basis_emb_size,
                             bias=False)
        self.lin_t2 = _dense(basis_emb_size, int_emb_size, bias=False)
        self.lin_up = _dense(int_emb_size, hidden, bias=False)
        for b in range(num_before_skip):
            self.add_module(f"res_before_{b}", ResidualLayer(hidden))
        self.lin = _dense(hidden, hidden)
        for a in range(num_after_skip):
            self.add_module(f"res_after_{a}", ResidualLayer(hidden))
        self.lin_rbf = _dense(num_radial, hidden, bias=False)

    def forward(self, g, x1, rbf0, sbf, t):
        x_ji = F.silu(self.lin_ji(x1))
        x_kj = F.silu(self.lin_kj(x1))
        x_kj = x_kj * self.lin_rbf2(self.lin_rbf1(rbf0))
        x_kj = F.silu(self.lin_down(x_kj))
        with span("smp.triplets"):
            x_kj = take_rows(x_kj, g.idx_kj, g.tri_kj_ptr,
                             g.tri_kj_perm) * \
                self.lin_sbf2(self.lin_sbf1(sbf))
            x_kj = x_kj * self.lin_t2(self.lin_t1(t))
            x_kj = csr_sum(x_kj, g.tri_ji_ptr, g.idx_ji).to(x_kj.dtype)
        x_kj = F.silu(self.lin_up(x_kj))
        e1 = x_ji + x_kj
        for b in range(self.num_before_skip):
            e1 = getattr(self, f"res_before_{b}")(e1)
        e1 = F.silu(self.lin(e1)) + x1
        for a in range(self.num_after_skip):
            e1 = getattr(self, f"res_after_{a}")(e1)
        return e1, self.lin_rbf(rbf0) * e1


class SMPUpdateV(nn.Module):
    """Node update: the edges' e2 summed at each receiver, ``lin_up``,
    `num_output_layers` swish Linears, the output ``lin`` (no bias)."""

    def __init__(self, hidden: int, out_emb_size: int, out_channels: int,
                 num_output_layers: int = 3,
                 output_init: str = "GlorotOrthogonal"):
        super().__init__()
        self.num_output_layers = num_output_layers
        self.lin_up = _dense(hidden, out_emb_size)
        for k in range(num_output_layers):
            self.add_module(f"lins_{k}", _dense(out_emb_size, out_emb_size))
        self.lin = _dense(out_emb_size, out_channels, bias=False,
                          zeros=output_init == "zeros")

    def forward(self, g, e2: torch.Tensor) -> torch.Tensor:
        v = csr_sum(e2, g.csr_row_ptr, g.receivers).to(e2.dtype)
        v = self.lin_up(v)
        for k in range(self.num_output_layers):
            v = F.silu(getattr(self, f"lins_{k}")(v))
        return self.lin(v)


class SMP(nn.Module):
    """The bases of the batch's geometry, ``init_e`` / ``init_v``, then
    `propagation_depth` edge and node updates; each node update's output
    summed per graph and over the updates.  Keyword arguments are the JAX
    module's fields (`energy_and_force` is accepted and unused, as
    there)."""

    FIELDS = ("cutoff", "propagation_depth", "hidden_channels", "target_dim",
              "int_emb_size", "basis_emb_size", "out_emb_size",
              "num_spherical", "num_radial", "envelope_exponent",
              "num_before_skip", "num_after_skip", "num_output_layers",
              "output_init", "use_node_features", "energy_and_force")

    def __init__(self, cutoff: float = 5.0, propagation_depth: int = 4,
                 hidden_channels: int = 128, target_dim: int = 1,
                 int_emb_size: int = 64, basis_emb_size: int = 8,
                 out_emb_size: int = 256, num_spherical: int = 3,
                 num_radial: int = 6, envelope_exponent: int = 5,
                 num_before_skip: int = 1, num_after_skip: int = 2,
                 num_output_layers: int = 3,
                 output_init: str = "GlorotOrthogonal",
                 use_node_features: bool = True,
                 energy_and_force: bool = False):
        super().__init__()
        self.cutoff, self.depth = cutoff, propagation_depth
        self.num_spherical, self.num_radial = num_spherical, num_radial
        self.envelope_exponent = envelope_exponent
        self.dist_emb_freq = nn.Parameter(
            torch.arange(1, num_radial + 1, dtype=torch.float32) * math.pi)
        self.init_e = SMPInit(num_radial, hidden_channels, use_node_features)
        v_args = (hidden_channels, out_emb_size, target_dim,
                  num_output_layers, output_init)
        self.init_v = SMPUpdateV(*v_args)
        for layer in range(propagation_depth):
            self.add_module(f"update_e_{layer}", SMPUpdateE(
                hidden_channels, int_emb_size, basis_emb_size, num_spherical,
                num_radial, num_before_skip, num_after_skip))
            self.add_module(f"update_v_{layer}", SMPUpdateV(*v_args))

    def bases(self, g):
        """(rbf0 [E, K], sbf [T, L K], t [T, L^2 K]): the radial, angular
        and torsion bases, zero on padding edges and triplets."""
        L, K, cut = self.num_spherical, self.num_radial, self.cutoff
        dist = torch.where(g.edge_mask, g.edge_dist, cut)
        rbf0 = dist_emb(dist, self.dist_emb_freq, cut, self.envelope_exponent)
        sbf = angle_emb(dist, g.angle, g.idx_kj, L, K, cut)
        t = torsion_emb(dist, g.angle, g.torsion, g.idx_kj, L, K, cut)
        tmask = g.tri_mask[:, None]
        return (torch.where(g.edge_mask[:, None], rbf0, 0.0),
                torch.where(tmask, sbf, 0.0), torch.where(tmask, t, 0.0))

    def forward(self, g, noise=None) -> torch.Tensor:
        G = g.graph_mask.shape[0]
        with span("smp.bases"):
            rbf0, sbf, t = self.bases(g)
        e1, e2 = self.init_e(g, rbf0)
        u = segment_sum(self.init_v(g, e2), g.node_graph, G)
        for layer in range(self.depth):
            e1, e2 = getattr(self, f"update_e_{layer}")(g, e1, rbf0, sbf, t)
            u = u + segment_sum(getattr(self, f"update_v_{layer}")(g, e2),
                                g.node_graph, G)
        return u
