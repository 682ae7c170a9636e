"""The GeoMol conformer generator with optimal-transport matching (port of
`OptimalTransportModel` and `GINVirtualRandomBackbone`, infomax3d_tpu/
models/optimal_transport.py, the reference's `models/
optimal_transport_model.py`).

The model embeds each molecule `n_model_confs` times through two noisy
backbones (``gnn``, ``gnn2``; with `use_two_gnns` off, ``gnn`` alone
serves both), maps a backbone wider or narrower than the model to its
width (``gnn_output_mlp``, ``gnn2_output_mlp``), predicts local
neighbourhood coordinates (a transformer over each neighbourhood unless
`use_transformer` is off, ``coord_pred``, ``d_mlp``) and the torsions of
each dihedral pair (``alpha_mlp``, ``c_mlp``; with `random_alpha`,
alpha's input carries noise columns too), and compares their statistics
with those of the true conformers: one fused [T, C, G] cost tensor over
true conformers, model conformers and graphs.  With `ignore_neighbors` the
cost holds the one-hop, two-hop and angle terms alone; the dihedral and
three-hop terms enter it otherwise.  The loss is ``sum(plan * cost)`` for
the host's optimal-transport plans (`ot_plans`, loss type ``ot_emd``), or
the implicit-MLE bound without plans.

The backbone is the config's `gnn_model` (`BACKBONES`): `PNAGNNRandom`
(the default), `PNAGNNRandomEdgeUpdate`, `GeomolGNNOGBFeat` (no noise; it
returns node and edge embeddings, of which the nodes are read),
`GeomolGNNOGBFeatRandom` and its `NonShared` sibling, and
`GNN_node_VirtualnodeRandom` (the virtual-node GIN with noise columns).

Randomness comes from a noise source (`models/noise.py`), drawn in the JAX
model's order: per model conformer the node and edge noise and the
dropout masks of ``gnn``, then of ``gnn2``; then the two frames'
auxiliary vectors and, with `random_alpha`, alpha's noise.  In training
mode each backbone call updates its BatchNorms' running statistics, in
the same order.
"""
from __future__ import annotations

from typing import Any, Mapping, Optional

import torch
import torch.nn.functional as F
from torch import nn

from infomax3d_tpu_torch.models.attention import TransformerEncoderBlock
from infomax3d_tpu_torch.models.base import MLP
from infomax3d_tpu_torch.models.geomol import GeomolMLP
from infomax3d_tpu_torch.models.geomol_mpnn import (GeomolGNNOGBFeat,
                                                    GeomolGNNOGBFeatRandom)
from infomax3d_tpu_torch.models.noise import noise_columns
from infomax3d_tpu_torch.models.pna_random import PNAGNNRandom
from infomax3d_tpu_torch.models.random_variants import (GNNNodeRandom,
                                                        PNAGNNRandomEdgeUpdate)
from infomax3d_tpu_torch.ops.geomol_geometry import (
    batch_dihedrals, batch_local_stats_from_coords, build_alpha_rotation,
    rotation_matrix_v2, safe_norm, signed_volume, von_mises_loss)
from infomax3d_tpu_torch.ops.segment import segment_mean, segment_sum
from infomax3d_tpu_torch.ops.segment import take_clipped as _rows

BIG = 9e9
# the 9 (p, q) neighbour combinations of a dihedral pair
PT_IDX = (0, 0, 0, 1, 1, 1, 2, 2, 2)
QZ_IDX = (0, 1, 2, 0, 1, 2, 0, 1, 2)


def _take_slots(arr: torch.Tensor, slots: torch.Tensor, dim: int
                ) -> torch.Tensor:
    """`arr` read at neighbour `slots` [P, k] along `dim` (1 or 2), the
    JAX package's `take_along_axis` with the slots clipped to 0..3."""
    idx = slots.clamp(0, 3).long()
    idx = idx.reshape(idx.shape[:1] + (1,) * (dim - 1) + idx.shape[1:]
                      + (1,) * (arr.ndim - dim - 1))
    shape = list(arr.shape)
    shape[dim] = slots.shape[1]
    return arr.gather(dim, idx.expand(shape))


class GINVirtualRandomBackbone(nn.Module):
    """`gnn_model: GNN_node_VirtualnodeRandom` (configs/ot_gin.yml): one
    draw of node then edge noise (``random_vec_std`` times a standard
    normal), then ``node_gnn``, a `GNNNodeRandom` with a virtual node.
    Keyword arguments are the JAX module's fields with its defaults."""

    FIELDS = ("hidden_dim", "num_layers", "dropout", "random_vec_dim",
              "random_vec_std")

    def __init__(self, hidden_dim: int = 300, num_layers: int = 5,
                 dropout: float = 0.5, random_vec_dim: int = 10,
                 random_vec_std: float = 1.0):
        super().__init__()
        self.random_vec_dim, self.random_vec_std = random_vec_dim, \
            random_vec_std
        self.node_gnn = GNNNodeRandom(num_layers, hidden_dim, random_vec_dim,
                                      dropout=dropout, virtual_node=True)

    @classmethod
    def from_config(cls, params: Mapping[str, Any]
                    ) -> "GINVirtualRandomBackbone":
        return cls(**{k: v for k, v in params.items() if k in cls.FIELDS})

    def forward(self, g, noise=None) -> torch.Tensor:
        like = self.node_gnn.virtualnode_embedding.weight
        rand_x = noise_columns(noise, g.node_feat.shape[0],
                               self.random_vec_dim, self.random_vec_std, like)
        rand_e = noise_columns(noise, g.senders.shape[0],
                               self.random_vec_dim, self.random_vec_std, like)
        return self.node_gnn(g, rand_x, rand_e, noise)


# the config's `gnn_model` -> the backbone class (the JAX model's dispatch);
# each class keeps the JAX module's fields as `FIELDS`
BACKBONES = {
    "PNAGNNRandom": PNAGNNRandom,
    "PNAGNNRandomEdgeUpdate": PNAGNNRandomEdgeUpdate,
    "GeomolGNNOGBFeat": GeomolGNNOGBFeat,
    "GeomolGNNOGBFeatRandom": GeomolGNNOGBFeatRandom,
    "GeomolGNNOGBFeatRandomNonShared": GeomolGNNOGBFeatRandom,
    "GNN_node_VirtualnodeRandom": GINVirtualRandomBackbone,
}


def _nodes(out):
    """The node half of the GeoMol backbones' (node, edge) output."""
    return out[0] if isinstance(out, tuple) else out


class OptimalTransportModel(nn.Module):
    """Keyword arguments are the config's `model_parameters`:
    `hyperparams`, `gnn_params`, `gnn_model`, `use_transformer` and
    `use_two_gnns` (module docstring)."""

    def __init__(self, hyperparams: Mapping[str, Any],
                 gnn_params: Mapping[str, Any],
                 gnn_model: str = "PNAGNNRandom",
                 use_transformer: bool = True, use_two_gnns: bool = True):
        super().__init__()
        hp = dict(hyperparams)
        if gnn_model not in BACKBONES:
            raise KeyError(f"unknown OT gnn_model '{gnn_model}'")
        H = self.hidden_dim = hp["hidden_dim"]
        self.loss_type = hp["loss_type"]
        self.n_true_confs = hp["n_true_confs"]
        self.n_model_confs = hp["n_model_confs"]
        self.random_vec_dim = hp["random_vec_dim"]
        self.random_vec_std = hp["random_vec_std"]
        self.random_alpha = hp.get("random_alpha", False)
        self.use_transformer, self.use_two_gnns = use_transformer, \
            use_two_gnns
        gp = dict(gnn_params)
        gp.setdefault("random_vec_dim", self.random_vec_dim)
        gp.setdefault("random_vec_std", self.random_vec_std)
        if gnn_model.startswith("GeomolGNNOGBFeatRandom"):
            gp.setdefault("non_shared", gnn_model.endswith("NonShared"))
        cls = BACKBONES[gnn_model]
        self.gnn = cls.from_config(gp)
        if use_two_gnns:
            self.gnn2 = cls.from_config(gp)
        self.use_gnn_output_mlp = gp["hidden_dim"] != H
        if self.use_gnn_output_mlp:
            self.gnn_output_mlp = MLP(gp["hidden_dim"], H, 1)
            self.gnn2_output_mlp = MLP(gp["hidden_dim"], H, 1)

        def layers(name, default):
            return hp.get(name, {}).get("n_layers", default)
        if use_transformer:
            self.encoder = TransformerEncoderBlock(
                2 * H, hp.get("encoder", {}).get("n_head", 2), 3 * H)
        self.coord_pred = GeomolMLP(2 * H, 3, layers("coord_pred", 2))
        self.d_mlp = GeomolMLP(2 * H, 1, layers("d_mlp", 1))
        self.h_mol_mlp = GeomolMLP(H, H, layers("h_mol_mlp", 1))
        alpha_in = 3 * H + (self.random_vec_dim if self.random_alpha else 0)
        self.alpha_mlp = GeomolMLP(alpha_in, 1, layers("alpha_mlp", 2))
        self.c_mlp = GeomolMLP(4 * H, 1, layers("c_mlp", 1))

    @classmethod
    def from_config(cls, model_parameters: Mapping[str, Any]
                    ) -> "OptimalTransportModel":
        mp = model_parameters
        return cls(mp["hyperparams"], mp["gnn_params"],
                   mp.get("gnn_model", "PNAGNNRandom"),
                   mp.get("use_transformer", True),
                   mp.get("use_two_gnns", True))

    # --- embeddings ---------------------------------------------------------
    def embed(self, g, noise):
        """Per-conformer node embeddings of both backbones [N, C, D] and the
        molecule representations [G, C, D]."""
        xs, xs2 = [], []
        for _ in range(self.n_model_confs):
            x1 = _nodes(self.gnn(g, noise))
            xs.append(x1)
            xs2.append(_nodes(self.gnn2(g, noise)) if self.use_two_gnns
                       else x1)
        x1, x2 = torch.stack(xs, dim=1), torch.stack(xs2, dim=1)
        if self.use_gnn_output_mlp:
            x1, x2 = self.gnn_output_mlp(x1), self.gnn2_output_mlp(x2)
        pooled = segment_sum(x2, g.node_graph, g.graph_mask.shape[0])
        return x1, x2, self.h_mol_mlp(pooled)

    # --- local statistics ---------------------------------------------------
    def model_local_stats(self, ex, x, chiral_tag):
        C = self.n_model_confs
        mask = ex["nbh_mask"]                                  # [NH, 4]
        m4 = mask[..., None, None]
        n_h = _rows(x, ex["nbh_nbrs"]) * m4                    # [NH, 4, C, D]
        x_h = _rows(x, ex["nbh_center"])                       # [NH, C, D]
        x_hb = x_h[:, None].expand_as(n_h)
        h = torch.cat([n_h, x_hb], dim=-1) * m4                # [NH, 4, C, 2D]
        NH = h.shape[0]
        h_new = h
        if self.use_transformer:
            h_ = h.permute(0, 2, 1, 3).reshape(NH * C, 4, -1)
            key_mask = (mask[:, None, :] > 0).expand(NH, C, 4).reshape(
                NH * C, 4)
            h_new = self.encoder(h_, key_mask).reshape(NH, C, 4, -1).permute(
                0, 2, 1, 3) * m4
        unit_normals = self.coord_pred(h_new) * m4
        # chiral flips of the third axis
        ctag = _rows(chiral_tag, ex["nbh_center"])[:, None]     # [NH, 1]
        sv = signed_volume(unit_normals)                        # [NH, C]
        z_flip = torch.where(ctag != 0, sv * ctag, torch.ones_like(sv))
        one = torch.ones_like(z_flip)
        unit_normals = unit_normals * torch.stack([one, one, z_flip],
                                                  dim=-1)[:, None]
        h_flipped = torch.cat([x_hb, n_h], dim=-1) * m4
        d_preds = F.softplus(self.d_mlp(h) + self.d_mlp(h_flipped)) * m4
        coords = unit_normals / (safe_norm(unit_normals, keepdim=True)
                                 + 1e-10) * d_preds
        return batch_local_stats_from_coords(coords, mask), coords

    def true_local_stats(self, ex, pos):
        """pos [N, T, 3] -> the statistics of the hydrogen-permuted local
        coordinates [NH, 6, 4, T, 3]."""
        mask = ex["nbh_mask"]
        coords = _rows(pos, ex["nbh_perms"])                  # [NH,6,4,T,3]
        centers = _rows(pos, ex["nbh_center"])                 # [NH, T, 3]
        coords = (coords - centers[:, None, None]) * \
            mask[:, None, :, None, None]
        return batch_local_stats_from_coords(coords, mask), coords

    # --- pair statistics ----------------------------------------------------
    def model_pair_stats(self, ex, x, h_mol, local_coords, noise):
        C, D = self.n_model_confs, self.hidden_dim
        P = ex["dp_x"].shape[0]
        xn = _rows(local_coords, ex["dp_x_h"])                  # [P, 4, C, 3]
        yn = _rows(local_coords, ex["dp_y_h"])
        x_rep = _rows(x, ex["dp_x"])                            # [P, C, D]
        y_rep = _rows(x, ex["dp_y"])
        xn_rep = _rows(x, ex["dp_x_nbrs"])                      # [P, 4, C, D]
        yn_rep = _rows(x, ex["dp_y_nbrs"])
        Hx = rotation_matrix_v2(xn, ex["x_map"], noise.uniform((P, C, 3)))
        Hy = rotation_matrix_v2(yn, ex["y_map"], noise.uniform((P, C, 3)))
        p_H = torch.einsum("pcij,pncj->pnci", Hx, xn)
        q_H = torch.einsum("pcij,pncj->pnci", Hy, yn)

        p_T_prime = _take_slots(p_H, ex["x_other"], 1)          # [P, 3, C, 3]
        q_Z_prime = _take_slots(q_H, ex["y_other"], 1)
        p_Y_prime = torch.einsum("pn,pnci->pci", ex["x_map"], p_H)
        flip = torch.tensor([-1.0, -1.0, 1.0], device=x.device)
        q_Z_translated = q_Z_prime * flip + p_Y_prime[:, None]

        h_mol_d = _rows(h_mol, ex["dp_mol"])                    # [P, C, D]
        tail = [h_mol_d]
        if self.random_alpha and noise is not None:
            tail.append(self.random_vec_std * noise.normal(
                (P, C, self.random_vec_dim)).to(h_mol_d.dtype))
        elif self.random_alpha:
            # the JAX model without its 'random' rng takes the branch
            # without noise, whose input is too narrow for alpha_mlp
            raise ValueError("random_alpha needs a noise source")
        alpha = self.alpha_mlp(torch.cat([x_rep, y_rep] + tail, -1)) + \
            self.alpha_mlp(torch.cat([y_rep, x_rep] + tail, -1))
        v_star = torch.cat([torch.cos(alpha), torch.sin(alpha)], -1)

        pT = p_T_prime[:, PT_IDX]                               # [P, 9, C, 3]
        qZ = q_Z_translated[:, QZ_IDX]
        pY9 = p_Y_prime[:, None].expand_as(pT)
        zero = torch.zeros_like(pY9)
        curr_sin, curr_cos = batch_dihedrals(pT, zero, pY9, qZ)

        p_reps = _take_slots(xn_rep, ex["x_other"], 1)          # [P, 3, C, D]
        q_reps = _take_slots(yn_rep, ex["y_other"], 1)
        cx = x_rep[:, None].expand(P, 9, C, D)
        cy = y_rep[:, None].expand(P, 9, C, D)
        pr, qr = p_reps[:, PT_IDX], q_reps[:, QZ_IDX]
        c_ij = self.c_mlp(torch.cat([pr, cx, qr, cy], -1)) + \
            self.c_mlp(torch.cat([qr, cy, pr, cx], -1))         # [P, 9, C, 1]
        # the 2x2 systems summed over the combinations with coefficients
        dmask = ex["dihedral_mask"][:, :, None]                 # [P, 9, 1]
        A = torch.stack([torch.stack([curr_cos, curr_sin], -1),
                         torch.stack([curr_sin, -curr_cos], -1)], -2)
        A = A * dmask[..., None, None]
        A_curr = (A * c_ij[..., None]).sum(dim=1)               # [P, C, 2, 2]
        a00, a01 = A_curr[..., 0, 0], A_curr[..., 0, 1]
        a10, a11 = A_curr[..., 1, 0], A_curr[..., 1, 1]
        det = a00 * a11 - a01 * a10 + 1e-10
        inv = torch.stack([torch.stack([a11, -a01], -1),
                           torch.stack([-a10, a00], -1)], -2) / \
            det[..., None, None]
        v_gamma = torch.einsum("pcij,pcj->pci", inv, v_star)
        v_gamma = v_gamma / (safe_norm(v_gamma, keepdim=True) + 1e-10)
        H_gamma = build_alpha_rotation(v_gamma[..., 1], v_gamma[..., 0])
        p_T_alpha = torch.einsum("pcij,pncj->pnci", H_gamma, p_T_prime)

        pTa = p_T_alpha[:, PT_IDX]
        md_sin, md_cos = batch_dihedrals(pTa, zero, pY9, qZ)
        model_dihedrals = torch.stack([md_sin * dmask, md_cos * dmask], 0)
        model_three_hop = safe_norm(pTa - qZ) * dmask
        return model_dihedrals, model_three_hop

    def true_pair_stats(self, ex, pos):
        """[2, P, 9, 6, T] dihedrals and [P, 9, 6, T] three-hop distances."""
        xn_pos = _rows(pos, ex["dp_xn_perms"])                  # [P,6,4,T,3]
        yn_pos = _rows(pos, ex["dp_yn_perms"])
        x_pos = _rows(pos, ex["dp_x"])                          # [P, T, 3]
        y_pos = _rows(pos, ex["dp_y"])
        xn3 = _take_slots(xn_pos, ex["x_other"], 2)             # [P,6,3,T,3]
        yn3 = _take_slots(yn_pos, ex["y_other"], 2)
        xn9 = xn3[:, :, PT_IDX].permute(0, 2, 1, 3, 4)          # [P,9,6,T,3]
        yn9 = yn3[:, :, QZ_IDX].permute(0, 2, 1, 3, 4)
        x9 = x_pos[:, None, None].expand_as(xn9)
        y9 = y_pos[:, None, None].expand_as(yn9)
        td_sin, td_cos = batch_dihedrals(xn9, x9, y9, yn9)      # [P, 9, 6, T]
        dmask = ex["dihedral_mask"][:, :, None, None]
        true_dihedrals = torch.stack([td_sin * dmask, td_cos * dmask], 0)
        return true_dihedrals, safe_norm(xn9 - yn9) * dmask

    # --- the cost -----------------------------------------------------------
    def molecule_loss_matrix(self, g, ex, true_stats, model_stats,
                             ignore_neighbors: bool = False):
        """The [T, C, G] cost tensor (the reference's double loop over true
        and model conformers, fused); with `ignore_neighbors` the local
        terms alone.  The min / max over hydrogen permutations and
        combinations split their gradient evenly among ties (`amin` /
        `amax`), as JAX's reductions do."""
        (t_one, t_two, t_ang), (t_dih, t_thr) = true_stats
        (m_one, m_two, m_ang), (m_dih, m_thr) = model_stats
        G = g.graph_mask.shape[0]

        def mean_by(v, ids):                           # [R, ...] -> [G, ...]
            return segment_mean(v.reshape(v.shape[0], -1), ids, G).reshape(
                (G,) + tuple(v.shape[1:]))

        nbh_mol, dp_mol = ex["nbh_mol"], ex["dp_mol"]
        # one-hop [NH, 6, 4, T] vs [NH, 4, C] -> [NH, T, C]
        se = (t_one[..., None] - m_one[:, None, :, None, :]) ** 2
        cnt = (t_one != 0).sum(dim=2)[..., None] + 1e-10
        one = (se.sum(dim=2) / cnt).amin(dim=1)
        # two-hop [NH, 6, 4, 4, T] vs [NH, 4, 4, C]
        se2 = (t_two[..., None] - m_two[:, None, :, :, None, :]) ** 2
        cnt2 = (t_two > 1e-8).sum(dim=(2, 3))[..., None] + 1e-10
        two = (se2.sum(dim=(2, 3)) / cnt2).amin(dim=1)
        # angles [NH, 6, 6, T] vs [NH, 6, C]
        vm = von_mises_loss(t_ang[..., None], m_ang[:, None, :, None, :])
        amask = t_ang != 0
        ang = ((vm * amask[..., None]).sum(dim=2)
               / (amask.sum(dim=2)[..., None] + 1e-10)).amax(dim=1)
        loss = mean_by(one, nbh_mol) + mean_by(two, nbh_mol) - \
            mean_by(ang, nbh_mol)                                # [G, T, C]
        if ignore_neighbors:
            return loss.permute(1, 2, 0)                         # [T, C, G]
        dmask = ex["dihedral_mask"]                              # [P, 9]
        dsum = dmask.sum(dim=-1)[:, None, None, None] + 1e-10
        # dihedrals: true [2, P, 9, 6, T], model [2, P, 9, C]
        vmd = von_mises_loss(t_dih[1][..., None],
                             m_dih[1][:, :, None, None, :],
                             t_dih[0][..., None],
                             m_dih[0][:, :, None, None, :])      # [P,9,6,T,C]
        dih = ((vmd * dmask[:, :, None, None, None]).sum(dim=1)
               / dsum).amax(dim=1)                               # [P, T, C]
        se3 = (t_thr[..., None] - m_thr[:, :, None, None, :]) ** 2
        thr = (se3.sum(dim=1) / dsum).amin(dim=1)
        loss = loss + mean_by(thr, dp_mol) - mean_by(dih, dp_mol)
        return loss.permute(1, 2, 0)                             # [T, C, G]

    def forward(self, batch, noise, ignore_neighbors: bool = False,
                return_cost_matrix: bool = False,
                ot_plans: Optional[torch.Tensor] = None) -> torch.Tensor:
        """`batch`: an `OTBatch`; `noise`: a noise source.  Returns the
        masked [T, C, G] cost (absent true conformers and padding graphs
        at `BIG`) with `return_cost_matrix`, else the loss: the
        plan-weighted cost per molecule averaged over the real graphs with
        `ot_plans` [G, T, C], the implicit-MLE bound without.  With
        `ignore_neighbors` the cost holds the local terms alone."""
        g, ex = batch.graph, batch.ex
        pos, pos_mask = ex["pos"], ex["pos_mask"]
        chiral = ex.get("chiral_tag")
        if chiral is None:
            chiral = torch.zeros(g.num_nodes, device=pos.device)
        x1, x2, h_mol = self.embed(g, noise)
        t_local, _ = self.true_local_stats(ex, pos)
        t_pair = self.true_pair_stats(ex, pos)
        m_local, model_coords = self.model_local_stats(ex, x1, chiral)
        m_pair = self.model_pair_stats(ex, x2, h_mol, model_coords, noise)
        cost = self.molecule_loss_matrix(g, ex, (t_local, t_pair),
                                         (m_local, m_pair), ignore_neighbors)
        valid = (pos_mask.T[:, None, :] * g.graph_mask[None, None, :]) > 0
        if return_cost_matrix:
            return torch.where(valid, cost, torch.full_like(cost, BIG))
        gm = g.graph_mask
        n_graphs = gm.sum().clamp(min=1)
        if ot_plans is not None:
            per_mol = (ot_plans.permute(1, 2, 0)
                       * torch.where(valid, cost, torch.zeros_like(cost))
                       ).sum(dim=(0, 1))
            return (per_mol * gm).sum() / n_graphs
        # implicit MLE (the reference's loss_type 'implicit_mle')
        cost_masked = torch.where(valid, cost, torch.full_like(cost, BIG))
        pm = pos_mask.T                                          # [T, G]
        L1 = cost_masked.amin(dim=0).sum(dim=0) / self.n_model_confs
        L2 = torch.where(pm > 0, cost_masked.amin(dim=1),
                         torch.zeros_like(pm)).sum(dim=0) / \
            pm.sum(dim=0).clamp(min=1)
        zero = torch.zeros_like(L1)
        L1m = torch.where(gm, L1, zero).sum() / n_graphs
        L2m = torch.where(gm, L2, zero).sum() / n_graphs
        return torch.maximum(L1m, L2m)
