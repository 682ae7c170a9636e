"""The GeoMol conformer generator with optimal-transport matching (port of
`OptimalTransportModel`, infomax3d_tpu/models/optimal_transport.py, the
reference's `models/optimal_transport_model.py`), with the
`PNAGNNRandomEdgeUpdate` backbone.

The model embeds each molecule `n_model_confs` times through two noisy
backbones (``gnn``, ``gnn2``), predicts local neighbourhood coordinates
(a transformer over each neighbourhood, ``coord_pred``, ``d_mlp``) and the
torsions of each dihedral pair (``alpha_mlp``, ``c_mlp``), and compares
their statistics with those of the true conformers: one fused [T, C, G]
cost tensor over true conformers, model conformers and graphs.  The loss is
``sum(plan * cost)`` for the host's optimal-transport plans (`ot_plans`,
loss type ``ot_emd``), or the implicit-MLE bound without plans.

Randomness comes from a noise source (`models/random_variants.py`), drawn
in the JAX model's order: per model conformer the two backbones' node and
edge noise, then the two frames' auxiliary vectors.
"""
from __future__ import annotations

from typing import Any, Mapping, Optional

import torch
import torch.nn.functional as F
from torch import nn

from infomax3d_tpu_torch.models.attention import TransformerEncoderBlock
from infomax3d_tpu_torch.models.geomol import GeomolMLP
from infomax3d_tpu_torch.models.random_variants import PNAGNNRandomEdgeUpdate
from infomax3d_tpu_torch.ops.geomol_geometry import (
    batch_dihedrals, batch_local_stats_from_coords, build_alpha_rotation,
    rotation_matrix_v2, safe_norm, signed_volume, von_mises_loss)
from infomax3d_tpu_torch.ops.segment import segment_mean, segment_sum

BIG = 9e9
# the 9 (p, q) neighbour combinations of a dihedral pair
PT_IDX = (0, 0, 0, 1, 1, 1, 2, 2, 2)
QZ_IDX = (0, 1, 2, 0, 1, 2, 0, 1, 2)


def _rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``x[idx.clamp(0, len(x) - 1)]``: padding ids read the last row, as
    the JAX package's clipped `take` does (their rows are masked)."""
    return x[idx.clamp(0, x.shape[0] - 1).long()]


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


class OptimalTransportModel(nn.Module):
    """Keyword arguments are the config's `model_parameters`:
    `hyperparams`, `gnn_params` and `gnn_model`.  Backbones other than
    `PNAGNNRandomEdgeUpdate`, a backbone width other than the model's, and
    `random_alpha` are not ported yet and raise (ROADMAP queue 1)."""

    def __init__(self, hyperparams: Mapping[str, Any],
                 gnn_params: Mapping[str, Any],
                 gnn_model: str = "PNAGNNRandom"):
        super().__init__()
        hp = dict(hyperparams)
        if gnn_model != "PNAGNNRandomEdgeUpdate":
            raise NotImplementedError(
                f"OT gnn_model {gnn_model!r} not ported (ROADMAP queue 1)")
        if hp.get("random_alpha", False):
            raise NotImplementedError("random_alpha not ported "
                                      "(ROADMAP queue 1)")
        H = self.hidden_dim = hp["hidden_dim"]
        self.loss_type = hp["loss_type"]
        self.n_true_confs = hp["n_true_confs"]
        self.n_model_confs = hp["n_model_confs"]
        gp = dict(gnn_params)
        gp.setdefault("random_vec_dim", hp["random_vec_dim"])
        gp.setdefault("random_vec_std", hp["random_vec_std"])
        if gp["hidden_dim"] != H:
            raise NotImplementedError(
                "a backbone width other than the model's (gnn_output_mlp) "
                "is not ported (ROADMAP queue 1)")
        self.gnn = PNAGNNRandomEdgeUpdate.from_config(gp)
        self.gnn2 = PNAGNNRandomEdgeUpdate.from_config(gp)

        def layers(name, default):
            return hp.get(name, {}).get("n_layers", default)
        self.encoder = TransformerEncoderBlock(
            2 * H, hp.get("encoder", {}).get("n_head", 2), 3 * H)
        self.coord_pred = GeomolMLP(2 * H, 3, layers("coord_pred", 2))
        self.d_mlp = GeomolMLP(2 * H, 1, layers("d_mlp", 1))
        self.h_mol_mlp = GeomolMLP(H, H, layers("h_mol_mlp", 1))
        self.alpha_mlp = GeomolMLP(3 * H, 1, layers("alpha_mlp", 2))
        self.c_mlp = GeomolMLP(4 * H, 1, layers("c_mlp", 1))

    @classmethod
    def from_config(cls, model_parameters: Mapping[str, Any]
                    ) -> "OptimalTransportModel":
        mp = model_parameters
        return cls(mp["hyperparams"], mp["gnn_params"],
                   mp.get("gnn_model", "PNAGNNRandom"))

    # --- embeddings ---------------------------------------------------------
    def embed(self, g, noise):
        """Per-conformer node embeddings of both backbones [N, C, D] and the
        molecule representations [G, C, D]."""
        xs, xs2 = [], []
        for _ in range(self.n_model_confs):
            xs.append(self.gnn(g, noise))
            xs2.append(self.gnn2(g, noise))
        x1, x2 = torch.stack(xs, dim=1), torch.stack(xs2, dim=1)
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
        h_ = h.permute(0, 2, 1, 3).reshape(NH * C, 4, -1)
        key_mask = (mask[:, None, :] > 0).expand(NH, C, 4).reshape(NH * C, 4)
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
        alpha = self.alpha_mlp(torch.cat([x_rep, y_rep, h_mol_d], -1)) + \
            self.alpha_mlp(torch.cat([y_rep, x_rep, h_mol_d], -1))
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
    def molecule_loss_matrix(self, g, ex, true_stats, model_stats):
        """The [T, C, G] cost tensor (the reference's double loop over true
        and model conformers, fused).  The min / max over hydrogen
        permutations and combinations split their gradient evenly among
        ties (`amin` / `amax`), as JAX's reductions do."""
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
        loss = mean_by(one, nbh_mol) + mean_by(two, nbh_mol) - \
            mean_by(ang, nbh_mol) + mean_by(thr, dp_mol) - \
            mean_by(dih, dp_mol)                                 # [G, T, C]
        return loss.permute(1, 2, 0)                             # [T, C, G]

    def forward(self, batch, noise, return_cost_matrix: bool = False,
                ot_plans: Optional[torch.Tensor] = None) -> torch.Tensor:
        """`batch`: an `OTBatch`; `noise`: a noise source.  Returns the
        masked [T, C, G] cost (absent true conformers and padding graphs
        at `BIG`) with `return_cost_matrix`, else the loss: the
        plan-weighted cost per molecule averaged over the real graphs with
        `ot_plans` [G, T, C], the implicit-MLE bound without."""
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
                                         (m_local, m_pair))
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
