"""GeoMol geometry (port of `infomax3d_tpu/ops/geomol_geometry.py`, itself
the reference's `commons/geomol_utils.py`): local-neighbourhood distance
and angle statistics, batched dihedrals, the von Mises similarity, the
frame of a bond axis, the signed tetrahedral volume and the rotation about
the x-axis.  Pure functions over padded tensors; the one that needs random
numbers (`rotation_matrix_v2`) takes them as an argument.
"""
from __future__ import annotations

import torch

# which angle combos are valid for a given neighbour count
# (geomol_utils.py:8-19)
ANGLE_MASK_REF = ((0, 0, 0, 0, 0, 0),
                  (0, 0, 0, 0, 0, 0),
                  (1, 0, 0, 0, 0, 0),
                  (1, 1, 1, 0, 0, 0),
                  (1, 1, 1, 1, 1, 1))
ANGLE_COMBOS = ((0, 1), (0, 2), (1, 2), (0, 3), (1, 3), (2, 3))


def safe_norm(x, dim=-1, keepdim=False, eps=1e-12):
    """The norm with a finite gradient at 0 (padded rows are exactly
    zero): ``sqrt(sum(x * x) + eps)``."""
    return torch.sqrt((x * x).sum(dim=dim, keepdim=keepdim) + eps)


def batch_distance_metrics_from_coords(coords, mask):
    """One-hop distances and the pairwise two-hop distance matrix within
    each local neighbourhood.  coords [Nh, 4, C, 3] or, with a hydrogen
    permutation axis, [Nh, 6, 4, C, 3]; mask [Nh, 4]."""
    d_mat_mask = mask[:, None, :] * mask[:, :, None]          # [Nh, 4, 4]
    if coords.ndim == 4:
        diff = coords[:, None] - coords[:, :, None] + 1e-10
        two_hop = safe_norm(diff) * d_mat_mask[..., None]
    else:
        diff = coords[:, :, None] - coords[:, :, :, None] + 1e-10
        two_hop = safe_norm(diff) * d_mat_mask[:, None, :, :, None]
    return safe_norm(coords), two_hop


def batch_angle_between_vectors(a, b):
    inner = (a * b).sum(dim=-1)
    return inner / (safe_norm(a) * safe_norm(b) + 1e-10)


def batch_angles_from_coords(coords, mask):
    """The cosines of all 6 pairwise neighbour angles of each
    neighbourhood, zero where the neighbour count has no such angle."""
    combos = torch.tensor(ANGLE_COMBOS, device=coords.device)
    amask = torch.tensor(ANGLE_MASK_REF, dtype=coords.dtype,
                         device=coords.device)[mask.sum(dim=1).long()]
    if coords.ndim == 4:                               # [Nh, 4, C, 3]
        c = coords[:, combos]                          # [Nh, 6, 2, C, 3]
        ang = batch_angle_between_vectors(c[:, :, 0], c[:, :, 1])
        return ang * amask[..., None]
    c = coords[:, :, combos]                           # [Nh, 6p, 6, 2, C, 3]
    ang = batch_angle_between_vectors(c[:, :, :, 0], c[:, :, :, 1])
    return ang * amask[:, None, :, None]


def batch_local_stats_from_coords(coords, mask):
    one_hop, two_hop = batch_distance_metrics_from_coords(coords, mask)
    return one_hop, two_hop, batch_angles_from_coords(coords, mask)


def batch_dihedrals(p0, p1, p2, p3):
    """(sin, cos) of the dihedral about the p1-p2 axis."""
    s1 = p1 - p0
    s2 = p2 - p1
    s3 = p3 - p2
    c12 = torch.linalg.cross(s1, s2, dim=-1)
    c23 = torch.linalg.cross(s2, s3, dim=-1)
    sin_d = safe_norm(s2) * (s1 * c23).sum(dim=-1)
    cos_d = (c12 * c23).sum(dim=-1)
    den = safe_norm(c12) * safe_norm(c23) + 1e-10
    return sin_d / den, cos_d / den


def von_mises_loss(a, b, a_sin=None, b_sin=None):
    """Cosine-difference similarity; higher is better (the molecule loss
    subtracts it)."""
    if a_sin is not None:
        return a * b + a_sin * b_sin
    return a * b + torch.sqrt(1 - a ** 2 + 1e-5) * torch.sqrt(1 - b ** 2
                                                              + 1e-5)


def rotation_matrix_v2(neighbor_coords, neighbor_map, eta_1):
    """The frame of each pair's bond axis, [P, C, 3, 3].  neighbor_coords
    [P, 4, C, 3]; neighbor_map [P, 4], one-hot of the neighbour that is the
    other dihedral atom; eta_1 [P, C, 3], uniform draws on [0, 1) (the JAX
    package draws them inside with `jax.random.uniform`)."""
    p_y = torch.einsum("pn,pncd->pcd", neighbor_map, neighbor_coords)
    eta_2 = eta_1 - (eta_1 * p_y).sum(dim=-1, keepdim=True) / (
        (p_y * p_y).sum(dim=-1, keepdim=True) + 1e-10) * p_y
    eta = eta_2 / safe_norm(eta_2, keepdim=True)
    h1 = p_y / (safe_norm(p_y, keepdim=True) + 1e-10)
    h3_1 = torch.linalg.cross(p_y, eta, dim=-1)
    h3 = h3_1 / (safe_norm(h3_1, keepdim=True) + 1e-10)
    h2 = -torch.linalg.cross(h1, h3, dim=-1)
    return torch.stack([h1, h2, h3], dim=-2)


def signed_volume(local_coords):
    """The sign of the tetrahedral volume: [K, 4, C, 3] -> [K, C]."""
    v1 = local_coords[:, 0] - local_coords[:, 3]
    v2 = local_coords[:, 1] - local_coords[:, 3]
    v3 = local_coords[:, 2] - local_coords[:, 3]
    return torch.sign((v1 * torch.linalg.cross(v2, v3, dim=-1)).sum(dim=-1))


def build_alpha_rotation(sin_a, cos_a):
    """[..., 3, 3] rotation about the x-axis from sin and cos."""
    zeros = torch.zeros_like(sin_a)
    ones = torch.ones_like(sin_a)
    return torch.stack([
        torch.stack([ones, zeros, zeros], -1),
        torch.stack([zeros, cos_a, -sin_a], -1),
        torch.stack([zeros, sin_a, cos_a], -1)], -2)
