"""Host-side geometry featurization for spherical message passing (the
port's own copy of `infomax3d_tpu/data/smp_featurize.py`).

The reference builds the radius graph and enumerates the triplets on the
device (PyG `radius_graph` + torch_sparse, `commons/spherical_encoding.py:
276-330`); here numpy does it per molecule on the host, and
`data/loader.py::smp_collate` packs the arrays into one batch.

Per molecule: radius graph edges (j->i), distances, triplets (k->j->i) with
edge-id pairs (idx_kj, idx_ji), interior angles, and the per-triplet MINIMUM
dihedral torsion over the remaining neighbors — exactly the reference
`xyztodat` semantics including the 0..2pi wrap and scatter-min.  The JAX
package enumerates triplets and torsions in Python loops; here they are
numpy array operations in the same order and the same float64 arithmetic
(each 3-vector dot product summed left to right), so the arrays are the
same.
"""
from __future__ import annotations

from typing import Dict

import numpy as np


def radius_graph(coords: np.ndarray, cutoff: float):
    """All directed pairs within cutoff (no self loops); returns (j, i) with
    the reference's edge orientation j->i."""
    n = coords.shape[0]
    d = np.linalg.norm(coords[:, None, :] - coords[None, :, :], axis=-1)
    mask = (d <= cutoff) & ~np.eye(n, dtype=bool)
    i_idx, j_idx = np.nonzero(mask)          # edge from j -> i
    return j_idx.astype(np.int32), i_idx.astype(np.int32)


def _dot(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Row-wise dot product of [..., 3] arrays, summed left to right."""
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]


def _expand(counts: np.ndarray):
    """(owner, position) of every slot when item r owns counts[r] slots."""
    owner = np.repeat(np.arange(len(counts)), counts)
    start = np.concatenate([[0], np.cumsum(counts)[:-1]]).astype(np.int64)
    return owner, np.arange(int(counts.sum())) - start[owner]


def smp_featurize(coords: np.ndarray, cutoff: float = 5.0) -> Dict[str, np.ndarray]:
    coords = np.asarray(coords, dtype=np.float64)
    j, i = radius_graph(coords, cutoff)
    e = len(j)
    dist = np.linalg.norm(coords[i] - coords[j], axis=-1)

    # the edges are sorted by receiver, senders ascending: node v's
    # in-neighbours are the senders of its edge range, and edge k -> v is
    # ptr[v] + k's place in that range
    n = coords.shape[0]
    ptr = np.zeros(n + 1, np.int64)
    np.cumsum(np.bincount(i, minlength=n), out=ptr[1:])
    deg = ptr[1:] - ptr[:-1]

    # triplets k->j->i: for each edge (j->i), all k with edge (k->j), k != i,
    # edge by edge, k ascending
    ji, pos = _expand(deg[j])
    kj = ptr[j[ji]] + pos
    keep = j[kj] != i[ji]
    idx_ji, idx_kj = ji[keep], kj[keep]
    tri_i, tri_j, tri_k = i[idx_ji], j[idx_ji], j[idx_kj]
    t = len(idx_ji)

    if t:
        pos_ji = coords[tri_i] - coords[tri_j]
        pos_jk = coords[tri_k] - coords[tri_j]
        a = np.sum(pos_ji * pos_jk, axis=-1)
        b = np.linalg.norm(np.cross(pos_ji, pos_jk), axis=-1)
        angle = np.arctan2(b, a)
    else:
        angle = np.zeros(0)

    # torsion: per triplet, min dihedral over other neighbors k_n of j (k_n != i)
    torsion = np.zeros(t)
    if t:
        tt, pos = _expand(deg[tri_j])
        k_n = j[ptr[tri_j[tt]] + pos]
        pos_ji = coords[tri_i] - coords[tri_j]
        pos_j0 = coords[tri_k] - coords[tri_j]
        dist_ji = np.sqrt(_dot(pos_ji, pos_ji))
        pji = pos_ji[tt]
        pos_jkn = coords[k_n] - coords[tri_j[tt]]
        plane1 = np.cross(pji, pos_j0[tt])
        plane2 = np.cross(pji, pos_jkn)
        a = _dot(plane1, plane2)
        b = _dot(np.cross(plane1, plane2), pji) / np.maximum(dist_ji[tt],
                                                             1e-12)
        tor = np.arctan2(b, a)
        tor = np.where(tor <= 0, tor + 2 * np.pi, tor)
        tor = np.where(k_n != tri_i[tt], tor, np.inf)
        torsion = np.minimum.reduceat(tor, np.concatenate(
            [[0], np.cumsum(deg[tri_j])[:-1]]))
        torsion = np.where(np.isfinite(torsion), torsion, 0.0)

    return dict(senders=j, receivers=i, dist=dist.astype(np.float32),
                angle=angle.astype(np.float32),
                torsion=torsion.astype(np.float32),
                idx_kj=idx_kj.astype(np.int32),
                idx_ji=idx_ji.astype(np.int32),
                tri_count=np.int32(t))
