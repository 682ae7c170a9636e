"""Synthetic molecule-like graphs (port of `infomax3d_tpu/data/synthetic.py`).

Same generator, same draws: for one seed the molecules are identical, bit
for bit, to the JAX package's — OGB-coded atom features [n, 9], bond
features [e, 3], both edge directions, 3D coordinates (and conformers), and
the complete-graph 3D view (`graph3d`).  numpy only.
"""
from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np

# OGB categorical vocabulary sizes (ogb.utils.features get_atom_feature_dims /
# get_bond_feature_dims), as the reference models hardcode them
FULL_ATOM_FEATURE_DIMS = (119, 5, 12, 12, 10, 6, 6, 2, 2)
FULL_BOND_FEATURE_DIMS = (5, 6, 2)

MAX_VALENCE = 4


def random_molecule(rng: np.random.Generator, n_min: int = 4, n_max: int = 28,
                    with_coords: bool = True) -> Dict[str, np.ndarray]:
    """One molecule: a valence-capped spanning tree plus ring closures."""
    n = int(rng.integers(n_min, n_max + 1))
    val = np.zeros(n, np.int64)
    src_l: List[int] = []
    dst_l: List[int] = []
    for child in range(1, n):
        cands = np.flatnonzero(val[:child] < MAX_VALENCE)
        p = int(cands[rng.integers(0, len(cands))])
        src_l.append(child)
        dst_l.append(p)
        val[child] += 1
        val[p] += 1
    n_rings = int(rng.integers(0, max(1, n // 6) + 1))
    bonded = set(zip(src_l, dst_l)) | set(zip(dst_l, src_l))
    for _ in range(n_rings):
        cands = np.flatnonzero(val < MAX_VALENCE)
        if len(cands) < 2:
            break
        a, b = (int(x) for x in rng.choice(cands, size=2, replace=False))
        if (a, b) in bonded:
            continue
        src_l.append(a)
        dst_l.append(b)
        bonded.add((a, b))
        bonded.add((b, a))
        val[a] += 1
        val[b] += 1
    src = np.asarray(src_l, np.int32)
    dst = np.asarray(dst_l, np.int32)
    senders = np.concatenate([src, dst]).astype(np.int32)
    receivers = np.concatenate([dst, src]).astype(np.int32)
    e = senders.shape[0]

    node_feat = np.stack(
        [rng.integers(0, d, size=n) for d in FULL_ATOM_FEATURE_DIMS], axis=1
    ).astype(np.int32)
    half = np.stack(
        [rng.integers(0, d, size=e // 2) for d in FULL_BOND_FEATURE_DIMS], axis=1
    ).astype(np.int32)
    edge_feat = np.concatenate([half, half], axis=0)

    out = dict(node_feat=node_feat, senders=senders, receivers=receivers,
               edge_feat=edge_feat)
    if with_coords:
        out["coords"] = rng.normal(scale=2.0, size=(n, 3)).astype(np.float32)
    return out


def complete_graph_from_coords(mol: Dict[str, np.ndarray]
                               ) -> Dict[str, np.ndarray]:
    """The 3D complete-graph view of a molecule: every ordered pair of
    distinct atoms, sender-major, with its distance (`edge_dist`)."""
    coords = mol["coords"]
    n = coords.shape[0]
    idx = np.arange(n)
    src = np.repeat(idx, n)
    dst = np.tile(idx, n)
    keep = src != dst
    src, dst = src[keep].astype(np.int32), dst[keep].astype(np.int32)
    d = np.linalg.norm(coords[src] - coords[dst], axis=-1).astype(np.float32)
    return dict(node_feat=mol["node_feat"], senders=src, receivers=dst,
                edge_dist=d, coords=coords)


class SyntheticMolecules:
    """In-memory dataset of random molecules with deterministic seeding."""

    def __init__(self, num: int, seed: int = 0, n_min: int = 4, n_max: int = 28,
                 num_targets: int = 1, num_conformers: int = 1):
        rng = np.random.default_rng(seed)
        self.mols: List[Dict[str, np.ndarray]] = [
            random_molecule(rng, n_min, n_max) for _ in range(num)]
        self.targets = rng.normal(size=(num, num_targets)).astype(np.float32)
        self.num_conformers = num_conformers
        if num_conformers > 1:
            for m in self.mols:
                n = m["node_feat"].shape[0]
                m["conformers"] = np.stack(
                    [m["coords"] +
                     rng.normal(scale=0.3, size=(n, 3)).astype(np.float32)
                     for _ in range(num_conformers)], axis=0)

    def __len__(self):
        return len(self.mols)

    def graph2d(self, i: int) -> Dict[str, np.ndarray]:
        return self.mols[i]

    def graph3d(self, i: int, conformer: Optional[int] = None
                ) -> Dict[str, np.ndarray]:
        mol = self.mols[i]
        if conformer is not None and "conformers" in mol:
            mol = dict(mol, coords=mol["conformers"][conformer])
        return complete_graph_from_coords(mol)
