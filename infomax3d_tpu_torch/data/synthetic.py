"""Synthetic molecule-like graphs (port of `infomax3d_tpu/data/synthetic.py`).

Same generator, same draws: for one seed the molecules are identical, bit
for bit, to the JAX package's — OGB-coded atom features [n, 9], bond
features [e, 3], both edge directions, 3D coordinates (and conformers), and
the complete-graph 3D view (`graph3d`).  `write_synthetic_cache` packs
such a set into the flat .npz cache of `data/cached.py`, array for array
the JAX package's.  numpy only.
"""
from __future__ import annotations

import os
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


def write_synthetic_cache(path: str, num: int = 256, seed: int = 0,
                          num_targets: int = 1, num_conformers: int = 1,
                          n_min: int = 4, n_max: int = 24,
                          float_features: bool = False,
                          split: Optional[str] = None,
                          split_fracs=(0.8, 0.1, 0.1),
                          nan_targets: bool = False) -> str:
    """Pack a SyntheticMolecules set into the flat .npz cache layout served
    by `data/cached.py` (the reference's processed-tensor layout,
    `datasets/qm9_dataset.py:370-471`) — lets every `dataset:` name in the
    reference configs run end-to-end without chemistry data.

    split: None | 'random' | 'scaffold' -> stores split_train/valid/test.
    float_features: one-hot-expand the categorical codes (GeoMol-style
    chemprop featurization shape, reference bace_geomol_feat.py:107-186).
    """
    ds = SyntheticMolecules(num, seed=seed, num_targets=num_targets,
                            num_conformers=num_conformers,
                            n_min=n_min, n_max=n_max)
    atoms, edges, eidx, coords = [], [], [], []
    atom_slices, edge_slices = [0], [0]
    for m in ds.mols:
        nf = m["node_feat"]
        if float_features:
            onehots = [np.eye(d, dtype=np.float32)[nf[:, c] % d]
                       for c, d in enumerate(FULL_ATOM_FEATURE_DIMS[:4])]
            nf = np.concatenate(onehots, axis=1)
        atoms.append(nf)
        ef = m["edge_feat"]
        if float_features:
            ef = np.eye(FULL_BOND_FEATURE_DIMS[0],
                        dtype=np.float32)[ef[:, 0] % FULL_BOND_FEATURE_DIMS[0]]
        edges.append(ef)
        eidx.append(np.stack([m["senders"], m["receivers"]]))
        if num_conformers > 1:
            coords.append(np.swapaxes(m["conformers"], 0, 1))  # [n, C, 3]
        else:
            coords.append(m["coords"])
        atom_slices.append(atom_slices[-1] + m["node_feat"].shape[0])
        edge_slices.append(edge_slices[-1] + m["senders"].shape[0])
    arrays = dict(
        atom_features=np.concatenate(atoms),
        edge_features=np.concatenate(edges),
        edge_indices=np.concatenate(eidx, axis=1),
        atom_slices=np.asarray(atom_slices, np.int64),
        edge_slices=np.asarray(edge_slices, np.int64),
        coordinates=np.concatenate(coords),
        targets=ds.targets,
    )
    if nan_targets:
        # OGB multi-task label sparsity (e.g. ogbg-molpcba is ~94% NaN):
        # exercised by the NaN-masked losses and task-skipping metrics
        t = arrays["targets"].astype(np.float32).copy()
        mask_rng = np.random.default_rng(seed + 1)
        nan_mask = mask_rng.random(t.shape) < 0.5
        # keep at least one observed label per task and per molecule
        nan_mask[0, :] = False
        nan_mask[:, 0] = False
        t[nan_mask] = np.nan
        arrays["targets"] = t
    if split == "random":
        rng = np.random.default_rng(seed)
        perm = rng.permutation(num)
        n_tr = int(split_fracs[0] * num)
        n_va = int(split_fracs[1] * num)
        arrays["split_train"] = np.sort(perm[:n_tr])
        arrays["split_valid"] = np.sort(perm[n_tr:n_tr + n_va])
        arrays["split_test"] = np.sort(perm[n_tr + n_va:])
    elif split == "scaffold":
        from infomax3d_tpu_torch.data.splits import scaffold_split
        sp = scaffold_split(_CacheView(ds), *split_fracs)
        arrays["split_train"] = sp["train"]
        arrays["split_valid"] = sp["valid"]
        arrays["split_test"] = sp["test"]
    os.makedirs(os.path.dirname(path), exist_ok=True)
    np.savez(path, **arrays)
    return path


class _CacheView:
    """Adapter giving SyntheticMolecules the graph2d(i) protocol
    scaffold_split expects."""

    def __init__(self, ds: SyntheticMolecules):
        self.ds = ds

    def __len__(self):
        return len(self.ds)

    def graph2d(self, i):
        return self.ds.graph2d(i)
