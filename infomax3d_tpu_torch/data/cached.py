"""Cached flat-array molecule datasets (port of
`infomax3d_tpu/data/cached.py`).

The reference's datasets all share one processed layout (SURVEY.md §2.5):
flat contiguous arrays ``atom_features [ΣN, 9]``, ``edge_features [ΣE, 3]``,
``edge_indices [2, ΣE]`` (COO both directions), ``coordinates [ΣN, 3]`` (or
``[ΣN, C, 3]`` for multi-conformer sets) plus ``atom_slices`` /
``edge_slices`` index arrays, saved as one .npz (`data/preprocess.py`
builds it from raw files, `data/synthetic.py::write_synthetic_cache` from
synthetic molecules).

`CachedMoleculeDataset` serves per-molecule item dicts for the collate
registry: ``graph2d`` (bond graph), ``graph3d`` (complete graph with
distances), ``conformers3d`` (C complete graphs), ``targets``.
`QM9Dataset` adds the QM9 target selection and units, and
`GeomolFineTuneDataset` the pre-split MoleculeNet sets.
`SyntheticDataset` serves the same items from `SyntheticMolecules`, so
every config runs without chemistry data.
"""
from __future__ import annotations

import os
from typing import Dict, Optional, Sequence

import numpy as np

from infomax3d_tpu_torch.data.synthetic import (SyntheticMolecules,
                                                complete_graph_from_coords)


class CachedMoleculeDataset:
    """Reads the flat .npz layout and serves item dicts."""

    REQUIRED = ("atom_features", "edge_features", "edge_indices",
                "atom_slices", "edge_slices")

    def __init__(self, path: str, num_conformers: int = 1,
                 normalize_targets: bool = False,
                 target_indices: Optional[Sequence[int]] = None,
                 target_scale: Optional[Sequence[float]] = None,
                 random_conformer: bool = False, seed: int = 0):
        if not os.path.exists(path):
            raise FileNotFoundError(
                f"dataset cache not found: {path}. Build it with the "
                f"preprocessing script (requires RDKit) or point "
                f"INFOMAX3D_DATA at a directory with prebuilt caches.")
        z = np.load(path, allow_pickle=False)
        for k in self.REQUIRED:
            if k not in z:
                raise KeyError(f"{path} missing array '{k}'")
        self.atom_features = z["atom_features"]
        self.edge_features = z["edge_features"]
        self.edge_indices = z["edge_indices"]
        self.atom_slices = z["atom_slices"]
        self.edge_slices = z["edge_slices"]
        self.coordinates = z["coordinates"] if "coordinates" in z else None
        self.targets = z["targets"].astype(np.float32) if "targets" in z else None
        # optional stored split (OGB scaffold splits, pre-split sets like
        # ZINC / the GeoMol fine-tune family): data/splits.py consumes this
        self.split_indices = None
        if "split_train" in z:
            self.split_indices = {
                "train": z["split_train"].astype(np.int64),
                "valid": z["split_valid"].astype(np.int64),
                "test": z["split_test"].astype(np.int64)}
        self.cache_dir = os.path.dirname(path)
        # clamp to the stored conformer count (reference qmugs_dataset.py
        # packs min(3, stored); asking for more than the cache holds serves
        # what exists rather than indexing past it)
        stored = (self.coordinates.shape[1]
                  if self.coordinates is not None and
                  self.coordinates.ndim == 3 else 1)
        self.num_conformers = min(num_conformers, stored) \
            if num_conformers > 1 else num_conformers
        # 'complete_graph_random_conformer' return type (reference
        # qmugs_dataset.py:187-193): each access serves the 3D complete
        # graph of one conformer sampled uniformly from the stored set
        self.random_conformer = random_conformer
        self._conf_rng = np.random.default_rng(seed)
        self.target_indices = list(target_indices) if target_indices else None
        if self.targets is not None and self.target_indices:
            self.targets = self.targets[:, self.target_indices]
        if self.targets is not None and target_scale is not None:
            # per-task unit conversion (QM9 csv stores Hartree; the served
            # targets are eV — reference qm9_dataset.py:112-130) applied
            # BEFORE normalization so mean/std are in converted units
            self.targets = self.targets * np.asarray(target_scale, np.float32)
        self.targets_mean = self.targets_std = None
        if normalize_targets and self.targets is not None:
            self.targets_mean = self.targets.mean(axis=0)
            self.targets_std = self.targets.std(axis=0)
            self.targets = ((self.targets - self.targets_mean) /
                            np.maximum(self.targets_std, 1e-12))

    def __len__(self):
        return len(self.atom_slices) - 1

    def node_counts(self) -> np.ndarray:
        return np.diff(self.atom_slices)

    def edge_counts(self) -> np.ndarray:
        return np.diff(self.edge_slices)

    def max_in_degree(self) -> int:
        """Exact max receiver degree over the 2D bond graphs — the Pallas
        CSR kernel's max_deg contract (ops/pallas/spmm.py)."""
        recv = self.edge_indices[1].astype(np.int64)
        offsets = np.repeat(self.atom_slices[:-1].astype(np.int64),
                            np.diff(self.edge_slices))
        glob = recv + offsets
        if len(glob) == 0:
            return 1
        return max(int(np.bincount(glob).max()), 1)

    def graph2d(self, i: int) -> Dict[str, np.ndarray]:
        a0, a1 = int(self.atom_slices[i]), int(self.atom_slices[i + 1])
        e0, e1 = int(self.edge_slices[i]), int(self.edge_slices[i + 1])
        out = dict(
            node_feat=self.atom_features[a0:a1],
            senders=self.edge_indices[0, e0:e1].astype(np.int32),
            receivers=self.edge_indices[1, e0:e1].astype(np.int32),
            edge_feat=self.edge_features[e0:e1],
        )
        if self.coordinates is not None:
            c = self.coordinates[a0:a1]
            out["coords"] = c[:, 0] if c.ndim == 3 else c
        return out

    def _coords(self, i: int, conformer: int = 0) -> np.ndarray:
        a0, a1 = int(self.atom_slices[i]), int(self.atom_slices[i + 1])
        c = self.coordinates[a0:a1]
        return c[:, conformer] if c.ndim == 3 else c

    def graph3d(self, i: int, conformer: int = 0) -> Dict[str, np.ndarray]:
        g = self.graph2d(i)
        return complete_graph_from_coords(
            dict(node_feat=g["node_feat"], coords=self._coords(i, conformer)))

    def _stored_conformers(self) -> int:
        if self.coordinates is None:
            return 0
        return self.coordinates.shape[1] if self.coordinates.ndim == 3 else 1

    def __getitem__(self, i: int) -> Dict:
        item: Dict = {"graph2d": self.graph2d(i)}
        if self.coordinates is not None:
            c0 = 0
            if self.random_conformer and self._stored_conformers() > 1:
                c0 = int(self._conf_rng.integers(self._stored_conformers()))
            item["graph3d"] = self.graph3d(i, c0)
            if self.num_conformers > 1:
                item["conformers3d"] = [self.graph3d(i, c)
                                        for c in range(self.num_conformers)]
        if self.targets is not None:
            item["targets"] = self.targets[i]
        return item


# QM9 Hartree->eV conversion and meV factors for denormalized metrics
# (reference datasets/qm9_dataset.py:112-130, trainer/metrics.py:82-86)
HAR2EV = 27.211386246
KCALMOL2EV = 0.04336414
QM9_TARGET_NAMES = ["mu", "alpha", "homo", "lumo", "gap", "r2", "zpve", "u0",
                    "u298", "h298", "g298", "cv", "u0_atom", "u298_atom",
                    "h298_atom", "g298_atom", "a", "b", "c"]
QM9_EV_TARGETS = {"homo", "lumo", "gap", "zpve", "u0", "u298", "h298", "g298",
                  "u0_atom", "u298_atom", "h298_atom", "g298_atom"}


class QM9Dataset(CachedMoleculeDataset):
    """QM9 from a prebuilt cache, with target selection, normalization and
    eV->meV factors for the denormalized metrics."""

    def __init__(self, path: str, target_tasks: Sequence[str] = ("homo",),
                 normalize: bool = True, num_conformers: int = 1):
        idx = [QM9_TARGET_NAMES.index(t) for t in target_tasks]
        scale = [HAR2EV if t in QM9_EV_TARGETS else 1.0 for t in target_tasks]
        super().__init__(path, num_conformers=num_conformers,
                         normalize_targets=normalize, target_indices=idx,
                         target_scale=scale)
        self.target_tasks = list(target_tasks)
        self.ev2mev = np.array(
            [1000.0 if t in QM9_EV_TARGETS else 1.0 for t in target_tasks],
            dtype=np.float32)


# GeoMol fine-tune family (reference datasets/{bace,bbbp,esol,lipo}_geomol*.py):
# MoleculeNet property-prediction sets with GeoMol chemprop-style one-hot
# featurization (float node/edge features, no AtomEncoder tables) or the
# QM9-style OGB featurization, each with a precomputed scaffold (or random)
# split.  The cache stores all three splits concatenated plus
# split_train/valid/test index arrays; data/preprocess.py builds it.
GEOMOL_SET_OGB_METRIC = {"bace": "ogbg-molbace", "bbbp": "ogbg-molbbbp",
                         "esol": "ogbg-molesol", "lipo": "ogbg-mollipo"}


class GeomolFineTuneDataset(CachedMoleculeDataset):
    """bace/bbbp/esol/lipo with GeoMol or QM9-style featurization
    (reference datasets/bace_geomol_feat.py:52-107 + 9 siblings).

    `dataset_name` examples: bace_geomol, bbbp_geomol_random,
    esol_geomol_qm9_featurization.  The reference evaluates these with the
    matching OGB metric (`train.py:340-344`): `ogb_metric_name` carries it.
    """

    def __init__(self, path: str, dataset_name: str):
        super().__init__(path)
        if self.split_indices is None:
            raise KeyError(f"{path} must store split_train/valid/test "
                           f"(scaffold or random split, built by preprocess)")
        self.dataset_name = dataset_name
        base = dataset_name.split("_")[0]
        self.ogb_metric_name = GEOMOL_SET_OGB_METRIC[base]
        self.float_features = "qm9_featurization" not in dataset_name


class SyntheticDataset:
    """`SyntheticMolecules` (bit-identical to the JAX package's) serving
    item dicts: ``graph2d``, ``graph3d``, ``targets`` and, with several
    conformers, ``conformers3d``."""

    def __init__(self, num: int = 2000, seed: int = 0, num_targets: int = 1,
                 num_conformers: int = 1, n_min: int = 4, n_max: int = 28,
                 random_conformer: bool = False):
        # random_conformer accepted for config-compat; the synthetic set
        # stores one conformer so sampling is a no-op
        del random_conformer
        self.ds = SyntheticMolecules(num, seed=seed, num_targets=num_targets,
                                     num_conformers=num_conformers,
                                     n_min=n_min, n_max=n_max)
        self.targets = self.ds.targets
        self.targets_mean = self.targets.mean(axis=0)
        self.targets_std = self.targets.std(axis=0)
        self.ev2mev = np.ones(num_targets, dtype=np.float32)
        self.target_tasks = [f"t{i}" for i in range(num_targets)]
        self.num_conformers = num_conformers

    def __len__(self):
        return len(self.ds)

    def node_counts(self):
        return np.array([m["node_feat"].shape[0] for m in self.ds.mols])

    def edge_counts(self):
        return np.array([m["senders"].shape[0] for m in self.ds.mols])

    def max_in_degree(self) -> int:
        degs = [int(np.bincount(m["receivers"]).max()) if len(m["receivers"])
                else 1 for m in self.ds.mols]
        return max(max(degs), 1)

    def __getitem__(self, i: int) -> Dict:
        item: Dict = {"graph2d": self.ds.graph2d(i),
                      "graph3d": self.ds.graph3d(i),
                      "targets": self.targets[i]}
        if self.num_conformers > 1:
            item["conformers3d"] = [self.ds.graph3d(i, conformer=c)
                                    for c in range(self.num_conformers)]
        return item
