"""Datasets with the item-dict protocol (port of
`infomax3d_tpu/data/cached.py`): `SyntheticDataset`, which runs every config
without chemistry data.  The npz-cache datasets (QM9, GEOM, QMugs, OGB)
come with the data layer (ROADMAP queue 1, item 4) and raise until then."""
from __future__ import annotations

from typing import Dict

import numpy as np

from infomax3d_tpu_torch.data.synthetic import SyntheticMolecules


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


def _not_ported(name: str):
    def raiser(*_args, **_kwargs):
        raise NotImplementedError(
            f"{name} is not ported yet (ROADMAP queue 1, item 4)")
    return raiser


CachedMoleculeDataset = _not_ported("CachedMoleculeDataset")
QM9Dataset = _not_ported("QM9Dataset")
GeomolFineTuneDataset = _not_ported("GeomolFineTuneDataset")
