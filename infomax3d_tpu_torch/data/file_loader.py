"""Streaming GEOM pickle loaders (port of `infomax3d_tpu/data/file_loader.py`;
reference `datasets/file_loader_qm9.py` /
`file_loader_drugs.py`): serve molecules directly from the GEOM dataset's
per-molecule pickles without a preprocessing pass.

Requires RDKit (the pickles contain RDKit mols) — data-prep dependency,
gated; the cached .npz path (`data/cached.py`) is the default, and the
training CLI falls back to it when RDKit is missing.
"""
from __future__ import annotations

import os
import pickle
from typing import Dict, Optional

import numpy as np

from infomax3d_tpu_torch.data.synthetic import complete_graph_from_coords


class GeomFileLoader:
    """Index a GEOM split (featurized lazily, LRU-cached)."""

    def __init__(self, root: str, split: str = "qm9",
                 num_conformers: int = 5, max_mols: Optional[int] = None,
                 cache_size: int = 2048):
        try:
            import rdkit  # noqa: F401
        except ImportError as e:
            raise ImportError(
                "GeomFileLoader streams RDKit pickles and needs rdkit; use "
                "the preprocessed .npz cache path instead.") from e
        summary = os.path.join(root, f"summary_{split}.json")
        import json
        with open(summary) as f:
            self.meta = json.load(f)
        self.smiles = sorted(self.meta.keys())
        if max_mols:
            self.smiles = self.smiles[:max_mols]
        self.root = root
        self.num_conformers = num_conformers
        self._cache: Dict[int, Dict] = {}
        self._cache_size = cache_size

    def __len__(self):
        return len(self.smiles)

    def _featurize(self, i: int) -> Dict:
        from infomax3d_tpu_torch.data.preprocess import mol_to_arrays
        smi = self.smiles[i]
        rel = self.meta[smi].get("pickle_path")
        with open(os.path.join(self.root, rel), "rb") as f:
            mol_dic = pickle.load(f)
        confs = sorted(mol_dic["conformers"],
                       key=lambda c: c.get("boltzmannweight", 0.0),
                       reverse=True)[: self.num_conformers]
        mol0 = confs[0]["rd_mol"]
        arr = mol_to_arrays(mol0)
        g2 = dict(node_feat=arr["atom_features"],
                  senders=arr["edge_index"][0].astype(np.int32),
                  receivers=arr["edge_index"][1].astype(np.int32),
                  edge_feat=arr["edge_features"],
                  coords=np.asarray(mol0.GetConformer().GetPositions(),
                                    np.float32))
        conf3d = []
        for c in confs:
            coords = np.asarray(c["rd_mol"].GetConformer().GetPositions(),
                                np.float32)
            conf3d.append(complete_graph_from_coords(
                dict(node_feat=g2["node_feat"], coords=coords)))
        while len(conf3d) < self.num_conformers:
            conf3d.append(conf3d[-1])
        return {"graph2d": g2, "graph3d": conf3d[0], "conformers3d": conf3d}

    def node_counts(self):
        return np.array([self[i]["graph2d"]["node_feat"].shape[0]
                         for i in range(len(self))])

    def edge_counts(self):
        return np.array([self[i]["graph2d"]["senders"].shape[0]
                         for i in range(len(self))])

    def __getitem__(self, i: int) -> Dict:
        if i not in self._cache:
            if len(self._cache) >= self._cache_size:
                self._cache.pop(next(iter(self._cache)))
            self._cache[i] = self._featurize(i)
        return self._cache[i]
