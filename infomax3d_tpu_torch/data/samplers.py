"""Batch samplers (port of `infomax3d_tpu/data/samplers.py`; reference
`datasets/samplers.py:12-139`).

Size-clustered batch construction: batches whose molecules share atom
counts waste fewer padded slots.  `GraphDataLoader(batch_sampler=...)`
takes their index lists in place of its own shuffle.
"""
from __future__ import annotations

from collections import defaultdict
from typing import Iterator, List, Optional, Sequence

import numpy as np


class ConstantNumberAtomsCategorical:
    """Half of each batch comes from one same-size cluster sampled by cluster
    frequency; the other half is uniform (reference samplers.py:12-65)."""

    def __init__(self, n_atoms: Sequence[int], batch_size: int,
                 indices: Optional[Sequence[int]] = None, seed: int = 0,
                 drop_last: bool = False):
        indices = np.asarray(indices if indices is not None
                             else np.arange(len(n_atoms)))
        n_atoms = np.asarray(n_atoms)[indices]
        self.indices = indices
        self.clusters = defaultdict(list)
        for local, n in enumerate(n_atoms):
            self.clusters[int(n)].append(local)
        self.cluster_keys = list(self.clusters.keys())
        self.probs = np.array([len(self.clusters[k]) for k in self.cluster_keys],
                              dtype=np.float64)
        self.probs /= self.probs.sum()
        self.batch_size = batch_size
        self.drop_last = drop_last
        self.rng = np.random.default_rng(seed)

    def _new_cluster(self):
        k = self.cluster_keys[self.rng.choice(len(self.cluster_keys),
                                              p=self.probs)]
        members = self.clusters[k]
        return list(self.rng.permutation(members))

    def __iter__(self) -> Iterator[List[int]]:
        batch: List[int] = []
        cluster = self._new_cluster()
        for idx in self.rng.permutation(len(self.indices)):
            if len(batch) < self.batch_size // 2 and cluster:
                batch.append(int(self.indices[cluster.pop(0)]))
            else:
                batch.append(int(self.indices[idx]))
            if len(batch) == self.batch_size:
                yield batch
                cluster = self._new_cluster()
                batch = []
        if batch and not self.drop_last:
            yield batch

    def __len__(self):
        return (len(self.indices) + self.batch_size - 1) // self.batch_size


class ConstantNumberAtomsChunks:
    """Batches drawn from contiguous chunks of the size-sorted index list
    (reference samplers.py:68-139): each batch's molecules have near-equal
    atom counts — minimal padding."""

    def __init__(self, n_atoms: Sequence[int], batch_size: int,
                 indices: Optional[Sequence[int]] = None, seed: int = 0,
                 drop_last: bool = False):
        indices = np.asarray(indices if indices is not None
                             else np.arange(len(n_atoms)))
        order = np.argsort(np.asarray(n_atoms)[indices], kind="stable")
        self.sorted_indices = indices[order]
        self.batch_size = batch_size
        self.drop_last = drop_last
        self.rng = np.random.default_rng(seed)

    def __iter__(self) -> Iterator[List[int]]:
        n = len(self.sorted_indices)
        starts = np.arange(0, n, self.batch_size)
        self.rng.shuffle(starts)
        for s in starts:
            chunk = self.sorted_indices[s:s + self.batch_size]
            if len(chunk) < self.batch_size and self.drop_last:
                continue
            chunk = chunk[self.rng.permutation(len(chunk))]
            yield [int(i) for i in chunk]

    def __len__(self):
        return (len(self.sorted_indices) + self.batch_size - 1) // self.batch_size
