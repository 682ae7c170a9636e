"""Synthetic drug-size molecules, made from a seed: the benchmark's own
copy of the pattern of the port's `data/synthetic.py`, frozen here so that
the yardstick does not move when the port does.

A molecule is a valence-capped random spanning tree (at most 4 bonds per
atom) plus a few ring closures, with OGB-coded atom features [n, 9], bond
features [e, 3] (both directions of a bond share them), coordinates, C
conformers (the coordinates plus Gaussian noise) and, where the traffic's
``targets`` asks for T > 0, T standard normal float32 targets.  Its 3D
view per conformer is the complete graph: every ordered pair of distinct
atoms, sender-major, with its distance.

Every seed gives the same atoms and complete-graph edges: the atom counts
of each block of `block` molecules (one batch) are the same fixed list
(the traffic's `n_min` .. `n_max` in turn), in an order drawn from the
seed; the bonds (a few ring closures more or less), codes, coordinates
and then the targets are drawn from the seed and the molecule's index.
Molecule i is made on demand from ``(seed, i)`` alone.
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np

ATOM_VOCAB = (119, 5, 12, 12, 10, 6, 6, 2, 2)
BOND_VOCAB = (5, 6, 2)
MAX_VALENCE = 4


def block_sizes(block: int, n_min: int, n_max: int) -> np.ndarray:
    """The atom counts of every block of `block` molecules: n_min, n_min +
    1, ..., n_max, n_min, ... (`block` entries)."""
    return n_min + np.arange(block) % (n_max - n_min + 1)


def _tree_and_rings(rng: np.random.Generator, n: int):
    """(senders, receivers) of one bond direction: each atom after the
    first bonds to an earlier atom below the valence cap, then up to
    max(1, n // 6) ring closures between atoms below the cap."""
    val = [0] * n
    src: List[int] = []
    dst: List[int] = []
    open_atoms = [0]
    u = rng.random(n)
    for child in range(1, n):
        p = open_atoms[int(u[child] * len(open_atoms))]
        src.append(child)
        dst.append(p)
        val[child] += 1
        val[p] += 1
        if val[p] >= MAX_VALENCE:
            open_atoms.remove(p)
        open_atoms.append(child)
    bonded = set(zip(src, dst)) | set(zip(dst, src))
    for _ in range(int(rng.integers(0, max(1, n // 6) + 1))):
        cands = [a for a in range(n) if val[a] < MAX_VALENCE]
        if len(cands) < 2:
            break
        a, b = (int(x) for x in rng.choice(cands, size=2, replace=False))
        if (a, b) in bonded:
            continue
        src.append(a)
        dst.append(b)
        bonded.update(((a, b), (b, a)))
        val[a] += 1
        val[b] += 1
    return np.asarray(src, np.int32), np.asarray(dst, np.int32)


def complete_pairs(n: int):
    """(senders, receivers) int32 of the complete graph on n atoms, every
    ordered pair of distinct atoms, sender-major."""
    idx = np.arange(n, dtype=np.int32)
    src, dst = np.repeat(idx, n), np.tile(idx, n)
    keep = src != dst
    return src[keep], dst[keep]


class MoleculePool:
    """The molecules of one run, made on demand from `seed` (see the
    module docstring).  `traffic` gives ``n_min``, ``n_max``,
    ``coord_scale``, ``conformer_noise`` and optionally ``targets`` (T,
    default 0); `block` is one card's batch, the unit whose atom counts
    are fixed; `num_conformers` is C (default 1)."""

    def __init__(self, seed: int, traffic: Dict, block: int,
                 num_conformers: int = 1):
        self.seed = int(seed)
        self.n_min, self.n_max = int(traffic["n_min"]), int(traffic["n_max"])
        self.coord_scale = float(traffic["coord_scale"])
        self.noise = float(traffic["conformer_noise"])
        self.block = int(block)
        self.C = int(num_conformers)
        self.n_targets = int(traffic.get("targets", 0))
        self._sizes = block_sizes(self.block, self.n_min, self.n_max)
        self._orders: Dict[int, np.ndarray] = {}
        self._pairs: Dict[int, tuple] = {}
        self._mols: Dict[int, Dict[str, np.ndarray]] = {}

    def size(self, i: int) -> int:
        """Molecule i's atom count: its block's fixed list in the order
        drawn from (seed, block)."""
        b, k = divmod(int(i), self.block)
        if b not in self._orders:
            rng = np.random.default_rng((self.seed, 0, b))
            self._orders[b] = rng.permutation(self._sizes)
        return int(self._orders[b][k])

    def molecule(self, i: int) -> Dict[str, np.ndarray]:
        """The raw molecule i: ``node_feat`` [n, 9] int32 atom codes,
        ``senders`` / ``receivers`` [e] int32 (both bond directions),
        ``edge_feat`` [e, 3] int32 bond codes, ``conformers`` [C, n, 3]
        float32 and, with T targets, ``targets`` [T] float32.  Made once
        and kept."""
        i = int(i)
        if i not in self._mols:
            self._mols[i] = self._make(i)
        return self._mols[i]

    def _make(self, i: int) -> Dict[str, np.ndarray]:
        n = self.size(i)
        rng = np.random.default_rng((self.seed, 1, int(i)))
        src, dst = _tree_and_rings(rng, n)
        node_feat = rng.integers(0, ATOM_VOCAB, size=(n, len(ATOM_VOCAB))
                                 ).astype(np.int32)
        half = rng.integers(0, BOND_VOCAB, size=(src.shape[0],
                                                 len(BOND_VOCAB))
                            ).astype(np.int32)
        coords = rng.normal(scale=self.coord_scale, size=(n, 3))
        confs = coords[None] + rng.normal(scale=self.noise,
                                          size=(self.C, n, 3))
        mol = {"node_feat": node_feat,
               "senders": np.concatenate([src, dst]),
               "receivers": np.concatenate([dst, src]),
               "edge_feat": np.concatenate([half, half]),
               "conformers": confs.astype(np.float32)}
        if self.n_targets:
            mol["targets"] = rng.normal(size=self.n_targets).astype(
                np.float32)
        return mol

    def pairs(self, n: int):
        if n not in self._pairs:
            self._pairs[n] = complete_pairs(n)
        return self._pairs[n]

    def item(self, i: int) -> Dict:
        """Molecule i as the port's datasets serve it (`data/cached.py`):
        ``graph2d``, the bond graph; ``conformers3d``, one complete graph
        per conformer with its distances and coordinates (what
        `conformer_collate` reads); ``graph3d``, the first of them; and
        ``targets`` where the molecule has them."""
        mol = self.molecule(i)
        src, dst = self.pairs(mol["node_feat"].shape[0])
        views = []
        for coords in mol["conformers"]:
            dist = np.linalg.norm(coords[src] - coords[dst], axis=-1)
            views.append({"node_feat": mol["node_feat"], "senders": src,
                          "receivers": dst,
                          "edge_dist": dist.astype(np.float32),
                          "coords": coords})
        graph2d = {k: mol[k] for k in ("node_feat", "senders", "receivers",
                                       "edge_feat")}
        item = {"graph2d": graph2d, "graph3d": views[0],
                "conformers3d": views}
        if "targets" in mol:
            item["targets"] = mol["targets"]
        return item


class PoolDataset:
    """`len(...)` molecules of a pool as dataset items (``pool.item``), for
    the port's `GraphDataLoader`; an item is made when it is asked for.
    The counts that the port's CLI sizes its buckets from (`cli/train.py::
    make_loaders`) are the pool's own."""

    def __init__(self, pool: MoleculePool, length: int):
        self.pool, self.length = pool, int(length)
        self.num_conformers = pool.C

    def node_counts(self) -> np.ndarray:
        return np.array([self.pool.size(i) for i in range(self.length)])

    def edge_counts(self) -> np.ndarray:
        return np.array([self.pool.molecule(i)["senders"].shape[0]
                         for i in range(self.length)])

    def max_in_degree(self) -> int:
        return max(int(np.bincount(self.pool.molecule(i)["receivers"]).max())
                   for i in range(self.length))

    def __len__(self):
        return self.length

    def __getitem__(self, i):
        return self.pool.item(int(i))
