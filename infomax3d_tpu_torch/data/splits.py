"""Dataset split protocols (port of `infomax3d_tpu/data/splits.py`).

Two families, mirroring the reference:

* **Scaffold splits for OGB fine-tune sets** — the reference calls
  ``dataset.get_idx_split()`` (reference `train.py:428-458`,
  `datasets/ogbg_dataset_extension.py:12-29`), which reads the split
  indices OGB ships on disk (``<root>/split/scaffold/{train,valid,test}.csv.gz``).
  `get_idx_split` takes (1) split arrays stored in the ``processed.npz``
  cache, (2) else OGB's on-disk csv.gz split dir, verbatim, (3) else a
  Bemis–Murcko scaffold split computed on the cached graph topology (the
  JAX package's deviation, kept: OGB precomputes its splits with RDKit
  SMILES scaffolds; this one derives the scaffold subgraph from the bond
  graph, which matches Murcko's ring systems + linkers but ignores the
  exocyclic double-bond atoms RDKit keeps).  The scaffold keys hash with
  Python's `hash()` of ints and int tuples, which no `PYTHONHASHSEED`
  changes, so the split is the JAX package's on every run.

* **Random split protocols per dataset family** — reference
  ``get_random_indices`` (`commons/utils.py:31-36`) with family-specific
  model-pool sizes and test fractions (`train.py:488-521,556-575`).
"""
from __future__ import annotations

import csv
import gzip
import hashlib
import os
from typing import Dict, Optional, Sequence, Tuple

import numpy as np


# ---------------------------------------------------------------------------
# Murcko scaffold from graph topology
# ---------------------------------------------------------------------------

def murcko_scaffold_mask(senders: np.ndarray, receivers: np.ndarray,
                         n_nodes: int) -> np.ndarray:
    """Boolean mask of atoms in the Bemis–Murcko scaffold: iteratively strip
    degree-<=1 atoms; what survives is the union of rings and the linkers
    between them.  Acyclic molecules yield an empty scaffold (all False),
    matching RDKit's MurckoScaffold giving the empty molecule."""
    alive = np.ones(n_nodes, dtype=bool)
    if n_nodes == 0 or len(senders) == 0:
        return np.zeros(n_nodes, dtype=bool)
    s = np.asarray(senders, np.int64)
    r = np.asarray(receivers, np.int64)
    while True:
        e_alive = alive[s] & alive[r]
        deg = np.bincount(r[e_alive], minlength=n_nodes)
        drop = alive & (deg <= 1)
        if not drop.any():
            break
        alive &= ~drop
    return alive


def _wl_hash(labels: np.ndarray, s: np.ndarray, r: np.ndarray,
             e_labels: np.ndarray, iters: int = 3) -> str:
    """Canonical-ish graph hash: Weisfeiler–Lehman label refinement followed
    by a sorted-multiset digest.  Deterministic across runs/platforms."""
    lab = [hash((int(x),)) & 0xFFFFFFFF for x in labels]
    n = len(lab)
    for _ in range(iters):
        nxt = []
        for v in range(n):
            inc = sorted((lab[int(s[k])], int(e_labels[k]))
                         for k in range(len(s)) if int(r[k]) == v)
            nxt.append(hash((lab[v], tuple(inc))) & 0xFFFFFFFF)
        lab = nxt
    digest = hashlib.sha1(
        (",".join(map(str, sorted(lab)))).encode()).hexdigest()
    return digest


def scaffold_key(graph: Dict[str, np.ndarray]) -> str:
    """Scaffold identity of one molecule dict (node_feat/senders/receivers/
    edge_feat).  Atom label = first feature column (atomic-number code);
    bond label = first edge-feature column (bond type)."""
    n = graph["node_feat"].shape[0]
    s, r = np.asarray(graph["senders"]), np.asarray(graph["receivers"])
    mask = murcko_scaffold_mask(s, r, n)
    if not mask.any():
        return ""                      # all acyclic molecules share a group
    keep = np.where(mask)[0]
    remap = -np.ones(n, np.int64)
    remap[keep] = np.arange(len(keep))
    e_sel = mask[s] & mask[r]
    ef = graph.get("edge_feat")
    e_labels = (np.asarray(ef)[e_sel, 0].astype(np.int64)
                if ef is not None and np.asarray(ef).ndim == 2
                else np.zeros(int(e_sel.sum()), np.int64))
    node_labels = np.asarray(graph["node_feat"])[keep, 0].astype(np.int64)
    return _wl_hash(node_labels, remap[s[e_sel]], remap[r[e_sel]], e_labels)


def scaffold_split(dataset, frac_train: float = 0.8, frac_valid: float = 0.1,
                   frac_test: float = 0.1) -> Dict[str, np.ndarray]:
    """Deterministic scaffold split: group molecules by scaffold key, order
    groups largest-first (ties by first occurrence), fill train to its cap,
    then valid, then test — the MoleculeNet/OGB scaffold-split recipe."""
    groups: Dict[str, list] = {}
    for i in range(len(dataset)):
        k = scaffold_key(dataset.graph2d(i))
        groups.setdefault(k, []).append(i)
    order = sorted(groups.values(), key=lambda g: (-len(g), g[0]))
    n = len(dataset)
    n_train = int(frac_train * n)
    n_valid = int(frac_valid * n)
    train, valid, test = [], [], []
    for g in order:
        if len(train) + len(g) <= n_train:
            train += g
        elif len(valid) + len(g) <= n_valid:
            valid += g
        else:
            test += g
    return {"train": np.array(sorted(train), np.int64),
            "valid": np.array(sorted(valid), np.int64),
            "test": np.array(sorted(test), np.int64)}


# ---------------------------------------------------------------------------
# OGB on-disk split consumption
# ---------------------------------------------------------------------------

def read_ogb_split_dir(split_dir: str) -> Optional[Dict[str, np.ndarray]]:
    """Read OGB's ``split/<type>/{train,valid,test}.csv.gz`` index files —
    the exact artifact `ogb.GraphPropPredDataset.get_idx_split` consumes."""
    out = {}
    for part in ("train", "valid", "test"):
        p = os.path.join(split_dir, f"{part}.csv.gz")
        if not os.path.exists(p):
            return None
        with gzip.open(p, "rt") as f:
            out[part] = np.array([int(row[0]) for row in csv.reader(f)
                                  if row], np.int64)
    return out


def get_idx_split(dataset, cache_dir: Optional[str] = None,
                  split_type: str = "scaffold") -> Dict[str, np.ndarray]:
    """`OGBGDatasetExtension.get_idx_split` equivalent.  Priority:
    (1) split arrays stored in the dataset cache, (2) OGB's csv.gz split
    dir next to the cache, (3) computed scaffold split."""
    stored = getattr(dataset, "split_indices", None)
    if stored:
        return {k: np.asarray(v, np.int64) for k, v in stored.items()}
    if cache_dir:
        found = read_ogb_split_dir(os.path.join(cache_dir, "split", split_type))
        if found:
            return found
    return scaffold_split(dataset)


# ---------------------------------------------------------------------------
# Reference random-split protocols
# ---------------------------------------------------------------------------

def get_random_indices(length: int, seed: int = 123) -> np.ndarray:
    """Split-index parity with reference commons/utils.py:31-36."""
    st0 = np.random.get_state()
    np.random.seed(seed)
    idx = np.random.permutation(length)
    np.random.set_state(st0)
    return idx


# model-pool sizes per dataset family (reference train.py:504-515)
_MODEL_POOL = {
    "drugs": 280_000,
    "qmugs": 620_000,
    "file_loader_qm9": 80_000,
    "file_loader_drugs": 160_000,
    "geom_qm9": 100_000,
    "qm9_geomol_feat": 100_000,
}


def reference_split_indices(args: Dict, n: int
                            ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(train_idx, val_idx, test_idx) per the reference's random protocol:

    * qm9 family (`train.py:566-585`): model pool = first 100k, test = 10%,
      val = rest; `num_val` switches to the contiguous
      [:num_train][num_train:+num_val][+num_val:+2num_val] layout.
    * geom family (`train.py:503-521`): family-specific model pool, test =
      5%, val = rest; file_loader sets clamp val to the last <=1000.
    """
    name = args["dataset"]
    all_idx = get_random_indices(n, args["seed_data"])
    geom_family = name in _MODEL_POOL
    pool = _MODEL_POOL.get(name, 100_000)
    if n < pool:
        pool = int(n * 0.8)
    model_idx = all_idx[:pool]
    test_frac = 0.05 if geom_family else 0.1
    test_idx = all_idx[len(model_idx): len(model_idx) + int(test_frac * n)]
    if name in ("file_loader_drugs", "file_loader_qm9"):
        val_idx = all_idx[max(len(model_idx) + len(test_idx), n - 1000):]
    else:
        val_idx = all_idx[len(model_idx) + len(test_idx):]
    num_train = args.get("num_train", -1)
    train_idx = model_idx[:num_train] if num_train and num_train > 0 \
        else model_idx
    num_val = args.get("num_val")
    if num_val and name.startswith("qm9"):
        # reference train.py:576-580
        train_idx = all_idx[:num_train] if num_train and num_train > 0 \
            else all_idx
        val_idx = all_idx[len(train_idx): len(train_idx) + num_val]
        test_idx = all_idx[len(train_idx) + num_val:
                           len(train_idx) + 2 * num_val]
    elif num_val:
        val_idx = val_idx[:num_val]
    return train_idx, val_idx, test_idx
