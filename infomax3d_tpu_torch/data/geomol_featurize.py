"""Host-side GeoMol structural featurization (port of `infomax3d_tpu/data/
geomol_featurize.py`): neighbourhoods, leaf-hydrogen permutations and
dihedral pairs as padded numpy arrays for the OT conformer model.

The dihedral pairs follow the reference's `get_dihedral_pairs` exactly,
ring prioritization included: candidate bonds (both endpoints of degree
> 1, start < end, in edge order) are walked in order; when both endpoints
sit in a not-yet-consumed basis cycle, the candidate is dropped and the
first such cycle's edges are emitted as directed consecutive pairs from the
first endpoint all the way around (the cycle is consumed); when only the
second endpoint is in a remaining cycle, the pair is kept and that cycle's
run follows it.  An undirected already-emitted check suppresses later
candidates that a run covered; runs themselves are emitted
unconditionally, so fused rings repeat their shared bond, as upstream.

The cycle basis is the port's own `cycle_basis`, cycle for cycle and in
order the one networkx computes on the reference's graph, so no graph
library is needed.
"""
from __future__ import annotations

from itertools import permutations
from typing import Dict, List

import numpy as np

MAX_NEIGHBORS = 4
N_PERMS = 6  # up to 3 symmetric leaf hydrogens -> 3! permutations


def _undirected_adjacency(senders, receivers, n: int) -> List[List[int]]:
    """Each node's neighbours in the iteration order of `nx.to_undirected`
    of a DiGraph over range(n) whose edges were added in edge_index order
    (the reference's `to_networkx`).  That function returns a view whose
    neighbour iteration is ``iter(set(succ[z].keys()) | set(pred[z].
    keys()))``, where the digraph's successor and predecessor dicts hold
    ids in first-insertion order; the same expression over dicts filled in
    the same order gives the same order (CPython's set order of ints is a
    function of the values and their insertion order, with no hash
    randomization).  The order decides which cycles the basis finds and
    their orientation."""
    succ: List[Dict[int, None]] = [{} for _ in range(n)]
    pred: List[Dict[int, None]] = [{} for _ in range(n)]
    for s, r in zip(senders, receivers):
        succ[int(s)].setdefault(int(r))
        pred[int(r)].setdefault(int(s))
    return [list(set(succ[z].keys()) | set(pred[z].keys()))
            for z in range(n)]


def cycle_basis(senders, receivers, n: int) -> List[List[int]]:
    """``nx.cycle_basis(nx.to_undirected(G))`` for the DiGraph G over
    range(n) with the directed edges (senders[i], receivers[i]) added in
    order: the same cycles, each in the same node order, in the same
    order.  networkx's algorithm (Paton, CACM 491) on the same adjacency
    order: roots taken from the end of the remaining nodes, a depth-first
    spanning tree walked from a stack, each non-tree edge closing one
    cycle."""
    adj = _undirected_adjacency(senders, receivers, n)
    remaining = dict.fromkeys(range(n))
    cycles: List[List[int]] = []
    while remaining:
        root = remaining.popitem()[0]
        stack = [root]
        pred = {root: root}
        used = {root: set()}
        while stack:
            z = stack.pop()
            zused = used[z]
            for nbr in adj[z]:
                if nbr not in used:
                    pred[nbr] = z
                    stack.append(nbr)
                    used[nbr] = {z}
                elif nbr == z:
                    cycles.append([z])
                elif nbr not in zused:
                    pn = used[nbr]
                    cycle = [nbr, z]
                    p = pred[z]
                    while p not in pn:
                        cycle.append(p)
                        p = pred[p]
                    cycle.append(p)
                    cycles.append(cycle)
                    used[nbr].add(z)
        for node in pred:
            remaining.pop(node, None)
    return cycles


def _cycle_run(cycle: List[int], start: int) -> List[List[int]]:
    """Directed consecutive edge pairs of `cycle` rotated to start at
    `start`, all the way around (k pairs for a k-cycle): the reference's
    `cycle_utils.get_cycle_indices`."""
    i = cycle.index(start)
    k = len(cycle)
    order = [cycle[(i + j) % k] for j in range(k)] + [start]
    return [[order[j], order[j + 1]] for j in range(k)]


def _pop_cycle_run(cycles: List[List[int]], idx: int) -> List[List[int]]:
    """Pop the first remaining cycle containing `idx` and return its edge
    run starting from `idx` (the reference's `get_current_cycle_indices`:
    the cycle is consumed)."""
    c_i = next(i for i, c in enumerate(cycles) if idx in c)
    return _cycle_run(cycles.pop(c_i), idx)


def _get_dihedral_pairs(senders, receivers, degree, n: int) -> np.ndarray:
    """The reference's `get_dihedral_pairs` (module docstring)."""
    pairs = [(int(s), int(r)) for s, r in zip(senders, receivers)
             if degree[int(s)] > 1 and degree[int(r)] > 1 and int(s) < int(r)]
    cycles = cycle_basis(senders, receivers, n)
    keep: List[List[int]] = []
    sorted_keep: List[List[int]] = []
    for x, y in pairs:
        if sorted((x, y)) in sorted_keep:
            continue
        x_in = any(x in c for c in cycles)
        y_in = any(y in c for c in cycles)
        if x_in and y_in:
            run = _pop_cycle_run(cycles, x)
            keep.extend(run)
            sorted_keep.extend(sorted(c) for c in run)
        elif y_in:
            run = _pop_cycle_run(cycles, y)
            keep.append([x, y])
            keep.extend(run)
            sorted_keep.append(sorted((x, y)))
            sorted_keep.extend(sorted(c) for c in run)
        else:
            keep.append([x, y])
    return np.asarray(keep, np.int32).reshape(-1, 2)


def geomol_featurize(graph: Dict[str, np.ndarray],
                     h_code_column: int = 0) -> Dict[str, np.ndarray]:
    """`graph`: one molecule (node_feat, senders, receivers).  Returns:

      nbh_center [Nh]         central atom of each neighbourhood (degree > 1)
      nbh_nbrs [Nh, 4]        neighbour atom ids (pad 0, see mask)
      nbh_mask [Nh, 4]
      nbh_perms [Nh, 6, 4]    hydrogen-permuted neighbour ids
      x_to_h [n_atoms]        atom -> neighbourhood row (or -1)
      dp [P, 2]               dihedral pairs (x, y), both of degree > 1
      x_map [P, 4], y_map [P, 4]       one-hot of the bond partner's slot
      dx_mask [P, 4], dy_mask [P, 4]   the two neighbourhoods' masks
    """
    n = graph["node_feat"].shape[0]
    senders = graph["senders"]
    receivers = graph["receivers"]
    nbrs: List[List[int]] = [[] for _ in range(n)]
    for s, r in zip(senders, receivers):
        nbrs[int(s)].append(int(r))
    nbrs = [list(dict.fromkeys(v)) for v in nbrs]   # unique, in order
    degree = np.array([len(v) for v in nbrs])
    # hydrogen: OGB atomic-number code 0
    is_h = graph["node_feat"][:, h_code_column] == 0

    centers = [a for a in range(n) if degree[a] > 1]
    nh = len(centers)
    nbh_center = np.zeros(nh, np.int32)
    nbh_nbrs = np.zeros((nh, MAX_NEIGHBORS), np.int32)
    nbh_mask = np.zeros((nh, MAX_NEIGHBORS), np.float32)
    nbh_perms = np.zeros((nh, N_PERMS, MAX_NEIGHBORS), np.int32)
    x_to_h = -np.ones(n, np.int32)
    for i, a in enumerate(centers):
        v = nbrs[a][:MAX_NEIGHBORS]
        nbh_center[i] = a
        nbh_nbrs[i, :len(v)] = v
        nbh_mask[i, :len(v)] = 1.0
        x_to_h[a] = i
        # leaf hydrogens; they count only when more than one is symmetric
        leaf = np.array([is_h[x] and degree[x] == 1 for x in v])
        if leaf.sum() <= 1:
            leaf = np.zeros_like(leaf)
        base = np.array(v + [0] * (MAX_NEIGHBORS - len(v)), np.int32)
        perms = np.tile(base, (N_PERMS, 1))
        if leaf.any():
            h_ids = [v[k] for k in range(len(v)) if leaf[k]]
            slots = [k for k in range(len(v)) if leaf[k]]
            for pi, perm in enumerate(permutations(h_ids)):
                if pi >= N_PERMS:
                    break
                row = base.copy()
                for slot, val in zip(slots, perm):
                    row[slot] = val
                perms[pi] = row
        nbh_perms[i] = perms

    dp_arr = _get_dihedral_pairs(senders, receivers, degree, n)

    p = len(dp_arr)
    x_map = np.zeros((p, MAX_NEIGHBORS), np.float32)
    y_map = np.zeros((p, MAX_NEIGHBORS), np.float32)
    dx_mask = np.zeros((p, MAX_NEIGHBORS), np.float32)
    dy_mask = np.zeros((p, MAX_NEIGHBORS), np.float32)
    for i, (s, r) in enumerate(dp_arr):
        hs, hr = x_to_h[s], x_to_h[r]
        x_map[i] = (nbh_nbrs[hs] == r) & (nbh_mask[hs] > 0)
        y_map[i] = (nbh_nbrs[hr] == s) & (nbh_mask[hr] > 0)
        dx_mask[i] = nbh_mask[hs]
        dy_mask[i] = nbh_mask[hr]
    # drop pairs whose bond partner is not within the (truncated) 4
    valid = (x_map.sum(1) == 1) & (y_map.sum(1) == 1)
    return dict(nbh_center=nbh_center, nbh_nbrs=nbh_nbrs, nbh_mask=nbh_mask,
                nbh_perms=nbh_perms, x_to_h=x_to_h,
                dp=dp_arr[valid], x_map=x_map[valid], y_map=y_map[valid],
                dx_mask=dx_mask[valid], dy_mask=dy_mask[valid])
