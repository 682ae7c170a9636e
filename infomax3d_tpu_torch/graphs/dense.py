"""Dense padded per-graph batches (port of `infomax3d_tpu/graphs/dense.py`,
the ``with_edges=False`` form that Net3DDense reads).

Each molecule takes one row of [G, nmax, ...] arrays: atom codes, a node
mask and the 3D coordinates; padding slots are zero and masked.  The
complete 3D graph is implicit: every pair of real, distinct atoms.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Sequence

import numpy as np
import torch


def dense_batch(graphs: Sequence[Dict[str, np.ndarray]], n_graphs: int,
                max_nodes: int) -> Dict[str, np.ndarray]:
    """Pad per-molecule dicts (``node_feat``, optional ``coords``) into
    dense host arrays: node_feat [G, nmax, F], node_mask [G, nmax], coords
    [G, nmax, 3] float32, graph_mask [G]."""
    g_real = len(graphs)
    if g_real == 0 or g_real > n_graphs:
        raise ValueError(f"got {g_real} graphs for {n_graphs} slots")
    nf = graphs[0]["node_feat"]
    node_feat = np.zeros((n_graphs, max_nodes) + nf.shape[1:], dtype=nf.dtype)
    node_mask = np.zeros((n_graphs, max_nodes), dtype=bool)
    with_coords = graphs[0].get("coords") is not None
    coords = np.zeros((n_graphs, max_nodes, 3), dtype=np.float32)
    for i, g in enumerate(graphs):
        n = g["node_feat"].shape[0]
        if n > max_nodes:
            raise ValueError(f"molecule with {n} atoms > max_nodes "
                             f"{max_nodes}")
        node_feat[i, :n] = g["node_feat"]
        node_mask[i, :n] = True
        if with_coords and g.get("coords") is not None:
            coords[i, :n] = g["coords"]
    out = dict(node_feat=node_feat, node_mask=node_mask)
    if with_coords:
        out["coords"] = coords
    out["graph_mask"] = np.zeros(n_graphs, dtype=bool)
    out["graph_mask"][:g_real] = True
    return out


@dataclasses.dataclass(frozen=True)
class DenseBatch:
    """A dense padded batch as torch tensors."""
    node_feat: torch.Tensor       # [G, nmax, 9] int32 atom codes
    node_mask: torch.Tensor       # [G, nmax] bool
    coords: torch.Tensor          # [G, nmax, 3] float32 (bf16 in the recipe)
    graph_mask: torch.Tensor      # [G] bool

    def to(self, device) -> "DenseBatch":
        return dataclasses.replace(
            self, **{f.name: getattr(self, f.name).to(device)
                     for f in dataclasses.fields(self)})


def to_dense_batch(arrays: Dict[str, np.ndarray], device) -> DenseBatch:
    """Host arrays of `dense_batch` (with coordinates) -> `DenseBatch` on
    `device`."""
    return DenseBatch(**{
        f.name: torch.from_numpy(np.ascontiguousarray(arrays[f.name])).to(
            device) for f in dataclasses.fields(DenseBatch)})
