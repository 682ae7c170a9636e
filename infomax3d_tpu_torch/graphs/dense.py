"""Dense padded per-graph batches (port of `infomax3d_tpu/graphs/dense.py`).

Each molecule takes one row of [G, nmax, ...] arrays: atom codes, a node
mask and, where the molecules carry them, the 3D coordinates; padding
slots are zero and masked.  Net3DDense reads the ``with_edges=False`` form
(the complete 3D graph is implicit: every pair of real, distinct atoms).
The transformer's form adds the bond codes on the [G, nmax, nmax] pair
grid with the real-bond mask, the Laplacian PE [G, nmax, k, 2] (eigenvalue,
eigenvector entry) with its mask, and per-graph extras such as the targets
(the padding graphs' rows NaN).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from infomax3d_tpu_torch.graphs.batch import to_tensors


def dense_batch(graphs: Sequence[Dict[str, np.ndarray]], n_graphs: int,
                max_nodes: int, extras_keys: Sequence[str] = (),
                with_edges: bool = False, num_lap_pe: int = 0
                ) -> Dict[str, np.ndarray]:
    """Pad per-molecule dicts into dense host arrays, as the JAX
    `dense_batch` does: node_feat [G, nmax, F], node_mask [G, nmax],
    coords [G, nmax, 3] float32 (where the first molecule has them);
    with `with_edges`, edge_codes [G, nmax, nmax, Fe] and real_edge_mask;
    with `num_lap_pe` k > 0, lap_pe [G, nmax, k, 2] float32 and
    lap_pe_mask (true on each atom's first min(k, the molecule's
    frequencies) entries); each of `extras_keys` stacked [G, ...] (float
    rows of the padding graphs NaN); graph_mask [G]."""
    g_real = len(graphs)
    if g_real == 0 or g_real > n_graphs:
        raise ValueError(f"got {g_real} graphs for {n_graphs} slots")
    f0 = graphs[0]
    nf = f0["node_feat"]
    node_feat = np.zeros((n_graphs, max_nodes) + nf.shape[1:], dtype=nf.dtype)
    node_mask = np.zeros((n_graphs, max_nodes), dtype=bool)
    edge_codes = real_edge_mask = None
    if with_edges and f0.get("edge_feat") is not None:
        edge_codes = np.zeros((n_graphs, max_nodes, max_nodes,
                               f0["edge_feat"].shape[1]),
                              dtype=f0["edge_feat"].dtype)
        real_edge_mask = np.zeros((n_graphs, max_nodes, max_nodes), bool)
    coords = None
    if f0.get("coords") is not None:
        coords = np.zeros((n_graphs, max_nodes, 3), dtype=np.float32)
    lap_pe = lap_pe_mask = None
    if num_lap_pe > 0:
        lap_pe = np.zeros((n_graphs, max_nodes, num_lap_pe, 2), np.float32)
        lap_pe_mask = np.zeros((n_graphs, max_nodes, num_lap_pe), bool)
    for i, g in enumerate(graphs):
        n = g["node_feat"].shape[0]
        if n > max_nodes:
            raise ValueError(f"molecule with {n} atoms > max_nodes "
                             f"{max_nodes}")
        node_feat[i, :n] = g["node_feat"]
        node_mask[i, :n] = True
        if edge_codes is not None:
            s, r = g["senders"], g["receivers"]
            edge_codes[i, s, r] = g["edge_feat"]
            real_edge_mask[i, s, r] = True
        if coords is not None and g.get("coords") is not None:
            coords[i, :n] = g["coords"]
        if lap_pe is not None and g.get("lap_pe") is not None:
            k = min(g["lap_pe"].shape[1], num_lap_pe)
            lap_pe[i, :n, :k] = g["lap_pe"][:, :k]
            lap_pe_mask[i, :n, :k] = True
    out = dict(node_feat=node_feat, node_mask=node_mask)
    if edge_codes is not None:
        out.update(edge_codes=edge_codes, real_edge_mask=real_edge_mask)
    if coords is not None:
        out["coords"] = coords
    if lap_pe is not None:
        out.update(lap_pe=lap_pe, lap_pe_mask=lap_pe_mask)
    for key in extras_keys:
        vals = [np.asarray(g[key]) for g in graphs]
        buf = np.zeros((n_graphs,) + vals[0].shape, dtype=vals[0].dtype)
        buf[:g_real] = np.stack(vals)
        if np.issubdtype(buf.dtype, np.floating):
            buf[g_real:] = np.nan
        out[key] = buf
    out["graph_mask"] = np.zeros(n_graphs, dtype=bool)
    out["graph_mask"][:g_real] = True
    return out


@dataclasses.dataclass(frozen=True)
class DenseBatch:
    """A dense padded batch as torch tensors; the fields its collate did
    not write are None."""
    node_feat: torch.Tensor       # [G, nmax, 9] int32 atom codes
    node_mask: torch.Tensor       # [G, nmax] bool
    graph_mask: torch.Tensor      # [G] bool
    coords: Optional[torch.Tensor] = None          # [G, nmax, 3] float32
    edge_codes: Optional[torch.Tensor] = None      # [G, nmax, nmax, 3]
    real_edge_mask: Optional[torch.Tensor] = None  # [G, nmax, nmax] bool
    lap_pe: Optional[torch.Tensor] = None          # [G, nmax, k, 2] float32
    lap_pe_mask: Optional[torch.Tensor] = None     # [G, nmax, k] bool
    targets: Optional[torch.Tensor] = None         # [G, T] float32, NaN pad

    def to(self, device) -> "DenseBatch":
        return dataclasses.replace(
            self, **{f.name: getattr(self, f.name).to(device)
                     for f in dataclasses.fields(self)
                     if getattr(self, f.name) is not None})


def to_dense_batch(arrays: Dict[str, np.ndarray], device) -> DenseBatch:
    """Host arrays of `dense_batch` -> `DenseBatch` on `device` (through
    `graphs/batch.py::to_tensors`, which counts what it hands over)."""
    return DenseBatch(**to_tensors(
        arrays, [f.name for f in dataclasses.fields(DenseBatch)
                 if f.name in arrays], device))
