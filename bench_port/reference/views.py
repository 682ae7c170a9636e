"""The batches the reference's models read, built from the raw molecules
(`molecules.py`: ``node_feat``, ``senders``, ``receivers``, ``edge_feat``,
``conformers`` [C, n, 3]) on the device, with no import of the port: the
bond graphs, and one complete graph per conformer, molecule-major."""
from __future__ import annotations

from typing import Dict, Mapping, Sequence

import numpy as np
import torch


def _tensor(a, device, dtype=torch.long) -> torch.Tensor:
    return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype,
                           device=device)


def bond_graphs(mols: Sequence[Mapping[str, np.ndarray]], device) -> Dict:
    """The molecules' bond graphs as one batch: ``atoms`` [N, 9], ``bonds``
    [E, 3], ``senders`` / ``receivers`` [E], ``node_graph`` [N],
    ``n_graphs``."""
    sizes = np.array([m["node_feat"].shape[0] for m in mols])
    first = np.concatenate([[0], np.cumsum(sizes)[:-1]])
    return {"atoms": _tensor(np.concatenate([m["node_feat"] for m in mols]),
                             device),
            "bonds": _tensor(np.concatenate([m["edge_feat"] for m in mols]),
                             device),
            "senders": _tensor(np.concatenate([m["senders"] + o for m, o
                                               in zip(mols, first)]), device),
            "receivers": _tensor(np.concatenate([m["receivers"] + o for m, o
                                                 in zip(mols, first)]),
                                 device),
            "node_graph": _tensor(np.repeat(np.arange(len(mols)), sizes),
                                  device),
            "n_graphs": len(mols)}


def complete_graphs(sizes: torch.Tensor):
    """(senders, receivers) of the complete graphs of node counts `sizes`
    (consecutive node blocks), sender-major within each graph."""
    pairs = sizes * (sizes - 1)
    graph = torch.repeat_interleave(torch.arange(sizes.shape[0],
                                                 device=sizes.device), pairs)
    first_pair = torch.cumsum(pairs, 0) - pairs
    first_node = torch.cumsum(sizes, 0) - sizes
    local = torch.arange(graph.shape[0], device=sizes.device) - \
        first_pair[graph]
    n1 = (sizes - 1)[graph]
    i = torch.div(local, n1, rounding_mode="floor")
    j = local - i * n1
    j = j + (j >= i).long()
    return first_node[graph] + i, first_node[graph] + j


def conformer_graphs(mols: Sequence[Mapping[str, np.ndarray]],
                     device) -> Dict:
    """One complete graph per conformer, molecule-major, as one batch:
    ``senders`` / ``receivers`` [E], ``dist`` [E], ``node_graph`` [N],
    ``n_graphs`` (B * C)."""
    sizes = np.array([m["node_feat"].shape[0] for m in mols])
    C = mols[0]["conformers"].shape[0]
    sizes3 = _tensor(np.repeat(sizes, C), device)
    coords = _tensor(np.concatenate([m["conformers"].reshape(-1, 3)
                                     for m in mols]), device, torch.float32)
    src, dst = complete_graphs(sizes3)
    return {"senders": src, "receivers": dst,
            "dist": torch.linalg.vector_norm(coords[src] - coords[dst],
                                             dim=-1),
            "node_graph": torch.repeat_interleave(
                torch.arange(sizes3.shape[0], device=device), sizes3),
            "n_graphs": int(sizes3.shape[0])}
