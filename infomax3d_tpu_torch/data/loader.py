"""The GeoMol optimal-transport batch (port of `ot_collate`,
`infomax3d_tpu/data/loader.py`): the bond graphs as the port's CSR batch,
plus the neighbourhood and dihedral-pair index arrays and the true
conformer positions, with the JAX package's names and values.

Node ids are those of the batch (the CSR sort permutes edges, not nodes),
so the OT arrays do not depend on the edge order; the graph's edge-keyed
arrays follow the receiver-sorted order as in every CSR batch.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Sequence

import numpy as np
import torch

from infomax3d_tpu_torch.data.geomol_featurize import geomol_featurize
from infomax3d_tpu_torch.graphs.batch import (BucketSpec, GraphBatch,
                                              batch_graphs, to_graph_batch)

OT_KEYS = ("nbh_center", "nbh_nbrs", "nbh_perms", "nbh_mask", "nbh_mol",
           "dp_x", "dp_y", "dp_x_h", "dp_y_h", "dp_x_nbrs", "dp_y_nbrs",
           "dp_xn_perms", "dp_yn_perms", "x_map", "y_map", "x_other",
           "y_other", "dihedral_mask", "dp_mol", "pos", "pos_mask")


def ot_collate(items: Sequence[Dict], bucket: BucketSpec,
               n_true_confs: int = 3) -> Dict[str, np.ndarray]:
    """One OT batch as numpy arrays: `batch_graphs` of the items'
    ``graph2d`` and the arrays of `OT_KEYS`.  Each item holds ``graph2d``
    and ``conformers3d`` (a list of dicts with ``coords`` [n, 3]), or a
    ``graph2d`` with its own ``coords`` (one conformer).  Neighbourhoods
    and pairs are padded to the batch's count + 8 (the JAX package's
    default); padding rows point at node N, neighbourhood NH and graph
    G."""
    graphs = [it["graph2d"] for it in items]
    arrays = batch_graphs(graphs, bucket)
    node_off = np.concatenate(
        [[0], np.cumsum([g["node_feat"].shape[0] for g in graphs])[:-1]]
    ).astype(np.int32)
    feats = [geomol_featurize(g) for g in graphs]

    NH = sum(len(f["nbh_center"]) for f in feats) + 8
    P = sum(len(f["dp"]) for f in feats) + 8
    N, G = bucket.n_nodes, bucket.n_graphs
    out = dict(
        nbh_center=np.full(NH, N, np.int32),
        nbh_nbrs=np.zeros((NH, 4), np.int32),
        nbh_perms=np.zeros((NH, 6, 4), np.int32),
        nbh_mask=np.zeros((NH, 4), np.float32),
        nbh_mol=np.full(NH, G, np.int32),
        dp_x=np.full(P, N, np.int32), dp_y=np.full(P, N, np.int32),
        dp_x_h=np.full(P, NH, np.int32), dp_y_h=np.full(P, NH, np.int32),
        dp_x_nbrs=np.zeros((P, 4), np.int32),
        dp_y_nbrs=np.zeros((P, 4), np.int32),
        dp_xn_perms=np.zeros((P, 6, 4), np.int32),
        dp_yn_perms=np.zeros((P, 6, 4), np.int32),
        x_map=np.zeros((P, 4), np.float32), y_map=np.zeros((P, 4), np.float32),
        x_other=np.zeros((P, 3), np.int32), y_other=np.zeros((P, 3), np.int32),
        dihedral_mask=np.zeros((P, 9), np.float32),
        dp_mol=np.full(P, G, np.int32))

    oh, op = 0, 0
    for m, f in enumerate(feats):
        off = node_off[m]
        nh = len(f["nbh_center"])
        out["nbh_center"][oh:oh + nh] = f["nbh_center"] + off
        out["nbh_nbrs"][oh:oh + nh] = f["nbh_nbrs"] + off
        out["nbh_perms"][oh:oh + nh] = f["nbh_perms"] + off
        out["nbh_mask"][oh:oh + nh] = f["nbh_mask"]
        out["nbh_mol"][oh:oh + nh] = m
        for i, (s, r) in enumerate(f["dp"]):
            j = op + i
            out["dp_x"][j], out["dp_y"][j] = s + off, r + off
            hs, hr = f["x_to_h"][s], f["x_to_h"][r]
            out["dp_x_h"][j], out["dp_y_h"][j] = oh + hs, oh + hr
            out["dp_x_nbrs"][j] = f["nbh_nbrs"][hs] + off
            out["dp_y_nbrs"][j] = f["nbh_nbrs"][hr] + off
            out["dp_xn_perms"][j] = f["nbh_perms"][hs] + off
            out["dp_yn_perms"][j] = f["nbh_perms"][hr] + off
            out["x_map"][j] = f["x_map"][i]
            out["y_map"][j] = f["y_map"][i]
            x_other = np.nonzero(f["x_map"][i] == 0)[0][:3]
            y_other = np.nonzero(f["y_map"][i] == 0)[0][:3]
            out["x_other"][j], out["y_other"][j] = x_other, y_other
            dx = f["dx_mask"][i][x_other]
            dy = f["dy_mask"][i][y_other]
            out["dihedral_mask"][j] = (dx[:, None] * dy[None, :]).reshape(9)
            out["dp_mol"][j] = m
        oh += nh
        op += len(f["dp"])

    # true conformer positions [N, T, 3] and the per-molecule mask [G, T]
    pos = np.zeros((N, n_true_confs, 3), np.float32)
    pos_mask = np.zeros((G, n_true_confs), np.float32)
    for m, g in enumerate(graphs):
        off = node_off[m]
        n = g["node_feat"].shape[0]
        confs = items[m].get("conformers3d")
        if confs is not None:
            for c, cg in enumerate(confs[:n_true_confs]):
                pos[off:off + n, c] = cg["coords"]
                pos_mask[m, c] = 1.0
        elif g.get("coords") is not None:
            pos[off:off + n, 0] = g["coords"]
            pos_mask[m, 0] = 1.0
    out.update(pos=pos, pos_mask=pos_mask)
    arrays.update(out)
    return arrays


@dataclasses.dataclass(frozen=True)
class OTBatch:
    """An OT batch on a device: the CSR `graph` and the OT arrays `ex`
    (`OT_KEYS`, the JAX batch's extras of the same names)."""
    graph: GraphBatch
    ex: Dict[str, torch.Tensor]


def to_ot_batch(arrays: Dict[str, np.ndarray], bucket: BucketSpec,
                device) -> OTBatch:
    """`ot_collate`'s arrays -> `OTBatch` on `device`."""
    return OTBatch(to_graph_batch(arrays, bucket, device),
                   {k: torch.from_numpy(np.ascontiguousarray(arrays[k])).to(
                       device) for k in OT_KEYS})
