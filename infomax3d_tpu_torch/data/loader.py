"""Host data pipeline (port of `infomax3d_tpu/data/loader.py`): the collate
registry and `GraphDataLoader`.

Collates turn per-molecule item dicts into one batch of numpy arrays per
view, with the JAX package's names and values: `graph_collate` (the CSR
bond graph with NaN-padded targets), `graph_only_collate` (the bond graph
alone), `contrastive_collate` (the CSR 2D batch and the 3D batch: the
dense one Net3DDense reads, or the CSR complete graph of the flat Net3D)
and `contrastive_collate_ae`, `conformer_collate` (the CSR 2D batch and C
conformer complete graphs per molecule, packed molecule-major),
`pairwise_distance_collate` (the bond graph and the CSR complete graphs on
its node slots, the distance predictors' pair view), the
augmentations (`noised_distances_collate`, `noised_coordinates_collate`,
`node_drop_3d_collate`, `node_drop_2d3d_collate`, `graphcl_collate`) and
`ot_collate` (the CSR bond graph plus the neighbourhood and dihedral-pair
index arrays and the true conformer positions), and the dense batches of
the transformer (`san_collate`, `padded_collate_positional_encoding`:
padded atom and bond codes, the real-bond mask, the Laplacian PE, the
NaN-padded targets) and of the dense EGNN (`egnn_padded_collate`,
`molhiv_padded_collate`: padded atom codes, coordinates and targets), and
SMP's radius graphs with their triplets (`smp_collate`).  Node ids are
those of the batch (the CSR sort permutes edges, not nodes), so the OT
arrays do not depend on the edge order; the graph's edge-keyed arrays
follow the receiver-sorted order as in every CSR batch (a non-CSR bucket
keeps the collate's edge order).  A graph view also carries its bucket's
static bounds (``max_deg``, ``nmax``, 0-d int arrays) so `to_device` can
rebuild the `GraphBatch`.

The augmentations draw from ``np.random.default_rng(0)`` built anew on
every call when no `rng` is passed, as the JAX package's do (its CLI
passes none), so every batch of a run gets the same draws.

`GraphDataLoader` shuffles with `np.random.default_rng(seed)` (one
permutation per epoch) or takes its index lists from a `batch_sampler`
(`data/samplers.py`), drops the last partial batch when `drop_last` (the
contrastive collates need full batches), picks each batch's bucket from a
`ladder` when it has no fixed bucket, and collates on a prefetch
thread whose errors are re-raised on the consuming thread.  Batches leave
it as numpy arrays; the trainer moves them to its device.
"""
from __future__ import annotations

import dataclasses
import queue as queue_mod
import threading
from typing import Callable, Dict, Iterator, Optional, Sequence

import numpy as np
import torch

from infomax3d_tpu_torch.data.featurize import (lap_pe_node_array,
                                                random_sign_flip)
from infomax3d_tpu_torch.data.geomol_featurize import geomol_featurize
from infomax3d_tpu_torch.data.smp_featurize import smp_featurize
from infomax3d_tpu_torch.data.synthetic import complete_graph_from_coords
from infomax3d_tpu_torch.graphs.batch import (BucketSpec, GraphBatch,
                                              batch_graphs, bucket_for,
                                              pick_bucket, row_pointers,
                                              to_graph_batch, to_tensors)
from infomax3d_tpu_torch.graphs.dense import dense_batch, to_dense_batch

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


def to_ot_batch(arrays: Dict[str, np.ndarray], bucket: Optional[BucketSpec],
                device) -> OTBatch:
    """`ot_collate`'s arrays -> `OTBatch` on `device`; without `bucket`,
    the arrays are the loader's view and carry its bounds (`to_device`)."""
    graph = to_device(arrays, device) if bucket is None else \
        to_graph_batch(arrays, bucket, device)
    return OTBatch(graph, to_tensors(arrays, OT_KEYS, device))


# --------------------------------------------------------------- collates

COLLATE_REGISTRY: Dict[str, Callable] = {}

# Reference YAML collate names -> canonical registry names (the JAX
# package's table, data/loader.py:41-66)
COLLATE_ALIASES: Dict[str, str] = {
    "NodeDropCollate": "graphcl_collate",
    "NodeDrop2dCollate": "graphcl_collate",
    "NodeDrop3dCollate": "node_drop_3d_collate",
    "NodeDrop2d3DCollate": "node_drop_2d3d_collate",
    "NoisedDistancesCollate": "noised_distances_collate",
    "NoisedCoordinatesCollate": "noised_coordinates_collate",
    "pyg_and_dgl_graph_collate": "ot_collate",
    "pyg_graph_only_collate": "graph_only_collate",
    "pytorch_geometric_collate": "graph_collate",
    "ConformerCollate": "conformer_collate",
    "pytorch_geometric2d_contrastive_collate": "contrastive_collate",
    "pytorch_geometric3d_contrastive_collate": "contrastive_collate",
    "contrastive_graphs_with_mask_collate": "contrastive_collate",
    "contrastive_vae_collate": "contrastive_collate_ae",
    "s_norm_graph_collate": "graph_collate",
    "s_norm_contrastive_collate": "contrastive_collate",
    "pna_transformer_collate": "graph_collate",
    "pna_transformer_collate_contrastive": "contrastive_collate",
    "padded_collate": "egnn_padded_collate",
    "egnn_padded_collate3d": "egnn_padded_collate",
    "padded_distances_collate": "pairwise_distance_collate",
}

# the collates of dense batches (`max_nodes` slots per graph)
DENSE_COLLATES = ("san_collate", "padded_collate_positional_encoding",
                  "egnn_padded_collate", "molhiv_padded_collate")

def register_collate(name):
    def deco(fn):
        COLLATE_REGISTRY[name] = fn
        return fn
    return deco


def get_collate(name: str):
    name = COLLATE_ALIASES.get(name, name)
    if name not in COLLATE_REGISTRY:
        raise KeyError(f"unknown collate_function '{name}'; known: "
                       f"{sorted(COLLATE_REGISTRY)}")
    return COLLATE_REGISTRY[name]


def _batch_view(arrays: Dict[str, np.ndarray], bucket: BucketSpec
                ) -> Dict[str, np.ndarray]:
    """A collated batch's arrays with its bucket's static bounds, which
    `to_device` reads back (a CSR bucket is known by its arrays)."""
    arrays["max_deg"] = np.asarray(bucket.max_deg, np.int64)
    arrays["nmax"] = np.asarray(bucket.nmax, np.int64)
    return arrays


def _nan_targets(arrays: Dict[str, np.ndarray], g_real: int):
    """Padded target rows become NaN so masked losses ignore them."""
    arrays["targets"][g_real:] = np.nan
    return arrays


@register_collate("graph_collate")
def graph_collate(items: Sequence[Dict], bucket: BucketSpec):
    """The bond graphs with their targets (custom_collate.py:12-18)."""
    merged = [dict(it["graph2d"], targets=it["targets"]) for it in items]
    arrays = _nan_targets(batch_graphs(merged, bucket), len(items))
    return {"graph": _batch_view(arrays, bucket)}


def _bonds_only(items: Sequence[Dict], bucket: BucketSpec):
    """The batch of the items' bond graphs, without targets."""
    return _batch_view(batch_graphs([it["graph2d"] for it in items], bucket),
                     bucket)


def _graph2d(items: Sequence[Dict], bucket: BucketSpec):
    """The 2D batch of `items`, with NaN-padded targets when they have
    targets."""
    if "targets" not in items[0]:
        return _bonds_only(items, bucket)
    return _batch_view(_nan_targets(batch_graphs(
        [dict(it["graph2d"], targets=it["targets"]) for it in items],
        bucket), len(items)), bucket)


def complete_graphs(graphs: Sequence[Dict], bucket: Optional[BucketSpec],
                    n_graphs: int) -> Dict[str, np.ndarray]:
    """The batch of 3D complete graphs (`complete_graph_from_coords`
    dicts) in `bucket`, or, without one, in the smallest bucket of
    `n_graphs` graphs that holds them (`bucket_for`: `max_deg` the largest
    n - 1, `nmax` the largest n)."""
    bucket = bucket or bucket_for(graphs, n_graphs)
    return _batch_view(batch_graphs(graphs, bucket), bucket)


@register_collate("contrastive_collate")
def contrastive_collate(items: Sequence[Dict], bucket: BucketSpec,
                        bucket3d: Optional[BucketSpec] = None,
                        dense_3d: bool = False,
                        max_nodes3d: Optional[int] = None):
    """[2D graphs], [3D views], optional targets (custom_collate.py:
    105-114).  The 3D side is the dense batch Net3DDense reads with
    ``dense_3d``, else the CSR complete graph of the flat Net3D, in
    `bucket3d` (which sizes only that flat graph)."""
    g2 = _graph2d(items, bucket)
    mols3 = [it["graph3d"] for it in items]
    if not dense_3d:
        return {"graph2d": g2, "graph3d": complete_graphs(
            mols3, bucket3d, bucket.n_graphs)}
    nmax = max_nodes3d or max(m["node_feat"].shape[0] for m in mols3)
    return {"graph2d": g2,
            "graph3d": dense_batch(mols3, bucket.n_graphs, nmax)}


@register_collate("conformer_collate")
def conformer_collate(items: Sequence[Dict], bucket: BucketSpec,
                      bucket3d: Optional[BucketSpec] = None,
                      num_conformers: Optional[int] = None):
    """2D graphs and C conformer complete graphs per molecule, packed
    molecule-major: all conformers of molecule 0, then of molecule 1, ...
    (custom_collate.py:155-157, qmugs_dataset.py:149-166), the order the
    multi-positive losses reshape to [B, C, D].  `num_conformers` (from
    `collate_params`) caps C; `bucket3d` holds B * C graphs."""
    confs = [c for it in items
             for c in it["conformers3d"][:num_conformers or None]]
    n_conf = len(items[0]["conformers3d"][:num_conformers or None])
    return {"graph2d": _bonds_only(items, bucket),
            "graph3d": complete_graphs(confs, bucket3d,
                                       bucket.n_graphs * n_conf)}


@register_collate("graph_only_collate")
def graph_only_collate(items: Sequence[Dict], bucket: BucketSpec):
    """The bond graphs alone (custom_collate.py:37-40)."""
    return {"graph": _bonds_only(items, bucket)}


@register_collate("contrastive_collate_ae")
def contrastive_collate_ae(items, bucket, bucket3d=None):
    """The autoencoder trainer's batch: `contrastive_collate`'s with the
    flat 3D side, whose `edge_dist` are the reconstruction targets."""
    return contrastive_collate(items, bucket, bucket3d)


@register_collate("pairwise_distance_collate")
def pairwise_distance_collate(items: Sequence[Dict], bucket: BucketSpec,
                              bucket3d: Optional[BucketSpec] = None,
                              graph_3d: bool = False):
    """The 2D graphs and their pair view, the CSR complete graphs whose
    edges carry the true distances (reference custom_collate.py:65-78),
    laid out on the 2D bucket's node slots so the two views' node indices
    coincide: `bucket3d` (or the smallest bucket of `complete_graphs`)
    with `bucket`'s node count.  With `graph_3d` the pair view is also
    the model's input (the Net3DDistancePredictor protocol); both keys
    then hold the same arrays."""
    mols3 = [it["graph3d"] for it in items]
    b3 = bucket3d or bucket_for(mols3, bucket.n_graphs)
    pairs = complete_graphs(mols3, dataclasses.replace(
        b3, n_nodes=bucket.n_nodes), bucket.n_graphs)
    if graph_3d:
        return {"graph": pairs, "pairs": pairs}
    return {"graph": _bonds_only(items, bucket), "pairs": pairs}


@register_collate("noised_distances_collate")
def noised_distances_collate(items: Sequence[Dict], bucket: BucketSpec,
                             bucket3d: Optional[BucketSpec] = None,
                             std: float = 0.1, num_noised: int = 1,
                             rng: Optional[np.random.Generator] = None):
    """Contrastive batch + `num_noised` copies of the 3D view with Gaussian
    noise on the edge distances, appended as extra negatives
    (NoisedDistancesCollate, custom_collate.py:131-152)."""
    rng = rng or np.random.default_rng(0)
    out = contrastive_collate(items, bucket, bucket3d)
    noised = []
    for _ in range(num_noised):
        copies = []
        for it in items:
            g = it["graph3d"]
            copies.append(dict(g, edge_dist=(g["edge_dist"] + rng.normal(
                scale=std, size=g["edge_dist"].shape)).astype(np.float32)))
        noised.append(complete_graphs(copies, bucket3d, bucket.n_graphs))
    out["noisy3d"] = noised[0] if num_noised == 1 else noised
    return out


@register_collate("noised_coordinates_collate")
def noised_coordinates_collate(items: Sequence[Dict], bucket: BucketSpec,
                               bucket3d: Optional[BucketSpec] = None,
                               std: float = 0.1, num_noised: int = 1,
                               rng: Optional[np.random.Generator] = None):
    """Noise the COORDINATES and recompute distances
    (NoisedCoordinatesCollate, custom_collate.py:160-185)."""
    rng = rng or np.random.default_rng(0)
    out = contrastive_collate(items, bucket, bucket3d)
    noised = []
    for _ in range(num_noised):
        copies = []
        for it in items:
            g = it["graph3d"]
            coords = g["coords"] + rng.normal(
                scale=std, size=g["coords"].shape).astype(np.float32)
            d = np.linalg.norm(coords[g["senders"]] - coords[g["receivers"]],
                               axis=-1).astype(np.float32)
            copies.append(dict(g, coords=coords, edge_dist=d))
        noised.append(complete_graphs(copies, bucket3d, bucket.n_graphs))
    out["noisy3d"] = noised[0] if num_noised == 1 else noised
    return out


def _node_drop_3d(g3: Dict, keep: np.ndarray) -> Dict:
    """The complete graph on the kept nodes."""
    return complete_graph_from_coords(dict(node_feat=g3["node_feat"][keep],
                                           coords=g3["coords"][keep]))


@register_collate("node_drop_3d_collate")
def node_drop_3d_collate(items, bucket, bucket3d=None, num_drop: int = 3,
                         rng: Optional[np.random.Generator] = None):
    """Randomly remove up to num_drop atoms from the 3D view only
    (NodeDrop3dCollate, custom_collate.py:188-206)."""
    rng = rng or np.random.default_rng(0)
    dropped = []
    for it in items:
        g3 = it["graph3d"]
        n = g3["node_feat"].shape[0]
        k = int(rng.integers(0, num_drop))
        keep = np.setdiff1d(np.arange(n),
                            rng.integers(0, n, size=k)) if k else np.arange(n)
        dropped.append(_node_drop_3d(g3, keep))
    return {"graph2d": _bonds_only(items, bucket),
            "graph3d": complete_graphs(dropped, bucket3d, bucket.n_graphs)}


@register_collate("node_drop_2d3d_collate")
def node_drop_2d3d_collate(items, bucket, bucket3d=None,
                           drop_ratio: float = 0.1,
                           rng: Optional[np.random.Generator] = None):
    """Independently drop a fraction of atoms from BOTH views
    (NodeDrop2d3DCollate, custom_collate.py:208-229)."""
    rng = rng or np.random.default_rng(0)
    g2s, g3s = [], []
    for it in items:
        g2s.append(node_drop(it["graph2d"], rng, drop_ratio))
        g3 = it["graph3d"]
        n = g3["node_feat"].shape[0]
        keep = np.sort(rng.permutation(n)[: n - int(drop_ratio * n)])
        g3s.append(_node_drop_3d(g3, keep))
    return {"graph2d": _batch_view(batch_graphs(g2s, bucket), bucket),
            "graph3d": complete_graphs(g3s, bucket3d, bucket.n_graphs)}


def edge_positions(graphs: Sequence[Dict], receivers: np.ndarray,
                   num_nodes: int) -> np.ndarray:
    """[E] int64: where `batch_graphs`' stable receiver sort puts each
    edge of the molecules' edge lists concatenated in molecule order (the
    order `smp_featurize`'s triplet ids count in, offset per molecule);
    padding edges map onto themselves.  `receivers` is the sorted batch's,
    which the sort is checked against."""
    E = receivers.shape[0]
    n_off = np.concatenate([[0], np.cumsum([len(g["node_feat"])
                                            for g in graphs])[:-1]])
    rec = np.full(E, num_nodes, np.int64)
    e_tot = sum(len(g["receivers"]) for g in graphs)
    rec[:e_tot] = np.concatenate([g["receivers"] + n_off[m]
                                  for m, g in enumerate(graphs)])
    order = np.argsort(rec, kind="stable")
    if not np.array_equal(rec[order], receivers):
        raise ValueError("edge_positions: not the batch's receiver sort")
    inv = np.empty(E, np.int64)
    inv[order] = np.arange(E)
    return inv


@register_collate("smp_collate")
def smp_collate(items: Sequence[Dict], bucket: Optional[BucketSpec],
                cutoff: float = 5.0, n_triplets: Optional[int] = None):
    """SMP's batch (the JAX package's `smp_collate`, the reference's
    xyztodat on the host): the molecules' radius graphs (cutoff in
    angstrom, `data/smp_featurize.py`) as a CSR batch with their distances,
    coordinates and NaN-padded targets, and the triplets k -> j -> i in a
    bucket of `n_triplets` (the total plus 64 by default): `angle`,
    `torsion`, `idx_kj`, `idx_ji`, `tri_mask`.  The triplets' edge ids
    follow the receiver sort of the edges (molecule-order edge e sits at
    the sort's inverse permutation of e); the triplets are sorted by
    `idx_ji` (stable), with `tri_ji_ptr` [E + 1] over them (the CSR sum of
    their messages onto each edge j -> i), and `tri_kj_perm` /
    `tri_kj_ptr` give them in `idx_kj` order (the backward of the gather
    ``x_kj[idx_kj]``).  Padding triplets point at edge id E, sort last and
    carry no weight.  Without a bucket, the smallest CSR bucket of the
    radius graphs (`bucket_for`) holds the batch."""
    graphs, feats = [], []
    for it in items:
        mol = it["graph2d"] if "coords" in it["graph2d"] else it["graph3d"]
        f = smp_featurize(mol["coords"], cutoff=cutoff)
        g = dict(node_feat=mol["node_feat"], senders=f["senders"],
                 receivers=f["receivers"], edge_dist=f["dist"],
                 coords=mol["coords"])
        if "targets" in it:
            g["targets"] = it["targets"]
        graphs.append(g)
        feats.append(f)
    bucket = bucket or bucket_for(graphs, len(items))
    arrays = batch_graphs(graphs, bucket)
    if "targets" in items[0]:
        _nan_targets(arrays, len(items))
    E = bucket.n_edges
    inv = edge_positions(graphs, arrays["receivers"], bucket.n_nodes)
    e_off = np.concatenate([[0], np.cumsum([len(f["senders"])
                                            for f in feats])[:-1]])
    counts = [int(f["tri_count"]) for f in feats]
    T = n_triplets or sum(counts) + 64
    if sum(counts) > T:
        raise ValueError(f"triplet bucket {T} too small")
    angle = np.zeros(T, np.float32)
    torsion = np.zeros(T, np.float32)
    idx_kj = np.full(T, E, np.int64)
    idx_ji = np.full(T, E, np.int64)
    tri_mask = np.zeros(T, bool)
    o = 0
    for m, (f, c) in enumerate(zip(feats, counts)):
        angle[o:o + c] = f["angle"]
        torsion[o:o + c] = f["torsion"]
        idx_kj[o:o + c] = inv[f["idx_kj"] + e_off[m]]
        idx_ji[o:o + c] = inv[f["idx_ji"] + e_off[m]]
        tri_mask[o:o + c] = True
        o += c
    by_ji = np.argsort(idx_ji, kind="stable")
    idx_kj, idx_ji = idx_kj[by_ji], idx_ji[by_ji]
    arrays.update(angle=angle[by_ji], torsion=torsion[by_ji],
                  idx_kj=idx_kj.astype(np.int32),
                  idx_ji=idx_ji.astype(np.int32), tri_mask=tri_mask[by_ji],
                  tri_ji_ptr=row_pointers(idx_ji, E),
                  tri_kj_perm=np.argsort(idx_kj, kind="stable").astype(
                      np.int32),
                  tri_kj_ptr=row_pointers(np.sort(idx_kj), E))
    return {"graph": _batch_view(arrays, bucket)}


@register_collate("graphcl_collate")
def graphcl_collate(items: Sequence[Dict], bucket: BucketSpec,
                    rng: Optional[np.random.Generator] = None,
                    drop_ratio: float = 0.1):
    """Two node-dropped augmented views of the 2D graph (NodeDrop2dCollate,
    custom_collate.py:188-282)."""
    rng = rng or np.random.default_rng(0)
    v1 = [node_drop(it["graph2d"], rng, drop_ratio) for it in items]
    v2 = [node_drop(it["graph2d"], rng, drop_ratio) for it in items]
    return {"view1": _batch_view(batch_graphs(v1, bucket), bucket),
            "view2": _batch_view(batch_graphs(v2, bucket), bucket)}


@register_collate("san_collate")
def san_collate(items: Sequence[Dict], bucket: BucketSpec, max_nodes: int = 40,
                num_lap_pe: int = 10, rng: Optional[np.random.Generator] = None,
                sign_flip: bool = False):
    """The dense batch of the bond graphs (reference san_graph and its
    padded collates): padded atom and bond codes, the real-bond mask, the
    Laplacian PE (`lap_pe_node_array` where an item has none; sign-flipped
    with `sign_flip` and an `rng`), the targets NaN-padded, in
    `bucket.n_graphs` slots of `max_nodes` atoms."""
    graphs = []
    for it in items:
        g = dict(it["graph2d"])
        if g.get("lap_pe") is None or g["lap_pe"].ndim != 3:
            g["lap_pe"] = lap_pe_node_array(g["senders"], g["receivers"],
                                            g["node_feat"].shape[0],
                                            num_lap_pe)
        if sign_flip and rng is not None:
            g["lap_pe"] = random_sign_flip(g["lap_pe"], rng)
        if "targets" in it:
            g["targets"] = it["targets"]
        graphs.append(g)
    extras = ["targets"] if "targets" in items[0] else []
    return {"graph": dense_batch(graphs, bucket.n_graphs, max_nodes,
                                 extras_keys=extras, with_edges=True,
                                 num_lap_pe=num_lap_pe)}


@register_collate("padded_collate_positional_encoding")
def padded_collate_positional_encoding(items, bucket, max_nodes: int = 40,
                                       num_lap_pe: int = 10, **kw):
    """TransformerPlain's batch: `san_collate`'s (reference
    custom_collate.py:349-358)."""
    return san_collate(items, bucket, max_nodes=max_nodes,
                       num_lap_pe=num_lap_pe, **kw)


@register_collate("egnn_padded_collate")
def egnn_padded_collate(items: Sequence[Dict], bucket: BucketSpec,
                        max_nodes: int = 40):
    """The dense EGNN's batch (reference custom_collate.py:296-346): the
    bond graphs' atom codes padded to `max_nodes` slots in
    `bucket.n_graphs` rows, with the node mask, the coordinates (an item's
    ``graph3d`` ones where its 2D graph has none) and the NaN-padded
    targets; no bond codes."""
    graphs = []
    for it in items:
        g = dict(it["graph2d"])
        if "coords" not in g and "graph3d" in it:
            g["coords"] = it["graph3d"]["coords"]
        if "targets" in it:
            g["targets"] = it["targets"]
        graphs.append(g)
    extras = ["targets"] if "targets" in items[0] else []
    return {"graph": dense_batch(graphs, bucket.n_graphs, max_nodes,
                                 extras_keys=extras, with_edges=False)}


@register_collate("molhiv_padded_collate")
def molhiv_padded_collate(items, bucket, max_nodes: int = 40, **kw):
    """The padded dense batch for molhiv (reference custom_collate.py:
    385-391): `egnn_padded_collate`'s."""
    return egnn_padded_collate(items, bucket, max_nodes=max_nodes)


def node_drop(graph: Dict, rng: np.random.Generator, ratio: float) -> Dict:
    """Drop a fraction of nodes (keeping >=1) and incident edges."""
    n = graph["node_feat"].shape[0]
    keep_n = max(1, int(round(n * (1 - ratio))))
    keep = np.sort(rng.permutation(n)[:keep_n])
    remap = -np.ones(n, dtype=np.int64)
    remap[keep] = np.arange(keep_n)
    s, r = graph["senders"], graph["receivers"]
    ekeep = (remap[s] >= 0) & (remap[r] >= 0)
    out = dict(graph)
    out["node_feat"] = graph["node_feat"][keep]
    out["senders"] = remap[s[ekeep]].astype(np.int32)
    out["receivers"] = remap[r[ekeep]].astype(np.int32)
    if graph.get("edge_feat") is not None:
        out["edge_feat"] = graph["edge_feat"][ekeep]
    if graph.get("coords") is not None:
        out["coords"] = graph["coords"][keep]
    return out


@register_collate("ot_collate")
def _ot_view(items: Sequence[Dict], bucket: BucketSpec,
             n_true_confs: int = 3):
    """`ot_collate` as the loader's view ``{"graph": arrays}`` (the JAX
    collate's batch), with the bucket's bounds for `to_device`."""
    return {"graph": _batch_view(ot_collate(items, bucket, n_true_confs),
                               bucket)}


def to_device(view: Dict[str, np.ndarray], device):
    """One collated view -> its batch on `device`: a `GraphBatch` for a graph
    view (targets included), a `DenseBatch` for a dense one."""
    if "senders" not in view:
        return to_dense_batch(view, device)
    G, N = view["graph_mask"].shape[0], view["node_feat"].shape[0]
    bucket = BucketSpec(G, N, view["senders"].shape[0],
                        max_deg=int(view["max_deg"]),
                        csr="csr_row_ptr" in view, nmax=int(view["nmax"]))
    return to_graph_batch(view, bucket, device)


def partition_collate(collate: Callable, cut: Callable) -> Callable:
    """`collate` with each of its graph views (those with edges) passed
    through `cut` (a rank's edge or node shard of the batch: the
    partitioned modes, `parallel/edge_partition.py`,
    `parallel/node_partition.py`); dense views pass as they are."""
    def cut_collate(items, *args, **kw):
        return {key: cut(view) if "senders" in view else view
                for key, view in collate(items, *args, **kw).items()}
    return cut_collate


# ----------------------------------------------------------------- loader

def shard_bucket(bucket: Optional[BucketSpec], n_shards: int
                 ) -> Optional[BucketSpec]:
    """One data-parallel shard's bucket: graphs, nodes and edges cut
    `n_shards` ways, `max_deg`, `csr` and `nmax` kept (the JAX loader's
    `_shard_bucket`: dropping them would take the shards off the CSR
    path)."""
    if bucket is None:
        return None
    return BucketSpec(bucket.n_graphs // n_shards, bucket.n_nodes // n_shards,
                      bucket.n_edges // n_shards, max_deg=bucket.max_deg,
                      csr=bucket.csr, nmax=bucket.nmax)


class GraphDataLoader:
    """Shuffling, prefetching loader over a dataset of item dicts
    (`__len__`, `__getitem__(i)`), one static bucket per loader or, with
    `ladder` and no `bucket`, each batch's smallest bucket of the ladder
    that holds its 2D graphs (`pick_bucket`, as the JAX loader picks); a
    `batch_sampler` (an iterable of index lists with `__len__`) replaces
    the shuffle.

    Data parallel (`n_shards` k > 1, the JAX loader's shards): the batch
    size must divide by k and partial batches are dropped; every shard
    shuffles (or samples) the same way, and shard `shard` collates only
    its slice ``items[shard * per:(shard + 1) * per]`` of each batch into
    the bucket cut k ways (`shard_bucket`; `csr` and `max_deg` kept), as
    is a ``bucket3d`` collate argument."""

    def __init__(self, dataset, batch_size: int, collate,
                 bucket: Optional[BucketSpec] = None, shuffle: bool = True,
                 drop_last: bool = False, seed: int = 0,
                 indices: Optional[Sequence[int]] = None, prefetch: int = 2,
                 collate_kwargs: Optional[Dict] = None, batch_sampler=None,
                 n_shards: int = 1, shard: int = 0,
                 ladder: Optional[Sequence[BucketSpec]] = None):
        self.dataset = dataset
        self.batch_size = batch_size
        self.collate = collate if callable(collate) else get_collate(collate)
        self.bucket = bucket
        self.ladder = list(ladder) if ladder else None
        self.shuffle = shuffle
        self.n_shards, self.shard = n_shards, shard
        if n_shards > 1:
            if batch_size % n_shards:
                raise ValueError(f"batch_size {batch_size} not divisible by "
                                 f"n_shards {n_shards}")
            if not 0 <= shard < n_shards:
                raise ValueError(f"shard {shard} outside 0..{n_shards - 1}")
            drop_last = True  # every shard must be full
        self.drop_last = drop_last
        self.rng = np.random.default_rng(seed)
        self.indices = np.asarray(indices if indices is not None
                                  else np.arange(len(dataset)))
        self.prefetch = prefetch
        self.collate_kwargs = collate_kwargs or {}
        self.batch_sampler = batch_sampler

    def __len__(self):
        if self.batch_sampler is not None:
            return len(self.batch_sampler)
        n = len(self.indices)
        return n // self.batch_size if self.drop_last else \
            (n + self.batch_size - 1) // self.batch_size

    def skip_epochs(self, n: int) -> None:
        """Advance the shuffle by `n` epochs without collating (a resumed
        run continues the order of the run it resumes)."""
        if self.batch_sampler is not None:
            for _ in range(n):
                for _ in self.batch_sampler:
                    pass
        elif self.shuffle:
            for _ in range(n):
                self.rng.shuffle(self.indices.copy())

    def _index_batches(self):
        if self.batch_sampler is not None:
            yield from self.batch_sampler
            return
        idx = self.indices.copy()
        if self.shuffle:
            self.rng.shuffle(idx)
        for i in range(0, len(idx), self.batch_size):
            yield idx[i:i + self.batch_size]

    def _bucket(self, chunk) -> Optional[BucketSpec]:
        """The whole batch's bucket: the loader's, or its ladder's pick."""
        if self.bucket is not None or not self.ladder:
            return self.bucket
        graphs = [self.dataset[int(j)]["graph2d"] for j in chunk]
        return pick_bucket(self.ladder,
                           sum(g["node_feat"].shape[0] for g in graphs),
                           sum(g["senders"].shape[0] for g in graphs))

    def _batches(self) -> Iterator:
        kw = self.collate_kwargs
        if self.n_shards > 1:
            kw = dict(kw)
            if isinstance(kw.get("bucket3d"), BucketSpec):
                kw["bucket3d"] = shard_bucket(kw["bucket3d"], self.n_shards)
        for chunk in self._index_batches():
            if len(chunk) < self.batch_size and self.drop_last:
                continue
            bucket = self._bucket(chunk)
            if self.n_shards > 1:
                bucket = shard_bucket(bucket, self.n_shards)
                per = len(chunk) // self.n_shards
                chunk = chunk[self.shard * per:(self.shard + 1) * per]
            items = [self.dataset[int(j)] for j in chunk]
            yield self.collate(items, bucket, **kw)

    def __iter__(self):
        if self.prefetch <= 0:
            yield from self._batches()
            return
        q: queue_mod.Queue = queue_mod.Queue(maxsize=self.prefetch)
        sentinel = object()
        err: list = []
        stop = threading.Event()

        def _put(item) -> bool:
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue_mod.Full:
                    continue
            return False

        def worker():
            try:
                for b in self._batches():
                    if not _put(b):
                        return       # consumer gone (e.g. next(iter(...)))
            except BaseException as e:   # re-raised on the consuming thread
                err.append(e)
            finally:
                _put(sentinel)

        t = threading.Thread(target=worker, daemon=True)
        t.start()
        try:
            while True:
                b = q.get()
                if b is sentinel:
                    if err:
                        raise err[0]
                    break
                yield b
        finally:
            # retire the worker if the consumer left early, so it does not
            # pin `prefetch` collated batches
            stop.set()
            try:
                while True:
                    q.get_nowait()
            except queue_mod.Empty:
                pass
