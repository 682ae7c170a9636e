"""`batch_graphs` on the C core (`native/batcher.c`): the core writes every
index-shaped array of the batch (relabelled endpoints, the receiver and
sender sorts, the CSR / CSC arrays and slots, masks, degrees, snorm, the
readout regroup); the feature payloads (node features, coordinates, edge
features and distances, targets) are concatenated and reordered with
numpy.  The capacity checks are the numpy batcher's, with its messages,
in its order.  Every array equals `graphs.batch.batch_graphs_numpy`'s
(tests/test_torch_port_native.py)."""
from __future__ import annotations

import ctypes
from typing import Dict, Sequence

import numpy as np

from infomax3d_tpu_torch.native import load


def _ptr(a: np.ndarray, ct):
    return a.ctypes.data_as(ctypes.POINTER(ct))


def pack_batch(graphs: Sequence[Dict[str, np.ndarray]], bucket
               ) -> Dict[str, np.ndarray]:
    """The padded flat batch of `graphs` in `bucket` (a `BucketSpec`), as
    `batch_graphs` returns it."""
    G, N, E = bucket.n_graphs, bucket.n_nodes, bucket.n_edges
    g_real = len(graphs)
    if g_real == 0:
        raise ValueError("batch_graphs needs at least one graph")
    if g_real > G:
        raise ValueError(f"{g_real} graphs > bucket {G}")
    n_per = np.array([g["node_feat"].shape[0] for g in graphs], np.int32)
    e_per = np.array([g["senders"].shape[0] for g in graphs], np.int32)
    n_tot, e_tot = int(n_per.sum()), int(e_per.sum())
    if n_tot > N or e_tot > E:
        raise ValueError(f"batch needs ({n_tot} nodes, {e_tot} edges) > "
                         f"bucket ({N}, {E})")
    csr = bool(bucket.csr)
    if csr and bucket.max_deg <= 0:
        raise ValueError("csr buckets need max_deg > 0")
    nmax = int(bucket.nmax)
    too_wide = nmax > 0 and int(n_per.max()) > nmax

    def cat(key):
        parts = [np.asarray(g[key]).astype(np.int32, copy=False)
                 for g in graphs]
        return np.ascontiguousarray(np.concatenate(parts) if e_tot
                                    else np.zeros(0, np.int32))
    src, dst = cat("senders"), cat("receivers")
    if e_tot:
        # the C core indexes its counting sorts by these: keep them inside
        # their graphs
        lim = np.repeat(n_per, e_per)
        if min(src.min(), dst.min()) < 0 or (src >= lim).any() \
                or (dst >= lim).any():
            raise ValueError("an edge endpoint lies outside its graph's "
                             "nodes")
    i32, u8 = np.int32, np.uint8
    senders, receivers, edge_perm = (np.empty(E, i32) for _ in range(3))
    node_graph, node_pos = np.empty(N, i32), np.empty(N, i32)
    node_mask, edge_mask = np.empty(N, u8), np.empty(E, u8)
    n_nodes, graph_mask = np.empty(G, i32), np.empty(G, u8)
    snorm, in_degree = np.empty(N, np.float32), np.empty(N, np.float32)
    csr_row_ptr, csc_row_ptr = np.empty(N + 1, i32), np.empty(N + 1, i32)
    csc_perm, csr_pos = np.empty(E, i32), np.empty(E, np.int16)
    rd_nmax = 0 if too_wide else nmax
    rd_node_idx = np.empty(max(G * rd_nmax, 1), i32)
    rd_inv = np.empty(N, i32)
    deg_max = np.zeros(2, i32)
    scratch = np.empty(E + N + 2, i32)
    ci, cu8 = ctypes.c_int32, ctypes.c_uint8
    load().pack_topology(
        _ptr(src, ci), _ptr(dst, ci), _ptr(n_per, ci), _ptr(e_per, ci),
        g_real, G, N, E, n_tot, e_tot, rd_nmax, int(csr),
        _ptr(senders, ci), _ptr(receivers, ci), _ptr(edge_perm, ci),
        _ptr(node_graph, ci), _ptr(node_pos, ci),
        _ptr(node_mask, cu8), _ptr(edge_mask, cu8),
        _ptr(n_nodes, ci), _ptr(graph_mask, cu8),
        _ptr(snorm, ctypes.c_float), _ptr(in_degree, ctypes.c_float),
        _ptr(csr_row_ptr, ci), _ptr(csc_perm, ci), _ptr(csc_row_ptr, ci),
        _ptr(csr_pos, ctypes.c_int16), _ptr(rd_node_idx, ci),
        _ptr(rd_inv, ci), _ptr(deg_max, ci), _ptr(scratch, ci))
    if bucket.max_deg > 0:
        for d in deg_max:
            if max(int(d), 1) > bucket.max_deg:
                raise ValueError(f"degree {max(int(d), 1)} exceeds mailbox "
                                 f"width {bucket.max_deg}")
    if too_wide:
        raise ValueError(f"bucket.nmax={nmax} < largest graph "
                         f"({int(n_per.max())} nodes)")

    nf = graphs[0]["node_feat"]
    node_feat = np.zeros((N,) + nf.shape[1:], dtype=nf.dtype)
    node_feat[:n_tot] = np.concatenate([g["node_feat"] for g in graphs])
    out: Dict[str, np.ndarray] = dict(
        node_feat=node_feat, senders=senders, receivers=receivers,
        node_graph=node_graph, node_pos=node_pos,
        node_mask=node_mask.view(bool), edge_mask=edge_mask.view(bool),
        graph_mask=graph_mask.view(bool), n_nodes=n_nodes,
        snorm=snorm[:, None])
    if graphs[0].get("coords") is not None:
        c0 = graphs[0]["coords"]
        coords = np.zeros((N,) + c0.shape[1:], dtype=c0.dtype)
        coords[:n_tot] = np.concatenate([g["coords"] for g in graphs])
        out["coords"] = coords
    for key in ("edge_feat", "edge_dist"):
        if graphs[0].get(key) is None:
            continue
        ef = graphs[0][key]
        buf = np.zeros((E,) + ef.shape[1:], dtype=ef.dtype)
        if e_tot:
            buf[:e_tot] = np.concatenate([g[key] for g in graphs])
        out[key] = buf[edge_perm] if csr else buf
    if "targets" in graphs[0]:
        tg = np.stack([np.asarray(g["targets"], np.float32) for g in graphs])
        out["targets"] = np.zeros((G,) + tg.shape[1:], np.float32)
        out["targets"][:g_real] = tg
    if csr:
        out.update(csr_row_ptr=csr_row_ptr, csc_perm=csc_perm,
                   csc_row_ptr=csc_row_ptr, csr_pos=csr_pos)
    out["in_degree"] = in_degree
    if nmax > 0:
        out["rd_node_idx"] = rd_node_idx.reshape(G, nmax)
        out["rd_inv_flat"] = rd_inv
    return out
