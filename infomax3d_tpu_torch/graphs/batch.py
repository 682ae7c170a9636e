"""Padded graph batches, receiver-sorted CSR or in the collate's edge order
(port of `infomax3d_tpu/graphs/batch.py`).

`batch_graphs` is the host batcher: it concatenates per-molecule dicts
into one flat graph padded to a `BucketSpec` and returns numpy arrays with
the JAX package's names and values.  Its index arrays come from the native
C core (`native/batcher.c`) unless ``INFOMAX3D_NO_NATIVE=1``;
`batch_graphs_numpy` is the numpy path, the oracle.  `to_graph_batch` wraps them as a
`GraphBatch` of torch tensors on a device (through `to_tensors`, which
counts the bytes and arrays handed over).

A 3D complete graph (`data/synthetic.py::complete_graph_from_coords`,
every ordered pair of distinct atoms with its distance ``edge_dist``) is
batched the same way: its bucket's `max_deg` is the largest n - 1 and its
`nmax` the largest n (`bucket_for`), and it carries `edge_dist` in place
of bond features.

Every batch carries ``snorm``, 1 / sqrt(n) for each node of an n-atom
graph (0 on padding: PNAOriginal's graph norm), and ``coords`` where the
graphs have coordinates.

Padding conventions (as in the reference): padding edges have sender and
receiver N (and distance 0), padding nodes have graph id G.  With
``csr=True`` the edges are sorted by receiver (stable, padding last) and
`csr_row_ptr` indexes each node's incoming edges — the layout the
aggregation kernels walk;
`csc_perm` / `csc_row_ptr` give the same edges in sender order, which the
combine backward walks.  With ``csr=False`` the edges keep the collate's
order and the batch carries no CSR arrays: the aggregations then take the
segment path (`ops/aggregate.py`).  The TPU DMA-window markers and the
mailbox arrays are not emitted (the segment path gives the mailbox's
values).  `make_bucket_ladder` / `pick_bucket` size a per-batch bucket
from a small ladder of non-CSR shapes, as the JAX package does.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from infomax3d_tpu_torch.utils.spans import count, recording


@dataclasses.dataclass(frozen=True)
class BucketSpec:
    """Static shape of a batch: graphs, nodes, edges; `max_deg` bounds the
    in-degree (the aggregation kernels' slot count), `csr` sorts edges by
    receiver, `nmax > 0` emits the dense readout regroup."""
    n_graphs: int
    n_nodes: int
    n_edges: int
    max_deg: int = 0
    csr: bool = False
    nmax: int = 0


def row_pointers(ids: np.ndarray, n: int) -> np.ndarray:
    """[n + 1] int32: the ranges of ids 0 .. n - 1 in ascending `ids`
    (ids >= n, the padding, lie past the last range)."""
    ptr = np.zeros(n + 1, np.int32)
    np.cumsum(np.bincount(np.minimum(ids, n), minlength=n + 1)[:n],
              out=ptr[1:])
    return ptr


def _check_degree(indices: np.ndarray, num_nodes: int, max_deg: int):
    """The kernels' contract: no node has more than `max_deg` edges."""
    valid = indices[(indices >= 0) & (indices < num_nodes)]
    deg_max = int(np.bincount(valid, minlength=1).max()) if len(valid) else 1
    if deg_max > max_deg:
        raise ValueError(f"degree {deg_max} exceeds mailbox width {max_deg}")


def batch_graphs(graphs: Sequence[Dict[str, np.ndarray]],
                 bucket: BucketSpec) -> Dict[str, np.ndarray]:
    """`batch_graphs_numpy`'s batch, built by the native C core
    (`native/batcher.c`, compiled at first use), as the JAX batcher does;
    ``INFOMAX3D_NO_NATIVE=1`` takes the numpy path.  A failed build raises
    (no fallback); both paths give the same arrays."""
    from infomax3d_tpu_torch import native
    if native.disabled():
        return batch_graphs_numpy(graphs, bucket)
    from infomax3d_tpu_torch.native.batcher import pack_batch
    return pack_batch(graphs, bucket)


def batch_graphs_numpy(graphs: Sequence[Dict[str, np.ndarray]],
                       bucket: BucketSpec) -> Dict[str, np.ndarray]:
    """Concatenate per-molecule numpy graphs (``node_feat``, ``senders``,
    ``receivers``, optional ``edge_feat``, ``edge_dist`` and ``targets``)
    into one padded flat batch.  ``targets`` (per graph, [T]) become
    [G, T] float32 with zero padding rows, as the JAX batcher stacks its
    per-graph extras; ``coords`` ([n, 3]) become [N, 3] with zero padding
    rows; ``snorm`` ([N, 1] float32) is always emitted."""
    G, N, E = bucket.n_graphs, bucket.n_nodes, bucket.n_edges
    g_real = len(graphs)
    if g_real == 0:
        raise ValueError("batch_graphs needs at least one graph")
    if g_real > G:
        raise ValueError(f"{g_real} graphs > bucket {G}")

    n_per = np.array([g["node_feat"].shape[0] for g in graphs], dtype=np.int32)
    e_per = np.array([g["senders"].shape[0] for g in graphs], dtype=np.int32)
    n_tot, e_tot = int(n_per.sum()), int(e_per.sum())
    if n_tot > N or e_tot > E:
        raise ValueError(f"batch needs ({n_tot} nodes, {e_tot} edges) > "
                         f"bucket ({N}, {E})")
    node_off = np.concatenate([[0], np.cumsum(n_per)[:-1]]).astype(np.int32)

    nf = graphs[0]["node_feat"]
    node_feat = np.zeros((N,) + nf.shape[1:], dtype=nf.dtype)
    node_feat[:n_tot] = np.concatenate([g["node_feat"] for g in graphs])

    senders = np.full(E, N, dtype=np.int32)
    receivers = np.full(E, N, dtype=np.int32)
    if e_tot:
        senders[:e_tot] = np.concatenate(
            [g["senders"].astype(np.int32) + node_off[i]
             for i, g in enumerate(graphs)])
        receivers[:e_tot] = np.concatenate(
            [g["receivers"].astype(np.int32) + node_off[i]
             for i, g in enumerate(graphs)])

    node_graph = np.full(N, G, dtype=np.int32)
    node_graph[:n_tot] = np.repeat(np.arange(g_real, dtype=np.int32), n_per)
    # each node's position inside its graph; padding nodes 0, as in JAX
    node_pos = np.zeros(N, dtype=np.int32)
    node_pos[:n_tot] = np.arange(n_tot, dtype=np.int32) - np.repeat(
        node_off, n_per)
    node_mask = np.zeros(N, dtype=bool)
    node_mask[:n_tot] = True
    edge_mask = np.zeros(E, dtype=bool)
    edge_mask[:e_tot] = True
    # 1 / sqrt(n) per real node of an n-atom graph, 0 on padding (the
    # reference's s_norm collates, the JAX package's `snorm`)
    snorm = np.zeros((N, 1), dtype=np.float32)
    snorm[:n_tot, 0] = np.repeat(1.0 / np.sqrt(n_per.astype(np.float32)),
                                 n_per)
    graph_mask = np.zeros(G, dtype=bool)
    graph_mask[:g_real] = True
    n_nodes = np.zeros(G, dtype=np.int32)
    n_nodes[:g_real] = n_per

    out: Dict[str, np.ndarray] = dict(
        node_feat=node_feat, senders=senders, receivers=receivers,
        node_graph=node_graph, node_pos=node_pos, node_mask=node_mask,
        edge_mask=edge_mask, graph_mask=graph_mask, n_nodes=n_nodes,
        snorm=snorm)
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
        out[key] = buf
    if "targets" in graphs[0]:
        tg = np.stack([np.asarray(g["targets"], np.float32) for g in graphs])
        out["targets"] = np.zeros((G,) + tg.shape[1:], np.float32)
        out["targets"][:g_real] = tg

    if bucket.csr:
        if bucket.max_deg <= 0:
            raise ValueError("csr buckets need max_deg > 0")
        # receiver-sorted edge order (stable; padding receivers == N last)
        order = np.argsort(receivers, kind="stable")
        for key in ("senders", "receivers", "edge_mask", "edge_feat",
                    "edge_dist"):
            if key in out:
                out[key] = out[key][order]
        senders, receivers = out["senders"], out["receivers"]
        row_ptr = row_pointers(receivers, N)
        out["csr_row_ptr"] = row_ptr
        # sender-sorted edge order (stable; padding senders == N last) and
        # its row pointers: the sender half of the combine backward
        out["csc_perm"] = np.argsort(senders, kind="stable").astype(np.int32)
        out["csc_row_ptr"] = row_pointers(senders, N)
        # each edge's slot within its receiver's CSR range; -1 on padding
        pos = (np.arange(receivers.shape[0], dtype=np.int32)
               - row_ptr[np.minimum(receivers, N)])
        out["csr_pos"] = np.where(receivers < N, pos, -1).astype(np.int16)

    if bucket.max_deg > 0:
        _check_degree(receivers, N, bucket.max_deg)
        _check_degree(senders, N, bucket.max_deg)

    out["in_degree"] = np.bincount(receivers.clip(0, N),
                                   minlength=N + 1)[:N].astype(np.float32)

    if bucket.nmax > 0:
        # dense readout regroup: node row -> (graph, slot)
        nm = int(bucket.nmax)
        if int(n_per.max()) > nm:
            raise ValueError(
                f"bucket.nmax={nm} < largest graph ({int(n_per.max())} nodes)")
        idx2 = np.full((G, nm), N, np.int32)          # pad -> node row N
        inv = np.full(N, G * nm, np.int32)            # pad -> G*nmax
        slot = np.arange(n_tot, dtype=np.int32) - np.repeat(node_off, n_per)
        gid = node_graph[:n_tot]
        idx2[gid, slot] = np.arange(n_tot, dtype=np.int32)
        inv[:n_tot] = gid * nm + slot
        out["rd_node_idx"] = idx2
        out["rd_inv_flat"] = inv
    return out


def bucket_for(graphs: Sequence[Dict[str, np.ndarray]],
               n_graphs: int) -> BucketSpec:
    """The CSR bucket a batch of molecules needs: nodes rounded up to 256,
    edges to 512, `max_deg` and `nmax` taken from the data (the JAX
    package's bench shapes, `bench.py`)."""
    n_tot = sum(g["node_feat"].shape[0] for g in graphs)
    e_tot = sum(g["senders"].shape[0] for g in graphs)
    max_deg = max(int(np.bincount(g["receivers"], minlength=1).max())
                  for g in graphs)
    nmax = max(g["node_feat"].shape[0] for g in graphs)
    return BucketSpec(n_graphs, -(-n_tot // 256) * 256,
                      max(512, -(-e_tot // 512) * 512),
                      max_deg=max(max_deg, 1), csr=True, nmax=nmax)


_TENSOR_FIELDS = ("node_feat", "senders", "receivers", "node_graph",
                  "node_mask", "edge_mask", "graph_mask", "n_nodes",
                  "in_degree")
CSR_FIELDS = ("csr_row_ptr", "csc_perm", "csc_row_ptr")
READOUT_FIELDS = ("rd_node_idx", "rd_inv_flat")
# per-batch fields that only some batches carry: the CSR arrays, the
# readout regroup, bond codes (2D graphs), distances (3D complete graphs),
# graph labels, coordinates; each node's position in its graph and its
# graph's 1 / sqrt(n) (`batch_graphs` always emits both); the SMP
# collate's triplets (`data/loader.py::smp_collate`)
_OPTIONAL_FIELDS = CSR_FIELDS + READOUT_FIELDS + (
    "edge_feat", "edge_dist", "targets", "node_pos", "snorm", "coords")
# a node shard's halo send lists travel as halo_send_0, halo_send_1, ...
HALO_KEY = "halo_send_"
TRIPLET_FIELDS = ("angle", "torsion", "idx_kj", "idx_ji", "tri_mask",
                  "tri_ji_ptr", "tri_kj_ptr", "tri_kj_perm")


@dataclasses.dataclass(frozen=True)
class GraphBatch:
    """A padded CSR batch as torch tensors.  `max_deg` and `nmax` are the
    bucket's static bounds (Python ints).  A 2D bond graph carries
    `edge_feat`, a 3D complete graph `edge_dist`."""
    node_feat: torch.Tensor       # [N, 9] int32 atom codes
    senders: torch.Tensor         # [E] int32 (pad -> N)
    receivers: torch.Tensor       # [E] int32, ascending (pad -> N)
    node_graph: torch.Tensor      # [N] int32 (pad -> G)
    node_mask: torch.Tensor       # [N] bool
    edge_mask: torch.Tensor       # [E] bool
    graph_mask: torch.Tensor      # [G] bool
    n_nodes: torch.Tensor         # [G] int32
    in_degree: torch.Tensor       # [N] float32
    max_deg: int
    nmax: int
    # the CSR arrays (a ``csr=True`` bucket; None on the segment path)
    csr_row_ptr: Optional[torch.Tensor] = None  # [N + 1] int32
    csc_perm: Optional[torch.Tensor] = None     # [E] int32 sender order
    csc_row_ptr: Optional[torch.Tensor] = None  # [N + 1] int32 of csc_perm
    # the dense readout regroup (``nmax > 0``; None: segment readout)
    rd_node_idx: Optional[torch.Tensor] = None  # [G, nmax] int32 (pad -> N)
    rd_inv_flat: Optional[torch.Tensor] = None  # [N] int32 (pad -> G * nmax)
    edge_feat: Optional[torch.Tensor] = None  # [E, 3] int32 bond codes
    edge_dist: Optional[torch.Tensor] = None  # [E] float32 (pad -> 0)
    targets: Optional[torch.Tensor] = None    # [G, T] float32 graph labels
    node_pos: Optional[torch.Tensor] = None   # [N] int32 (pad -> 0)
    snorm: Optional[torch.Tensor] = None      # [N, 1] float32 (pad -> 0)
    coords: Optional[torch.Tensor] = None     # [N, 3] float32 (pad -> 0)
    # SMP's triplets k -> j -> i over the radius graph, sorted by the edge
    # j -> i (`idx_ji`; padding triplets last, pointing at edge id E):
    angle: Optional[torch.Tensor] = None      # [T] float32
    torsion: Optional[torch.Tensor] = None    # [T] float32
    idx_kj: Optional[torch.Tensor] = None     # [T] int32 edge k -> j
    idx_ji: Optional[torch.Tensor] = None     # [T] int32 edge j -> i
    tri_mask: Optional[torch.Tensor] = None   # [T] bool
    tri_ji_ptr: Optional[torch.Tensor] = None   # [E + 1] int32: by idx_ji
    tri_kj_ptr: Optional[torch.Tensor] = None   # [E + 1] int32: by idx_kj
    tri_kj_perm: Optional[torch.Tensor] = None  # [T] int32 idx_kj order
    # a node shard's halo send lists, one [H_r] int32 per exchange round
    # (`parallel/node_partition.py::shard_graph_batch`); None elsewhere
    halo_send: Optional[Tuple[torch.Tensor, ...]] = None

    @property
    def num_nodes(self) -> int:
        return self.node_feat.shape[0]

    @property
    def csr(self) -> bool:
        """Whether the batch carries the CSR arrays (the kernels' path)."""
        return self.csr_row_ptr is not None

    def to(self, device) -> "GraphBatch":
        moved = {k: getattr(self, k).to(device) for k in
                 _TENSOR_FIELDS + _OPTIONAL_FIELDS + TRIPLET_FIELDS
                 if getattr(self, k) is not None}
        if self.halo_send is not None:
            moved["halo_send"] = tuple(t.to(device) for t in self.halo_send)
        return dataclasses.replace(self, **moved)


def to_graph_batch(arrays: Dict[str, np.ndarray], bucket: BucketSpec,
                   device) -> GraphBatch:
    """Host arrays of a bucket -> `GraphBatch` on `device`: the CSR arrays
    where the bucket is ``csr``, the readout regroup where ``nmax > 0``,
    the optional fields and the triplets where the arrays carry them, a
    node shard's halo send lists where it has them."""
    if bucket.csr and "csr_row_ptr" not in arrays:
        raise ValueError("a csr bucket's arrays carry csr_row_ptr")
    halo = []
    while f"{HALO_KEY}{len(halo)}" in arrays:
        halo.append(f"{HALO_KEY}{len(halo)}")
    fields = _TENSOR_FIELDS + tuple(k for k in _OPTIONAL_FIELDS +
                                    TRIPLET_FIELDS if k in arrays)
    t = to_tensors(arrays, fields + tuple(halo), device)
    return GraphBatch(**{k: t[k] for k in fields},
                      max_deg=bucket.max_deg, nmax=bucket.nmax,
                      halo_send=tuple(t[k] for k in halo) if halo else None)


def to_tensors(arrays: Dict[str, np.ndarray], keys: Sequence[str],
               device) -> Dict[str, torch.Tensor]:
    """The host arrays of `keys` as tensors on `device`, by key: where a
    batch's arrays become the step's tensors.  Their bytes and number go
    to the counters ``h2d_bytes`` and ``h2d_copies`` (`utils/spans.py`;
    counted whatever the device), and where they hold SMP's triplets the
    host ``tri_mask``'s real triplets and rows to ``smp_triplets`` and
    ``smp_triplet_rows``."""
    out, nbytes = {}, 0
    for k in keys:
        a = np.ascontiguousarray(arrays[k])
        nbytes += a.nbytes
        out[k] = torch.from_numpy(a).to(device)
    count("h2d_bytes", nbytes)
    count("h2d_copies", len(out))
    if "tri_mask" in out and recording():
        count("smp_triplets", int(np.count_nonzero(arrays["tri_mask"])))
        count("smp_triplet_rows", len(arrays["tri_mask"]))
    return out


def make_bucket_ladder(batch_size: int, node_counts: Sequence[int],
                       edge_counts: Sequence[int], n_buckets: int = 3,
                       node_align: int = 128, edge_align: int = 512,
                       headroom: float = 1.08, nmax: int = 0
                       ) -> List[BucketSpec]:
    """A small ladder of non-CSR buckets from the dataset's per-molecule
    node and edge counts (the JAX package's `make_bucket_ladder`): for
    quantiles 0.6 .. 1.0 of the counts, the batch's expected totals with
    `headroom`, rounded up to the alignments; duplicates dropped."""
    node_counts = np.asarray(node_counts)
    edge_counts = np.asarray(edge_counts)
    ladder, seen = [], set()
    for q in np.linspace(0.6, 1.0, n_buckets):
        n_cap = float(np.quantile(node_counts, q)) * batch_size * headroom
        e_cap = float(np.quantile(edge_counts, q)) * batch_size * headroom
        b = BucketSpec(batch_size,
                       int(math.ceil(n_cap / node_align) * node_align),
                       int(math.ceil(e_cap / edge_align) * edge_align),
                       nmax=nmax)
        if (b.n_graphs, b.n_nodes, b.n_edges) not in seen:
            seen.add((b.n_graphs, b.n_nodes, b.n_edges))
            ladder.append(b)
    return ladder


def pick_bucket(ladder: Sequence[BucketSpec], n_tot: int, e_tot: int
                ) -> BucketSpec:
    """The smallest bucket of `ladder` that holds `n_tot` nodes and
    `e_tot` edges, else the largest (whose batch then raises)."""
    for b in ladder:
        if n_tot <= b.n_nodes and e_tot <= b.n_edges:
            return b
    return ladder[-1]
