"""Backward of the fused bf16 PNA statistics (port of `_stats_bwd`'s
node-side combination and of `_stats_bwd_kernel` / `_stats_bwd_kernel_aff` /
`_csr_stats_bwd_raw`, infomax3d_tpu/ops/pallas/spmm.py), one launch per
layer.  Kernel: `csrc/pna_stats_bwd.cu`."""
from __future__ import annotations

import ctypes
import math

import torch

from infomax3d_tpu_torch.ops.kernels import _build
from infomax3d_tpu_torch.ops.kernels._build import (check_launch, launcher,
                                                    refuse_grad, require,
                                                    stream_of)
from infomax3d_tpu_torch.ops.kernels.csr_sum import slot_sums
from infomax3d_tpu_torch.ops.segment import EPS

_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = (_P,) * 17 + (_I,) * 6 + (_P,)
# the block size of the two statistics kernels, and the tiles per chunk of
# the column sums (see `column_sums`)
THREADS = 256
CHUNK_TILES = 32
COTANGENTS = ("d_sum", "d_mean", "d_std", "d_max", "d_min")
# the kernels' device counters, per (device, stream): zero between
# launches.  Launches on one stream run one after another; two streams (or
# two replayed graphs) may run at once and would race on shared counters.
_COUNTERS: dict = {}


def tile_nodes(D: int) -> int:
    """Nodes per tile of the statistics kernels: one thread per (node,
    8-element column vector) fills the block, 256 // ceil(D / 8), at least
    1 (10 at D = 200)."""
    return max(1, THREADS // -(-D // 8))


def column_sums(node_sums: torch.Tensor) -> torch.Tensor:
    """Columns of float32 `node_sums [N, C]` summed in the kernel's order:
    the nodes of each tile of `tile_nodes(C // 2)` nodes in node order, the
    tiles of each chunk of CHUNK_TILES tiles in tile order, then the chunks
    in chunk order, each level starting from 0."""
    N, C = node_sums.shape
    tn = tile_nodes(C // 2)
    level = node_sums
    for group in (tn, CHUNK_TILES):
        groups = -(-level.shape[0] // group)
        padded = torch.cat([level, level.new_zeros(groups * group
                                                   - level.shape[0], C)])
        padded = padded.view(groups, group, C)
        level = torch.zeros(groups, C, device=node_sums.device)
        for j in range(group):
            level = level + padded[:, j]
    total = torch.zeros(C, device=node_sums.device)
    for row in level:
        total = total + row
    return total


def _combination(row_ptr, std, cots):
    """The node-side combination (`_stats_bwd`), float32 rounded to bf16:
    ``A = d_sum + d_mean / max(deg, 1)`` and ``B = d_std / max(deg, 1) /
    max(std, √eps)``; None where no cotangent feeds them."""
    d_sum, d_mean, d_std = cots[:3]
    rp = row_ptr.long()
    inv = 1.0 / (rp[1:] - rp[:-1]).float().clamp(min=1.0)[:, None]
    A = None if d_mean is None else d_mean.float() * inv
    if d_sum is not None:
        A = d_sum.float() if A is None else d_sum.float() + A
    B = None if d_std is None else (
        d_std.float() * inv / std.float().clamp(min=math.sqrt(EPS)))
    return tuple(None if v is None else v.to(torch.bfloat16).float()
                 for v in (A, B))


def pna_stats_bwd_reference(x, row_ptr, max_deg, mean, std, enc, d_sum,
                            d_mean, d_std, d_max, d_min, affine=None):
    """Plain PyTorch version, rounding where the kernel rounds.  `x [E, D]`
    bf16 (the pre-affine messages when `affine` is given), `row_ptr [N + 1]`
    int32, the forward's `mean`, `std`, `enc` and the cotangents (each bf16
    [N, D] or None: its term drops) of the statistics.  `max_deg` sizes the
    kernel's shared memory and changes no value.  Returns (d_x bf16 [E, D],
    d_a, d_b): the column sums are float32 [D] with an affine (in the order
    of `column_sums`), else None."""
    cots = (d_sum, d_mean, d_std, d_max, d_min)
    E, D = x.shape
    rp = row_ptr.long()
    deg = rp[1:] - rp[:-1]
    e_real = int(rp[-1])
    node = torch.repeat_interleave(torch.arange(deg.shape[0],
                                                device=x.device), deg)
    slot = (torch.arange(e_real, device=x.device) - rp[node]).float()[:, None]
    A, B = _combination(row_ptr, std, cots)
    xf = x[:e_real].float()
    m = xf
    if affine is not None:
        m = (xf * affine[0].float() + affine[1].float()).to(
            torch.bfloat16).float()
    d = torch.zeros_like(xf) if A is None else A[node]
    if B is not None:
        d = d + B[node] * (m - mean.float()[node])
    enc_e = enc.float()[node]
    amin = torch.floor(enc_e * 0.0625)
    for ct, win in ((d_max, enc_e - 16.0 * amin), (d_min, amin)):
        if ct is not None:
            d = d + ct.float()[node] * (slot == win).float()
    d_x = torch.zeros(E, D, dtype=torch.bfloat16, device=x.device)
    if affine is None:
        d_x[:e_real] = d.to(torch.bfloat16)
        return d_x, None, None
    d_x[:e_real] = (d * affine[0].float()).to(torch.bfloat16)
    sums = column_sums(slot_sums(torch.cat([d * xf, d], 1), row_ptr))
    return d_x, sums[:D], sums[D:]


def _counters(device, stream: int, n: int) -> torch.Tensor:
    """At least `n` zeroed int32 counters of `stream` on `device`,
    allocated and zeroed on that stream; the kernel leaves them at 0, so
    they are allocated once per stream."""
    key = (device, stream)
    c = _COUNTERS.get(key)
    if c is None or c.numel() < n:
        c = _COUNTERS[key] = torch.zeros(max(n, 64), dtype=torch.int32,
                                         device=device)
    return c


def _launch(x, row_ptr, max_deg, mean, std, enc, cots, affine):
    refuse_grad("pna_stats_bwd", x, mean, std, *cots,
                *(() if affine is None else affine))
    E, D = x.shape
    N = row_ptr.shape[0] - 1
    dev = x.device
    require(x, "x", torch.bfloat16, (E, D), dev)
    require(row_ptr, "row_ptr", torch.int32, (N + 1,), dev)
    for name, t in zip(("mean", "std", "enc") + COTANGENTS,
                       (mean, std, enc) + tuple(cots)):
        if t is not None:
            require(t, name, torch.bfloat16, (N, D), dev)
    d_x = torch.empty_like(x)
    aff = (None, None)
    dab = tile_part = chunk_part = counters = None
    tn = tile_nodes(D)
    tiles = -(-N // tn)
    chunks = -(-tiles // CHUNK_TILES)
    if affine is not None:
        aff = tuple(t.float().contiguous() for t in affine)
        for name, t in zip(("scale", "shift"), aff):
            require(t, name, torch.float32, (D,), dev)
        dab = torch.empty(2, D, dtype=torch.float32, device=dev)
        tile_part = torch.empty(max(tiles, 1), 2, D, dtype=torch.float32,
                                device=dev)
        chunk_part = torch.empty(max(chunks, 1), 2, D, dtype=torch.float32,
                                 device=dev)
        counters = _counters(dev, stream_of(x), chunks + 1)
    if D > 0:
        fn = launcher("pna_stats_bwd", "pna_stats_bwd_bf16", _ARGTYPES)
        ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
        err = fn(x.data_ptr(), row_ptr.data_ptr(), mean.data_ptr(),
                 std.data_ptr(), enc.data_ptr(), *map(ptr, cots),
                 *map(ptr, aff), d_x.data_ptr(), ptr(dab), ptr(tile_part),
                 ptr(chunk_part), ptr(counters), N, E, D, max(max_deg, 1),
                 tn, CHUNK_TILES, stream_of(x))
        check_launch("pna_stats_bwd", err)
        pna_stats_bwd.launches += 1
    if affine is None:
        return d_x, None, None
    return d_x, dab[0], dab[1]


def pna_stats_bwd(x, row_ptr, max_deg, mean, std, enc, d_sum, d_mean, d_std,
                  d_max, d_min, affine=None):
    """The stats backward (see `pna_stats_bwd_reference` for the
    arguments): per edge of node n at slot s, ``d = A + B·(m − mean) +
    d_max·[s == amax] + d_min·[s == amin]`` with ``A = d_sum + d_mean/deg``
    and ``B = d_std/(deg·max(std, √eps))`` formed in float32 and rounded to
    bf16, 0 on padding edges; with an affine ``m = bf16(x·a + b)``, ``d_x =
    bf16(d·a)``, ``d_a = Σ d·x``, ``d_b = Σ d``.  Used as a backward, so it
    is not differentiable itself.  CPU tensors take the plain version; CUDA
    tensors launch the kernel (one launch) or raise."""
    cots = (d_sum, d_mean, d_std, d_max, d_min)
    if _build.on_card(x, "pna_stats_bwd"):
        return _launch(x, row_ptr, max_deg, mean, std, enc, cots, affine)
    return pna_stats_bwd_reference(x, row_ptr, max_deg, mean, std, enc,
                                   *cots, affine)


pna_stats_bwd.launches = 0
