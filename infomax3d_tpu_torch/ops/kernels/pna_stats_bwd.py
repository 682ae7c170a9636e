"""Backward of the fused bf16 PNA statistics (port of `_stats_bwd_kernel` /
`_stats_bwd_kernel_aff` / `_csr_stats_bwd_raw`, infomax3d_tpu/ops/pallas/
spmm.py).  Kernel: `csrc/pna_stats_bwd.cu`."""
from __future__ import annotations

import ctypes

import torch

from infomax3d_tpu_torch.ops.kernels import _build
from infomax3d_tpu_torch.ops.kernels._build import (check_launch, launcher,
                                                    refuse_grad, require,
                                                    stream_of)

_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = (_P,) * 13 + (_I,) * 3 + (_P,)
# the kernel's column-sum order: tiles of TILE_E edges, each walked by
# LANES edge lanes (lane l takes edges l, l + LANES, ...)
TILE_E = 64
LANES = 8


def _winner_slots(enc):
    """(amax, amin) decoded from ``enc = amax + 16 * amin`` (float32)."""
    amin = torch.floor(enc * 0.0625)
    return enc - 16.0 * amin, amin


def _column_sums(v):
    """Column sums of float32 `v [E, D]` in the kernel's order: per tile,
    each lane sums its edges in order, the lanes are summed in order, and
    the tiles are summed in order."""
    E, D = v.shape
    tiles = -(-E // TILE_E)
    v = torch.cat([v, v.new_zeros(tiles * TILE_E - E, D)])
    v = v.view(tiles, TILE_E // LANES, LANES, D)      # e = t*64 + i*8 + l
    lane = v[:, 0]
    for i in range(1, TILE_E // LANES):
        lane = lane + v[:, i]
    tile = lane[:, 0]
    for lane_i in range(1, LANES):
        tile = tile + lane[:, lane_i]
    total = tile[0]
    for t in range(1, tiles):
        total = total + tile[t]
    return total


def pna_stats_bwd_reference(x, receivers, pos, operands, affine=None):
    """Plain PyTorch version, rounding where the kernel rounds.  `x [E, D]`
    bf16 (the pre-affine messages when `affine` is given), `receivers [E]`,
    `pos [E]` (each edge's slot in its receiver's CSR range, -1 on
    padding), `operands` the six bf16 [N, D] node arrays (A, B, mean, d_max,
    d_min, enc).  Returns (d_x bf16 [E, D], d_a, d_b): the column sums are
    float32 [D] with an affine, else None."""
    A, B, mean, dmx, dmn, enc = operands
    N = A.shape[0]
    r = receivers.long()
    valid = ((r >= 0) & (r < N))[:, None]
    rc = r.clamp(0, N - 1)
    Ae, Be, mean_e, dmx_e, dmn_e, enc_e = (t[rc].float() for t in operands)
    xf = x.float()
    m = xf
    if affine is not None:
        m = (xf * affine[0].float() + affine[1].float()).to(
            torch.bfloat16).float()
    amax, amin = _winner_slots(enc_e)
    p = pos.float()[:, None]
    d = Ae + Be * (m - mean_e)
    d = d + dmx_e * (p == amax).float()
    d = d + dmn_e * (p == amin).float()
    d = torch.where(valid, d, torch.zeros((), device=x.device))
    if affine is None:
        return d.to(torch.bfloat16), None, None
    d_a = _column_sums(d * xf)
    d_b = _column_sums(d)
    return (d * affine[0].float()).to(torch.bfloat16), d_a, d_b


def _launch(x, receivers, pos, operands, affine):
    refuse_grad("pna_stats_bwd", x, *operands,
                *(() if affine is None else affine))
    E, D = x.shape
    N = operands[0].shape[0]
    dev = x.device
    require(x, "x", torch.bfloat16, (E, D), dev)
    require(receivers, "receivers", torch.int32, (E,), dev)
    require(pos, "pos", torch.int16, (E,), dev)
    for name, t in zip(("A", "B", "mean", "d_max", "d_min", "enc"),
                       operands):
        require(t, name, torch.bfloat16, (N, D), dev)
    d_x = torch.empty_like(x)
    aff = part = dab = None
    if affine is not None:
        aff = torch.stack([affine[0].float(), affine[1].float()]).contiguous()
        require(aff, "affine", torch.float32, (2, D), dev)
        tiles = launcher("pna_stats_bwd", "pna_stats_bwd_tiles", (_I,))(E)
        part = torch.empty(2, tiles, D, dtype=torch.float32, device=dev)
        dab = torch.empty(2, D, dtype=torch.float32, device=dev)
    if E > 0 and D > 0:
        fn = launcher("pna_stats_bwd", "pna_stats_bwd_bf16", _ARGTYPES)
        ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
        err = fn(x.data_ptr(), receivers.data_ptr(), pos.data_ptr(),
                 *(t.data_ptr() for t in operands), ptr(aff), d_x.data_ptr(),
                 ptr(part), ptr(dab), N, E, D, stream_of(x))
        check_launch("pna_stats_bwd", err)
        pna_stats_bwd.launches += 1
    if affine is None:
        return d_x, None, None
    return d_x, dab[0], dab[1]


def pna_stats_bwd(x, receivers, pos, operands, affine=None):
    """The stats backward (see `pna_stats_bwd_reference` for the
    arguments): per edge ``d = A + B·(m − mean) + d_max·[pos == amax] +
    d_min·[pos == amin]`` at its receiver, 0 on padding edges, with
    ``m = bf16(x·a + b)`` and ``d_x = bf16(d·a)``, ``d_a = Σ d·x``, ``d_b =
    Σ d`` under an affine.  Used as a backward, so it is not differentiable
    itself.  CPU tensors take the plain version; CUDA tensors launch the
    kernel or raise."""
    if _build.on_card(x, "pna_stats_bwd"):
        return _launch(x, receivers, pos, operands, affine)
    return pna_stats_bwd_reference(x, receivers, pos, operands, affine)


pna_stats_bwd.launches = 0
