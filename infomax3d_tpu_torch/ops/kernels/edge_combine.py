"""Fused edge combine `z[e] = hd[recv[e]] + hs[send[e]] + pe[e]` (port of
`_edge_combine_kernel` / `csr_edge_combine`, infomax3d_tpu/ops/pallas/
spmm.py), differentiable: its backward is the pair segment sum
(`d_hd, d_hs`) and ``d_pe = ct``, as in the JAX package's custom VJP.
Kernel: `csrc/edge_combine.cu`."""
from __future__ import annotations

import ctypes

import torch

from infomax3d_tpu_torch.ops.kernels import _build
from infomax3d_tpu_torch.ops.kernels._build import (check_launch, launcher,
                                                    refuse_grad, require,
                                                    stream_of)
from infomax3d_tpu_torch.ops.kernels.pair_segment_sum import pair_segment_sum

_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = (_P,) * 6 + (_I,) * 4 + (_P,)
_SYMBOLS = {torch.bfloat16: "edge_combine_bf16",
            torch.float32: "edge_combine_f32"}


def edge_combine_reference(hd, hs, pe, receivers, senders):
    """Plain PyTorch version: the three terms summed in float32 in order and
    rounded to `pe.dtype` once; a term whose index is outside [0, N) is left
    out, so padding edges get `pe` alone."""
    N = hd.shape[0]
    r, s = receivers.long(), senders.long()
    zero = torch.zeros((), dtype=torch.float32, device=pe.device)
    zd = torch.where(((r >= 0) & (r < N))[:, None],
                     hd[r.clamp(0, N - 1)].float(), zero)
    zs = torch.where(((s >= 0) & (s < N))[:, None],
                     hs[s.clamp(0, N - 1)].float(), zero)
    return (zd + zs + pe.float()).to(pe.dtype)


def _launch(hd, hs, pe, receivers, senders, wide: bool = False):
    """The kernel on CUDA tensors; `wide` forces 64-bit index arithmetic
    (the kernel takes it by itself where max(N, E) * D >= 2^31)."""
    refuse_grad("edge_combine", hd, hs, pe)
    if pe.dtype not in _SYMBOLS:
        raise TypeError(f"edge_combine: bf16 or float32, got {pe.dtype}")
    N, D = hd.shape
    E = pe.shape[0]
    dev = pe.device
    require(hd, "hd", pe.dtype, (N, D), dev)
    require(hs, "hs", pe.dtype, (N, D), dev)
    require(pe, "pe", pe.dtype, (E, D), dev)
    require(receivers, "receivers", torch.int32, (E,), dev)
    require(senders, "senders", torch.int32, (E,), dev)
    out = torch.empty_like(pe)
    if E == 0 or D == 0:
        return out
    if N == 0:
        raise ValueError("edge_combine: edges but no nodes")
    fn = launcher("edge_combine", _SYMBOLS[pe.dtype], _ARGTYPES)
    err = fn(hd.data_ptr(), hs.data_ptr(), pe.data_ptr(),
             receivers.data_ptr(), senders.data_ptr(), out.data_ptr(),
             N, E, D, int(wide), stream_of(pe))
    check_launch("edge_combine", err)
    edge_combine.launches += 1
    return out


class EdgeCombine(torch.autograd.Function):
    """Forward: the kernel on CUDA, the plain version on the CPU.  Backward
    (`spmm.py::_combine_bwd`): ``d_hd, d_hs = pair_segment_sum(ct)`` over
    the CSR and CSC ranges, ``d_pe = ct``."""

    @staticmethod
    def forward(ctx, hd, hs, pe, receivers, senders, row_ptr, csc_row_ptr,
                csc_perm):
        ctx.save_for_backward(row_ptr, csc_row_ptr, csc_perm)
        if _build.on_card(pe, "edge_combine"):
            return _launch(hd, hs, pe, receivers, senders)
        return edge_combine_reference(hd, hs, pe, receivers, senders)

    @staticmethod
    def backward(ctx, ct):
        row_ptr, csc_row_ptr, csc_perm = ctx.saved_tensors
        if row_ptr is None or csc_row_ptr is None or csc_perm is None:
            raise ValueError("edge_combine: the gradient needs row_ptr, "
                             "csc_row_ptr and csc_perm")
        d_hd, d_hs = pair_segment_sum(ct.contiguous(), row_ptr, csc_row_ptr,
                                      csc_perm)
        return d_hd, d_hs, ct, None, None, None, None, None


def edge_combine(hd, hs, pe, receivers, senders, row_ptr=None,
                 csc_row_ptr=None, csc_perm=None):
    """`hd, hs [N, D]`, `pe [E, D]` (bf16 or float32), `receivers, senders
    [E]` int32 -> `[E, D]`.  The gradient needs the batch's `row_ptr`,
    `csc_row_ptr` and `csc_perm` (int32).  CPU tensors take the plain
    version; CUDA tensors launch the kernel or raise."""
    return EdgeCombine.apply(hd, hs, pe, receivers, senders, row_ptr,
                             csc_row_ptr, csc_perm)


edge_combine.launches = 0
