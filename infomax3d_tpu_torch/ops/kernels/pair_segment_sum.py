"""Receiver- and sender-keyed segment sums of edge rows in one call, the
backward of the fused edge combine (port of `_snd_seg_sum_kernel` through
`_snd_kernel_pair` / `pair_segment_sum_bf16`, infomax3d_tpu/ops/pallas/
spmm.py).  Kernel: `csrc/pair_segment_sum.cu`."""
from __future__ import annotations

import ctypes

import torch

from infomax3d_tpu_torch.ops.kernels import _build
from infomax3d_tpu_torch.ops.kernels._build import (check_launch, launcher,
                                                    refuse_grad, require,
                                                    stream_of)
from infomax3d_tpu_torch.ops.kernels.csr_sum import slot_sums

_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = (_P,) * 6 + (_I,) * 4 + (_P,)
_SYMBOLS = {torch.bfloat16: "pair_segment_sum_bf16",
            torch.float32: "pair_segment_sum_f32"}


def pair_segment_sum_reference(ct, row_ptr, csc_row_ptr, csc_perm):
    """Plain PyTorch version, in the kernel's order: ``(d_hd, d_hs)`` with
    d_hd[n] the sum of ct over n's receiver-sorted range and d_hs[n] the sum
    of ct[csc_perm[j]] over n's sender-sorted range, each accumulated in
    float32 slot by slot and rounded once."""
    return (slot_sums(ct, row_ptr).to(ct.dtype),
            slot_sums(ct, csc_row_ptr, csc_perm).to(ct.dtype))


def _launch(ct, row_ptr, csc_row_ptr, csc_perm, wide: bool = False):
    """The kernel on CUDA tensors; `wide` forces 64-bit index arithmetic
    (the kernel takes it by itself where max(N, E) * D >= 2^31)."""
    refuse_grad("pair_segment_sum", ct)
    if ct.dtype not in _SYMBOLS:
        raise TypeError(f"pair_segment_sum: bf16 or float32, got {ct.dtype}")
    E, D = ct.shape
    N = row_ptr.shape[0] - 1
    dev = ct.device
    require(ct, "ct", ct.dtype, (E, D), dev)
    require(row_ptr, "row_ptr", torch.int32, (N + 1,), dev)
    require(csc_row_ptr, "csc_row_ptr", torch.int32, (N + 1,), dev)
    require(csc_perm, "csc_perm", torch.int32, (E,), dev)
    # two allocations, so both outputs are 16-byte aligned whatever N * D
    d_hd, d_hs = (torch.empty(N, D, dtype=ct.dtype, device=dev)
                  for _ in range(2))
    if N > 0 and D > 0:
        fn = launcher("pair_segment_sum", _SYMBOLS[ct.dtype], _ARGTYPES)
        err = fn(ct.data_ptr(), row_ptr.data_ptr(), csc_row_ptr.data_ptr(),
                 csc_perm.data_ptr(), d_hd.data_ptr(), d_hs.data_ptr(),
                 N, E, D, int(wide), stream_of(ct))
        check_launch("pair_segment_sum", err)
        pair_segment_sum.launches += 1
    return d_hd, d_hs


def pair_segment_sum(ct, row_ptr, csc_row_ptr, csc_perm):
    """`ct [E, D]` (bf16 or float32), `row_ptr`, `csc_row_ptr [N + 1]` and
    `csc_perm [E]` int32 -> ``(d_hd, d_hs)``, each [N, D] of ct's type.
    Used as a backward, so it is not differentiable itself.  CPU tensors
    take the plain version; CUDA tensors launch the kernel or raise."""
    if _build.on_card(ct, "pair_segment_sum"):
        return _launch(ct, row_ptr, csc_row_ptr, csc_perm)
    return pair_segment_sum_reference(ct, row_ptr, csc_row_ptr, csc_perm)


pair_segment_sum.launches = 0
