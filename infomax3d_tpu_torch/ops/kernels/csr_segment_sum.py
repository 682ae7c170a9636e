"""CSR segment sum of receiver-sorted edge rows, the backward of the
receiver gather (port of `_seg_sum_kernel` / `_csr_seg_sum_raw` /
`csr_segment_sum_bf16`, infomax3d_tpu/ops/pallas/spmm.py).  Kernel:
`csr_segment_sum_kernel` of `csrc/csr_sum.cu`, on the small CSR walks'
`walk_rows`."""
from __future__ import annotations

import ctypes

import torch

from infomax3d_tpu_torch.ops.kernels import _build
from infomax3d_tpu_torch.ops.kernels._build import (check_launch, launcher,
                                                    refuse_grad, require,
                                                    stream_of)
from infomax3d_tpu_torch.ops.kernels.csr_sum import slot_sums

_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = (_P,) * 3 + (_I,) * 4 + (_P,)
_SYMBOLS = {torch.bfloat16: "csr_segment_sum_bf16",
            torch.float32: "csr_segment_sum_f32"}


def _check(ct):
    if ct.dtype not in _SYMBOLS:
        raise TypeError(f"csr_segment_sum: bf16 or float32, got {ct.dtype}")


def csr_segment_sum_reference(ct, row_ptr):
    """Plain PyTorch version, in the kernel's order: each node's CSR range
    of `ct` summed slot by slot in float32 and rounded to ct's type once;
    0 where a node has no edges."""
    _check(ct)
    return slot_sums(ct, row_ptr).to(ct.dtype)


def _launch(ct, row_ptr, wide: bool = False):
    """The kernel on CUDA tensors; `wide` forces 64-bit index arithmetic
    (the kernel takes it by itself where max(N, E) * D >= 2^31)."""
    refuse_grad("csr_segment_sum", ct)
    _check(ct)
    E, D = ct.shape
    N = row_ptr.shape[0] - 1
    dev = ct.device
    require(ct, "ct", ct.dtype, (E, D), dev)
    require(row_ptr, "row_ptr", torch.int32, (N + 1,), dev)
    out = torch.empty(N, D, dtype=ct.dtype, device=dev)
    if N > 0 and D > 0:
        # the kernels of csrc/csr_sum.cu build into the library "csr_sum"
        fn = launcher("csr_sum", _SYMBOLS[ct.dtype], _ARGTYPES)
        err = fn(ct.data_ptr(), row_ptr.data_ptr(), out.data_ptr(), N, E, D,
                 int(wide), stream_of(ct))
        check_launch("csr_sum", err)
        csr_segment_sum.launches += 1
    return out


def csr_segment_sum(ct, row_ptr):
    """`ct [E, D]` (bf16 or float32, receiver-sorted rows), `row_ptr
    [N + 1]` int32 -> [N, D] of ct's type, each node's rows summed; rows
    past ``row_ptr[N]`` are dropped.  Used as a backward, so it is not
    differentiable itself.  CPU tensors take the plain version; CUDA
    tensors launch the kernel or raise."""
    _check(ct)
    if _build.on_card(ct, "csr_segment_sum"):
        return _launch(ct, row_ptr)
    return csr_segment_sum_reference(ct, row_ptr)


csr_segment_sum.launches = 0
