"""Sender-keyed segment sum of edge rows, the backward of the sender gather
(port of `_snd_seg_sum_kernel` through `_snd_kernel_norecv` /
`snd_segment_sum_bf16`, infomax3d_tpu/ops/pallas/spmm.py).  Kernel:
`csrc/snd_segment_sum.cu`."""
from __future__ import annotations

import ctypes

import torch

from infomax3d_tpu_torch.ops.kernels import _build
from infomax3d_tpu_torch.ops.kernels._build import (check_launch, launcher,
                                                    refuse_grad, require,
                                                    stream_of)
from infomax3d_tpu_torch.ops.kernels.csr_sum import slot_sums

_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = (_P,) * 4 + (_I,) * 4 + (_P,)
_SYMBOLS = {torch.bfloat16: "snd_segment_sum_bf16",
            torch.float32: "snd_segment_sum_f32"}


def snd_segment_sum_reference(ct, csc_row_ptr, csc_perm):
    """Plain PyTorch version, in the kernel's order: d[n], the sum of
    ct[csc_perm[j]] over n's sender-sorted range, accumulated in float32
    slot by slot and rounded to ct's type once."""
    return slot_sums(ct, csc_row_ptr, csc_perm).to(ct.dtype)


def _launch(ct, csc_row_ptr, csc_perm, wide: bool = False):
    """The kernel on CUDA tensors; `wide` forces 64-bit index arithmetic
    (the kernel takes it by itself where max(N, E) * D >= 2^31)."""
    refuse_grad("snd_segment_sum", ct)
    if ct.dtype not in _SYMBOLS:
        raise TypeError(f"snd_segment_sum: bf16 or float32, got {ct.dtype}")
    E, D = ct.shape
    N = csc_row_ptr.shape[0] - 1
    dev = ct.device
    require(ct, "ct", ct.dtype, (E, D), dev)
    require(csc_row_ptr, "csc_row_ptr", torch.int32, (N + 1,), dev)
    require(csc_perm, "csc_perm", torch.int32, (E,), dev)
    out = torch.empty(N, D, dtype=ct.dtype, device=dev)
    if N > 0 and D > 0:
        fn = launcher("snd_segment_sum", _SYMBOLS[ct.dtype], _ARGTYPES)
        err = fn(ct.data_ptr(), csc_row_ptr.data_ptr(), csc_perm.data_ptr(),
                 out.data_ptr(), N, E, D, int(wide), stream_of(ct))
        check_launch("snd_segment_sum", err)
        snd_segment_sum.launches += 1
    return out


def snd_segment_sum(ct, csc_row_ptr, csc_perm):
    """`ct [E, D]` (bf16 or float32), `csc_row_ptr [N + 1]` and `csc_perm
    [E]` int32 -> [N, D] of ct's type, each node's sent rows summed.  Used
    as a backward, so it is not differentiable itself.  CPU tensors take
    the plain version; CUDA tensors launch the kernel or raise."""
    if _build.on_card(ct, "snd_segment_sum"):
        return _launch(ct, csc_row_ptr, csc_perm)
    return snd_segment_sum_reference(ct, csc_row_ptr, csc_perm)


snd_segment_sum.launches = 0
