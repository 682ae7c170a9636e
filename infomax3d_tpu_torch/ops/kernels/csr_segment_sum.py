"""CSR segment sum of receiver-sorted edge rows, the backward of the
receiver gather (port of `_seg_sum_kernel` / `_csr_seg_sum_raw` /
`csr_segment_sum_bf16`, infomax3d_tpu/ops/pallas/spmm.py).  Kernel:
`csr_segment_sum_kernel` of `csrc/csr_sum.cu`, on the CSR sum's walk."""
from __future__ import annotations

import torch

from infomax3d_tpu_torch.ops.kernels import _build
from infomax3d_tpu_torch.ops.kernels.csr_sum import launch_walk, slot_sums

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


def _launch(ct, row_ptr):
    return launch_walk(csr_segment_sum, _SYMBOLS[ct.dtype], ct, row_ptr,
                       ct.dtype)


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
