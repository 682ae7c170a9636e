"""CSR sum in float32 (port of `_sum_kernel` / `_csr_sum_raw` / `csr_sum`
and `csr_mean`, infomax3d_tpu/ops/pallas/spmm.py), differentiable: its
backward gathers the cotangent at each edge's receiver in plain PyTorch on
both devices, as the JAX package's `_sum_bwd` is plain XLA.  Kernel:
`csrc/csr_sum.cu`."""
from __future__ import annotations

import ctypes

import torch

from infomax3d_tpu_torch.ops.kernels import _build
from infomax3d_tpu_torch.ops.kernels._build import (check_launch, launcher,
                                                    refuse_grad, require,
                                                    stream_of)

_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = (_P,) * 3 + (_I,) * 4 + (_P,)
_SYMBOLS = {torch.float32: "csr_sum_f32", torch.bfloat16: "csr_sum_bf16"}


def slot_sums(rows: torch.Tensor, row_ptr: torch.Tensor,
              perm: torch.Tensor = None) -> torch.Tensor:
    """float32 [N, D]: each node's range of `row_ptr` summed slot by slot
    in float32 (its rows read through `perm` when given) — the order in
    which the port's CSR-walking kernels sum."""
    E, D = rows.shape
    rp = row_ptr.long()
    deg = rp[1:] - rp[:-1]
    padded = torch.cat([rows, rows.new_zeros(1, D)])
    through = None if perm is None else torch.cat(
        [perm.long(), perm.new_full((1,), E).long()])
    acc = torch.zeros(deg.shape[0], D, device=rows.device)
    for k in range(int(deg.max()) if deg.numel() else 0):
        valid = k < deg
        idx = torch.where(valid, rp[:-1] + k, E)
        if through is not None:
            idx = through[idx]
        acc = torch.where(valid[:, None], acc + padded[idx].float(), acc)
    return acc


def _check(messages):
    if messages.dtype not in _SYMBOLS:
        raise TypeError(f"csr_sum: float32 or bf16 messages, got "
                        f"{messages.dtype}")


def csr_sum_reference(messages, row_ptr):
    """Plain PyTorch version, in the kernel's order: float32 [N, D], each
    node's CSR range of `messages` summed slot by slot in float32; 0 where
    a node has no edges."""
    _check(messages)
    return slot_sums(messages, row_ptr)


def _launch(messages, row_ptr, wide=False):
    """The kernel on CUDA tensors: `messages [E, D]`, `row_ptr [N + 1]`
    int32 -> float32 [N, D].  The kernel takes its path from N, E and D
    (`stream_path` in csrc/csr_sum.cu: the stream where E >= 8 N, else
    the walk) and picks 32-bit or 64-bit indices itself; `wide` forces
    64-bit (the card check's way to that path)."""
    refuse_grad("csr_sum", messages)
    E, D = messages.shape
    N = row_ptr.shape[0] - 1
    dev = messages.device
    require(messages, "messages", messages.dtype, (E, D), dev)
    require(row_ptr, "row_ptr", torch.int32, (N + 1,), dev)
    out = torch.empty(N, D, dtype=torch.float32, device=dev)
    if N > 0 and D > 0:
        fn = launcher("csr_sum", _SYMBOLS[messages.dtype], _ARGTYPES)
        err = fn(messages.data_ptr(), row_ptr.data_ptr(), out.data_ptr(), N,
                 E, D, int(wide), stream_of(messages))
        check_launch("csr_sum", err)
        csr_sum.launches += 1
    return out


class CsrSum(torch.autograd.Function):
    """Forward: the CSR-sum kernel on CUDA, the plain version on the CPU.
    Backward (the JAX package's `_sum_bwd`): each edge gets its receiver's
    cotangent, padding edges 0, in the messages' dtype."""

    @staticmethod
    def forward(ctx, messages, row_ptr, receivers):
        ctx.save_for_backward(receivers)
        ctx.dtype = messages.dtype
        if _build.on_card(messages, "csr_sum"):
            return _launch(messages, row_ptr)
        return csr_sum_reference(messages, row_ptr)

    @staticmethod
    def backward(ctx, d_s):
        receivers, = ctx.saved_tensors
        if receivers is None:
            raise ValueError("csr_sum: the gradient needs the batch's "
                             "receivers")
        N = d_s.shape[0]
        d = d_s[receivers.long().clamp(0, N - 1)]
        zero = torch.zeros((), dtype=d.dtype, device=d.device)
        return (torch.where((receivers < N)[:, None], d, zero).to(ctx.dtype),
                None, None)


def csr_sum(messages, row_ptr, receivers=None):
    """`messages [E, D]` float32 or bf16, `row_ptr [N + 1]` int32 ->
    float32 [N, D], each node's incoming messages summed.  The gradient
    needs the batch's `receivers` [E].  CPU tensors take the plain version;
    CUDA tensors launch the kernel or raise."""
    _check(messages)
    return CsrSum.apply(messages, row_ptr, receivers)


csr_sum.launches = 0


def csr_mean(messages, row_ptr, receivers=None):
    """`csr_sum` over each node's in-degree (at least 1), in the messages'
    dtype (the JAX package's `csr_mean`, plain PyTorch around the sum)."""
    rp = row_ptr.long()
    deg = (rp[1:] - rp[:-1]).float()[:, None]
    return (csr_sum(messages, row_ptr, receivers) / deg.clamp(min=1.0)).to(
        messages.dtype)
