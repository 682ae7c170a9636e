"""CSR multi-reduce (sum, sumsq, max, min) in float32 (port of `_kernel` /
`_csr_reduce_raw` / `csr_multi_reduce`, infomax3d_tpu/ops/pallas/spmm.py),
differentiable: its backward is plain PyTorch on both devices, as the JAX
package's `_bwd` is plain XLA.  Kernel: `csrc/multi_reduce.cu`."""
from __future__ import annotations

import ctypes

import torch

from infomax3d_tpu_torch.ops.kernels import _build
from infomax3d_tpu_torch.ops.kernels._build import (check_launch, launcher,
                                                    refuse_grad, require,
                                                    stream_of)
from infomax3d_tpu_torch.ops.kernels.pna_stats import (NEG_BIG, POS_BIG,
                                                        csr_mailbox)

_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = (_P,) * 3 + (_I,) * 5 + (_P,)
_SYMBOLS = {torch.float32: "multi_reduce_f32",
            torch.bfloat16: "multi_reduce_bf16"}


def _check(messages, max_deg):
    if messages.dtype not in _SYMBOLS:
        raise TypeError(f"multi_reduce: float32 or bf16 messages, got "
                        f"{messages.dtype}")
    if max_deg <= 0:
        raise ValueError(f"multi_reduce: max_deg must be > 0, got {max_deg}")


def multi_reduce_reference(messages, row_ptr, max_deg: int):
    """Plain PyTorch version: gather each node's first `max_deg` CSR rows
    into [N, K, D] and reduce slot by slot in float32, in the kernel's
    order.  Returns (sum, sumsq, max, min), each float32 [N, D]; 0 where a
    node has no edges."""
    _check(messages, max_deg)
    mail, valid, deg = csr_mailbox(messages, row_ptr, max_deg)
    N, D = deg.shape[0], messages.shape[1]
    s1 = torch.zeros(N, D, device=messages.device)
    s2 = torch.zeros_like(s1)
    mx = torch.full_like(s1, NEG_BIG)
    mn = torch.full_like(s1, POS_BIG)
    for k in range(max_deg):
        m = mail[:, k]
        v = valid[:, k, None]
        s1 = torch.where(v, s1 + m, s1)
        s2 = torch.where(v, s2 + m * m, s2)
        mx = torch.where(v, torch.maximum(mx, m), mx)
        mn = torch.where(v, torch.minimum(mn, m), mn)
    has = (deg > 0)[:, None]
    zero = torch.zeros((), device=messages.device)
    return s1, s2, torch.where(has, mx, zero), torch.where(has, mn, zero)


def _launch(messages, row_ptr, max_deg, wide: bool = False):
    """The kernel on CUDA tensors; `wide` forces 64-bit index arithmetic
    (the kernel takes it by itself where max(N, E) * D >= 2^31)."""
    refuse_grad("multi_reduce", messages)
    E, D = messages.shape
    N = row_ptr.shape[0] - 1
    dev = messages.device
    require(messages, "messages", messages.dtype, (E, D), dev)
    require(row_ptr, "row_ptr", torch.int32, (N + 1,), dev)
    out = torch.empty(4, N, D, dtype=torch.float32, device=dev)
    if N > 0 and D > 0:
        fn = launcher("multi_reduce", _SYMBOLS[messages.dtype], _ARGTYPES)
        err = fn(messages.data_ptr(), row_ptr.data_ptr(), out.data_ptr(),
                 N, E, D, max_deg, int(wide), stream_of(messages))
        check_launch("multi_reduce", err)
        multi_reduce.launches += 1
    return tuple(out.unbind(0))


def multi_reduce_bwd(messages, receivers, mx, mn, cts,
                     split_ties: bool = False):
    """The JAX package's `_bwd` (spmm.py), plain PyTorch: each edge gets
    its receiver's sum cotangent, ``2·m`` times the sumsq one, and the
    max / min ones where it ties the extremum — compared against the
    message and its bf16 rounding, so every tie gets the full cotangent.
    With `split_ties`, the max / min cotangents are shared equally among
    the edges equal to the extremum instead, as the gradient of XLA's
    segment max / min is (the JAX package's `pna_multi_aggregate`).
    Padding edges get 0."""
    d_s, d_s2, d_mx, d_mn = cts
    N = mx.shape[0]
    r = receivers.long().clamp(0, N - 1)
    valid = (receivers < N)[:, None]
    m = messages.float()
    d = d_s[r] + 2.0 * m * d_s2[r]
    mx_e, mn_e = mx[r], mn[r]
    if split_ties:
        ids = torch.where(receivers < N, receivers.long(), N)
        for ct, ext in ((d_mx, mx_e), (d_mn, mn_e)):
            tie = ((m == ext) & valid).float()
            count = torch.zeros(N + 1, tie.shape[1], device=tie.device)
            count = count.index_add_(0, ids, tie)[:N]
            d = d + ct[r] * tie / count[r].clamp(min=1.0)
    else:
        m_r = messages.to(torch.bfloat16).float()
        d = d + d_mx[r] * ((m_r == mx_e) | (m == mx_e)).float()
        d = d + d_mn[r] * ((m_r == mn_e) | (m == mn_e)).float()
    return torch.where(valid, d, torch.zeros((), device=d.device)).to(
        messages.dtype)


class MultiReduce(torch.autograd.Function):
    """Forward: the multi-reduce kernel on CUDA, the plain version on the
    CPU.  Backward: `multi_reduce_bwd` on both."""

    @staticmethod
    def forward(ctx, messages, row_ptr, receivers, max_deg, split_ties):
        ctx.split_ties = split_ties
        if _build.on_card(messages, "multi_reduce"):
            outs = _launch(messages, row_ptr, max_deg)
        else:
            outs = multi_reduce_reference(messages, row_ptr, max_deg)
        ctx.save_for_backward(messages, receivers, outs[2], outs[3])
        return outs

    @staticmethod
    def backward(ctx, *cts):
        messages, receivers, mx, mn = ctx.saved_tensors
        if receivers is None:
            raise ValueError("multi_reduce: the gradient needs the batch's "
                             "receivers")
        cts = tuple(torch.zeros_like(mx) if c is None else c for c in cts)
        return (multi_reduce_bwd(messages, receivers, mx, mn, cts,
                                 ctx.split_ties), None, None, None, None)


def multi_reduce(messages, row_ptr, max_deg: int, receivers=None,
                 split_ties: bool = False):
    """`messages [E, D]` float32 or bf16, `row_ptr [N + 1]` int32 ->
    (sum, sumsq, max, min), each float32 [N, D].  The gradient needs the
    batch's `receivers` [E]; `split_ties` shares the max / min cotangents
    among tied edges (`multi_reduce_bwd`).  CPU tensors take the plain
    version; CUDA tensors launch the kernel or raise."""
    _check(messages, max_deg)
    return MultiReduce.apply(messages, row_ptr, receivers, max_deg,
                             split_ties)


multi_reduce.launches = 0
