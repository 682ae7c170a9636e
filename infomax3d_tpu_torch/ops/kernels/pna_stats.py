"""Fused bf16 PNA statistics over a CSR batch (port of `_stats_kernel` /
`_stats_kernel_aff` / `_csr_stats_raw` and the custom VJP of
`csr_pna_stats`, infomax3d_tpu/ops/pallas/spmm.py), differentiable: its
backward is the stats-backward kernel (`pna_stats_bwd`).
Kernel: `csrc/pna_stats.cu`."""
from __future__ import annotations

import ctypes

import torch

from infomax3d_tpu_torch.ops.kernels import _build
from infomax3d_tpu_torch.ops.kernels._build import (check_launch, launcher,
                                                    refuse_grad, require,
                                                    stream_of)
from infomax3d_tpu_torch.ops.kernels.pna_stats_bwd import (pna_stats_bwd,
                                                           tile_nodes)
from infomax3d_tpu_torch.ops.segment import EPS

_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = (_P,) * 5 + (_I,) * 5 + (_P,)
NEG_BIG = -3.0e38
POS_BIG = 3.0e38
# the winner slots pack as amax + 16 * amin, exact in bf16 for K <= 16
MAX_SLOTS = 16


def _check(messages, max_deg):
    if messages.dtype != torch.bfloat16:
        raise TypeError(f"pna_stats: bf16 messages, got {messages.dtype}")
    if not 0 < max_deg <= MAX_SLOTS:
        raise ValueError(f"pna_stats: max_deg must be in [1, {MAX_SLOTS}], "
                         f"got {max_deg}")


def csr_mailbox(messages, row_ptr, max_deg: int):
    """Each node's first `max_deg` CSR rows gathered into [N, K, D] float32
    (0 in empty slots), the [N, K] slot mask and the [N] in-degrees."""
    E, D = messages.shape
    rp = row_ptr.long()
    deg = rp[1:] - rp[:-1]
    slots = torch.arange(max_deg, device=messages.device)
    valid = slots[None, :] < deg[:, None]
    idx = torch.where(valid, rp[:-1, None] + slots[None, :], E)
    padded = torch.cat([messages, messages.new_zeros(1, D)])
    return padded[idx].float(), valid, deg


def pna_stats_reference(messages, row_ptr, max_deg: int, affine=None,
                        want_sum: bool = True):
    """Plain PyTorch version (the mailbox form of the JAX package's
    `_csr_stats_mailbox_raw`): gather each node's first `max_deg` CSR rows
    into [N, K, D] and reduce slot by slot, in the kernel's order.
    Returns (sum | None, mean, std, max, min, enc), each bf16 [N, D]."""
    _check(messages, max_deg)
    mail, valid, deg = csr_mailbox(messages, row_ptr, max_deg)
    if affine is not None:
        a, b = affine
        mail = (mail * a.float() + b.float()).to(torch.bfloat16).float()
    N, D = deg.shape[0], messages.shape[1]
    s1 = torch.zeros(N, D, device=messages.device)
    s2 = torch.zeros_like(s1)
    mx = torch.full_like(s1, NEG_BIG)
    mn = torch.full_like(s1, POS_BIG)
    amax = torch.zeros_like(s1)
    amin = torch.zeros_like(s1)
    for k in range(max_deg):
        m = mail[:, k]
        v = valid[:, k, None]
        s1 = torch.where(v, s1 + m, s1)
        s2 = torch.where(v, s2 + m * m, s2)
        gt = v & (m > mx)
        lt = v & (m < mn)
        amax = torch.where(gt, float(k), amax)
        amin = torch.where(lt, float(k), amin)
        mx = torch.where(gt, m, mx)
        mn = torch.where(lt, m, mn)
    degf = deg.float()[:, None]
    dsafe = degf.clamp(min=1.0)
    has = degf > 0
    mean = s1 / dsafe
    std = torch.sqrt(torch.relu(s2 / dsafe - mean * mean) + EPS)
    zero = torch.zeros((), device=messages.device)
    bf = torch.bfloat16
    return (s1.to(bf) if want_sum else None,
            torch.where(has, mean, zero).to(bf),
            torch.where(has, std, zero).to(bf),
            torch.where(has, mx, zero).to(bf),
            torch.where(has, mn, zero).to(bf),
            (amax + 16.0 * amin).to(bf))


def _launch(messages, row_ptr, max_deg, affine, want_sum):
    refuse_grad("pna_stats", messages, *(() if affine is None else affine))
    E, D = messages.shape
    N = row_ptr.shape[0] - 1
    dev = messages.device
    require(messages, "messages", torch.bfloat16, (E, D), dev)
    require(row_ptr, "row_ptr", torch.int32, (N + 1,), dev)
    aff = (None, None)
    if affine is not None:
        aff = tuple(t.float().contiguous() for t in affine)
        for name, t in zip(("scale", "shift"), aff):
            require(t, name, torch.float32, (D,), dev)
    nsec = 6 if want_sum else 5
    out = torch.empty(nsec, N, D, dtype=torch.bfloat16, device=dev)
    if N > 0 and D > 0:
        fn = launcher("pna_stats", "pna_stats_bf16", _ARGTYPES)
        err = fn(messages.data_ptr(), row_ptr.data_ptr(),
                 *(None if t is None else t.data_ptr() for t in aff),
                 out.data_ptr(), N, D, max_deg, int(want_sum), tile_nodes(D),
                 stream_of(messages))
        check_launch("pna_stats", err)
        pna_stats.launches += 1
    secs = tuple(out.unbind(0))
    return secs if want_sum else (None,) + secs


class PNAStats(torch.autograd.Function):
    """Forward: the stats kernel on CUDA, the plain version on the CPU.
    Backward (`spmm.py::_stats_bwd`): one call of the stats backward, which
    forms the node-side combinations of the cotangents itself and gives the
    affine's cotangents too.  Cotangents of unused outputs stay None (no
    zero arrays)."""

    @staticmethod
    def forward(ctx, messages, row_ptr, a, b, max_deg, want_sum):
        affine = None if a is None else (a, b)
        if _build.on_card(messages, "pna_stats"):
            outs = _launch(messages, row_ptr, max_deg, affine, want_sum)
        else:
            outs = pna_stats_reference(messages, row_ptr, max_deg, affine,
                                       want_sum)
        _, mean, std, _, _, enc = outs
        ctx.save_for_backward(messages, row_ptr, mean, std, enc, a, b)
        ctx.max_deg = max_deg
        ctx.mark_non_differentiable(enc)
        ctx.set_materialize_grads(False)
        return outs

    @staticmethod
    def backward(ctx, d_sum, d_mean, d_std, d_mx, d_mn, _d_enc):
        messages, row_ptr, mean, std, enc, a, b = ctx.saved_tensors
        cots = (None if c is None else c.contiguous()
                for c in (d_sum, d_mean, d_std, d_mx, d_mn))
        d_x, d_a, d_b = pna_stats_bwd(
            messages, row_ptr, ctx.max_deg, mean, std, enc, *cots,
            None if a is None else (a, b))
        return d_x, None, d_a, d_b, None, None


def pna_stats(messages, row_ptr, max_deg: int, affine=None,
              want_sum: bool = True):
    """`messages [E, D]` bf16, `row_ptr [N + 1]` int32, `affine` an optional
    pair of [D] column scale / shift applied as ``bf16(x * a + b)`` first.
    Returns (sum | None, mean, std, max, min, enc), each bf16 [N, D]; `enc`
    packs the first-winner slots as ``amax + 16 * amin`` and has no
    gradient.  Without `want_sum` no sum is returned (the JAX package
    rebuilds it as mean·deg for a caller that does not read it, so its
    cotangent is zero).  Differentiable to `messages` and the affine.  CPU
    tensors take the plain version; CUDA tensors launch the kernel or
    raise."""
    _check(messages, max_deg)
    a, b = (None, None) if affine is None else affine
    return PNAStats.apply(messages, row_ptr, a, b, max_deg, want_sum)


pna_stats.launches = 0
