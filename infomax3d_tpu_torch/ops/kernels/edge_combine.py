"""Fused edge combine `z[e] = hd[recv[e]] + hs[send[e]] + pe[e]` (port of
`_edge_combine_kernel` / `csr_edge_combine`, infomax3d_tpu/ops/pallas/
spmm.py).  Kernel: `csrc/edge_combine.cu`."""
from __future__ import annotations

import ctypes

import torch

from infomax3d_tpu_torch.ops.kernels._build import (check_launch, launcher,
                                                    require, stream_of)

_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = (_P,) * 6 + (_I,) * 3 + (_P,)
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


def edge_combine(hd, hs, pe, receivers, senders):
    """`hd, hs [N, D]`, `pe [E, D]` (bf16 or float32), `receivers, senders
    [E]` int32 -> `[E, D]`.  CPU tensors take the plain version; CUDA
    tensors launch the kernel or raise."""
    if pe.device.type == "cpu":
        return edge_combine_reference(hd, hs, pe, receivers, senders)
    if pe.device.type != "cuda":
        raise ValueError(f"edge_combine: unsupported device {pe.device}")
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
    fn = launcher("edge_combine", _SYMBOLS[pe.dtype], _ARGTYPES)
    err = fn(hd.data_ptr(), hs.data_ptr(), pe.data_ptr(),
             receivers.data_ptr(), senders.data_ptr(), out.data_ptr(),
             N, E, D, stream_of(pe))
    check_launch("edge_combine", err)
    edge_combine.launches += 1
    return out


edge_combine.launches = 0
