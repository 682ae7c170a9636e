"""Plain PyTorch building blocks of the reference: named parameters in one
flat dict, the layers as functions of it, float32 throughout.

`q` is the precision the matrix products' operands are rounded to: the
identity for the reference itself, `fp8` for its control (the nearest
precision below the configuration's bf16)."""
from __future__ import annotations

import math
from typing import Callable, Dict, List, Sequence, Tuple

import torch
import torch.nn.functional as F

Spec = List[Tuple[str, Tuple[int, ...], str, float]]

ACTIVATIONS: Dict[str, Callable] = {
    "relu": F.relu, "silu": F.silu, "none": lambda x: x}


def identity(x: torch.Tensor) -> torch.Tensor:
    return x


def fp8(x: torch.Tensor) -> torch.Tensor:
    """`x` rounded to float8 e4m3 under one per-tensor scale (its largest
    magnitude maps to 448), back in x's dtype; the gradient passes
    straight through to x."""
    amax = x.detach().abs().amax().clamp(min=1e-30)
    scale = 448.0 / amax
    y = (x.detach() * scale).to(torch.float8_e4m3fn).to(x.dtype) / scale
    return x + (y - x.detach())


def bf16(x: torch.Tensor) -> torch.Tensor:
    """`x` rounded to bfloat16, back in x's dtype; the gradient passes
    straight through (a witness in the program's own precision)."""
    return x + (x.detach().to(torch.bfloat16).to(x.dtype) - x.detach())


def mantissa(bits: int):
    """A rounding of a tensor to `bits` explicit mantissa bits (bfloat16
    keeps 7), back in its dtype, the gradient straight through: a witness
    whose forward rounds more or less than the program's."""
    step = 2.0 ** (bits + 1)

    def q(x: torch.Tensor) -> torch.Tensor:
        m, e = torch.frexp(x.detach())
        return x + (torch.ldexp(torch.round(m * step) / step, e) - x.detach())
    return q


def linear_spec(name: str, d_in: int, d_out: int) -> Spec:
    bound = 1.0 / math.sqrt(d_in)
    return [(f"{name}.weight", (d_out, d_in), "uniform", bound),
            (f"{name}.bias", (d_out,), "uniform", bound)]


def batch_norm_spec(name: str, d: int) -> Spec:
    return [(f"{name}.weight", (d,), "ones", 0.0),
            (f"{name}.bias", (d,), "zeros", 0.0),
            (f"{name}.running_mean", (d,), "zeros", 0.0),
            (f"{name}.running_var", (d,), "ones", 0.0),
            (f"{name}.num_batches_tracked", (), "count", 0.0)]


def embedding_spec(name: str, vocab: int, d: int) -> Spec:
    return [(f"{name}.weight", (vocab, d), "uniform",
             math.sqrt(6.0 / (vocab + d)))]


def mlp_layout(d_in: int, d_out: int, layers: int, hidden: int,
               mid_act: str, last_act: str, mid_bn: bool, last_bn: bool):
    """[(d_in, d_out, activation, batch norm)] of each layer of an MLP:
    Linear -> activation -> BatchNorm per layer."""
    dims = [d_in] + [hidden] * (layers - 1) + [d_out]
    n = len(dims) - 1
    return [(dims[j], dims[j + 1], last_act if j == n - 1 else mid_act,
             last_bn if j == n - 1 else mid_bn) for j in range(n)]


def mlp_spec(name: str, layout) -> Spec:
    spec: Spec = []
    for j, (d_in, d_out, _, bn) in enumerate(layout):
        spec += linear_spec(f"{name}.fully_connected.{j}.linear", d_in, d_out)
        if bn:
            spec += batch_norm_spec(f"{name}.fully_connected.{j}.batch_norm",
                                    d_out)
    return spec


class Layers:
    """The layers over the parameters `P` (leaves), the BatchNorm running
    statistics `S` (updated in place) and the operand precision `q`."""

    def __init__(self, P: Dict[str, torch.Tensor], S: Dict[str, torch.Tensor],
                 momentum: float, q: Callable = identity, eps: float = 1e-5):
        self.P, self.S, self.momentum, self.q, self.eps = P, S, momentum, q, eps

    def linear(self, name: str, x: torch.Tensor) -> torch.Tensor:
        return (self.q(x) @ self.q(self.P[f"{name}.weight"]).T
                + self.P[f"{name}.bias"])

    def embed(self, name: str, codes: torch.Tensor) -> torch.Tensor:
        table = self.q(self.P[f"{name}.weight"])
        return table[codes.clamp(0, table.shape[0] - 1)]

    def batch_norm(self, name: str, x: torch.Tensor) -> torch.Tensor:
        """Training-mode BatchNorm over the rows of x (biased variance
        normalizes; the running statistics move by `momentum` towards the
        batch mean and the unbiased variance)."""
        mean = x.mean(dim=0)
        var = x.var(dim=0, unbiased=False)
        y = (x - mean) / torch.sqrt(var + self.eps)
        n = x.shape[0]
        with torch.no_grad():
            m = self.momentum
            rm, rv = (self.S[f"{name}.running_{k}"] for k in ("mean", "var"))
            rm.mul_(1 - m).add_(m * mean)
            rv.mul_(1 - m).add_(m * var * n / max(n - 1, 1))
            self.S[f"{name}.num_batches_tracked"].add_(1)
        return y * self.P[f"{name}.weight"] + self.P[f"{name}.bias"]

    def mlp(self, name: str, layout, x: torch.Tensor) -> torch.Tensor:
        for j, (_, _, act, bn) in enumerate(layout):
            x = ACTIVATIONS[act](self.linear(f"{name}.fully_connected.{j}"
                                             f".linear", x))
            if bn:
                x = self.batch_norm(f"{name}.fully_connected.{j}.batch_norm",
                                    x)
        return x


def scatter_mean(x: torch.Tensor, index: torch.Tensor, n: int,
                 count: torch.Tensor) -> torch.Tensor:
    s = x.new_zeros((n,) + tuple(x.shape[1:])).index_add(0, index, x)
    return s / count.clamp(min=1).to(x.dtype)[:, None]


def scatter_extreme(x: torch.Tensor, index: torch.Tensor, n: int,
                    reduce: str) -> torch.Tensor:
    """Each segment's max ("amax") or min ("amin") of its rows, 0 where it
    has none."""
    idx = index[:, None].expand_as(x)
    return x.new_zeros((n,) + tuple(x.shape[1:])).scatter_reduce(
        0, idx, x, reduce, include_self=False)


def readout(h: torch.Tensor, graph: torch.Tensor, n_graphs: int,
            aggregators: Sequence[str]) -> torch.Tensor:
    """The concat of min / max / mean / sum of each graph's node rows."""
    count = torch.bincount(graph, minlength=n_graphs)
    outs = {"min": lambda: scatter_extreme(h, graph, n_graphs, "amin"),
            "max": lambda: scatter_extreme(h, graph, n_graphs, "amax"),
            "mean": lambda: scatter_mean(h, graph, n_graphs, count),
            "sum": lambda: h.new_zeros(n_graphs, h.shape[1]).index_add(
                0, graph, h)}
    return torch.cat([outs[a]() for a in aggregators], dim=-1)
