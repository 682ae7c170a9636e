"""`losses/contrastive.py::uniformity_loss` (the `uniformity` metric and the
`uniformity_reg` tail) on the CPU: its value against a float64
explicit-difference reference at a small shape and at the QMugs cell's
(x2 of 1,500 conformer rows of 256, x1 of 500), -inf on spread-out rows, a
duplicated row, the float64 gradient against the explicit differences,
and its host memory: no single op allocates more than 64 MB at the cell's
shape, where the explicit form allocates 2.3 GB in one subtraction."""
import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from infomax3d_tpu_torch.losses.contrastive import uniformity_loss
from infomax3d_tpu_torch.train.metrics import Uniformity

RTOL = 1e-6  # `test_metric_matches_jax`'s
MAX_OP_BYTES = 64 * 2 ** 20


def _explicit_u(x, t=2.0, rows=16):
    """log mean_{i<j} exp(-t |x_i - x_j|^2) from explicit differences, a
    block of `rows` rows at a time (so float64 at N = 1,500 stays small)."""
    n = x.shape[0]
    terms = []
    for i0 in range(0, n, rows):
        blk = x[i0:i0 + rows]
        sq = ((blk[:, None, :] - x[None, :, :]) ** 2).sum(-1)
        i = torch.arange(i0, i0 + blk.shape[0])[:, None]
        terms.append(torch.exp(-t * sq)[i < torch.arange(n)[None, :]])
    return torch.log(torch.cat(terms).mean())


def _explicit(x1, x2, t=2.0):
    return (_explicit_u(x1, t) + _explicit_u(x2, t)) / 2.0


def _pair(n, d, n1=None, scale=0.05, seed=0, dup=False):
    """x1 [n1, d] near x2's first rows and x2 [n, d] at `scale`, float32;
    with `dup`, a row of each repeated."""
    g = torch.Generator().manual_seed(seed)
    x2 = torch.randn(n, d, generator=g) * scale
    n1 = n if n1 is None else n1
    x1 = x2[:n1] + torch.randn(n1, d, generator=g) * scale / 5
    if dup:
        x1[3], x2[n // 2] = x1[1], x2[0]
    return x1, x2


def _value(x1, x2):
    got = float(Uniformity(t=2)(x1.numpy(), x2.numpy()))
    assert got == float(uniformity_loss(x1, x2))
    want = float(_explicit(x1.double(), x2.double()))
    assert np.isfinite(want)
    assert abs(got - want) <= RTOL * max(abs(want), 1.0), (got, want)


def _spread_out():
    x1, x2 = _pair(20, 8, scale=100.0)
    assert float(uniformity_loss(x1, x2)) == -np.inf
    assert float(Uniformity(t=2)(x1, x2)) == -np.inf


def _gradient():
    a1, a2 = (x.double() for x in _pair(12, 5, n1=6, scale=0.5, dup=True))
    b1, b2 = (x.clone().requires_grad_() for x in (a1, a2))
    c1, c2 = (x.clone().requires_grad_() for x in (a1, a2))
    uniformity_loss(b1, b2).backward()
    _explicit(c1, c2).backward()
    for b, c in ((b1, c1), (b2, c2)):
        assert torch.isfinite(b.grad).all()
        torch.testing.assert_close(b.grad, c.grad, rtol=1e-12, atol=1e-12)


def _memory():
    x1, x2 = _pair(1500, 256, n1=500)
    with profile(activities=[ProfilerActivity.CPU],
                 profile_memory=True) as prof:
        Uniformity(t=2)(x1, x2)
    top = max(prof.events(), key=lambda e: e.cpu_memory_usage)
    assert 0 < top.cpu_memory_usage <= MAX_OP_BYTES, \
        (top.name, top.cpu_memory_usage)


CASES = {
    "value_small": lambda: _value(*_pair(32, 16)),
    "value_cell": lambda: _value(*_pair(1500, 256, n1=500)),
    "duplicated_row": lambda: _value(*_pair(32, 16, dup=True)),
    "spread_out": _spread_out,
    "gradient_float64": _gradient,
    "memory_cell": _memory,
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_uniformity(case):
    CASES[case]()
