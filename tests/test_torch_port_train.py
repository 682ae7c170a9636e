"""The training slice on the CPU: the batcher's backward arrays, the kernel
Functions' gradients against the JAX package's custom VJPs, masked
BatchNorm in training mode, and the whole pre-training step (PNA +
Net3DDense, NT-Xent, Adam) against `bench.py`'s step built the same way,
in float32 and bf16.  Small sizes: PNA hidden 32 x 2 layers, Net3DDense
hidden 8, 16 molecules; every input comes from numpy seeds.

Tolerances, each with its reading on this data (the reason first).  A
leaf's error is its max |port - ref| over its max |ref|; the zero-gradient
leaves (`ZERO_GRADIENT`: a Linear bias or a BatchNorm shift feeding a
BatchNorm with no nonlinearity between, whose gradient the normalization
removes) read their max |port| over the side's largest gradient instead.

* float32 step against the JAX step evaluated in float64 (`_jax_float64`,
  the independent witness): the loss within 1e-5 relative (reading
  1.8e-6); each PNA leaf under the float64 step's output cotangent within
  1e-4 (reading 1.2e-5), zero-gradient leaves below 1e-5 (reading 6.9e-8);
  the running statistics within 1e-5 of each buffer's max on the PNA side
  (reading 7.2e-6).  Three readings rule the 1e-4 / 1e-5 bounds out, all
  from float32 arithmetic at the 3D side: Net3DDense's message BatchNorm
  has mean^2 / var ~1.1e3 in one column, and `var = E[x^2] - mean^2` (the
  JAX package's formula, ported as it is) multiplies float32's rounding by
  that.  So its running variance is held at 1e-4 (reading 4.5e-5; the JAX
  float32 step reads 1.4e-3), its leaves under the float64 cotangent at
  5e-4 (reading 2.3e-4, the sigmoid gate's bias; the JAX float32 step
  1.7e-2), and the whole step's PNA leaves, which get that error through
  the loss's cotangent, at 3e-4 (reading 1.4e-4; JAX float32 4.3e-3).
  The port's Net3DDense run in float64 under the same cotangent is within
  1e-6 of the JAX float64 step, leaves and running statistics (readings
  3.5e-8 and 3.6e-8), so the 3D gap is float32's and not the formula's.
* float32 step against the JAX package's float32 step (`bench.py`'s step
  as it runs): the loss within 1e-4 relative (reading 4.1e-5; the JAX
  step itself is 4.3e-5 off float64), the PNA leaves under the JAX step's
  own cotangent within 3e-4 (reading 2.1e-5), the whole step's PNA
  gradient within 1e-2 (L2, reading 2.5e-3), the running statistics within
  1e-5 (PNA, reading 5.7e-6) and 3e-3 (Net3DDense, reading 1.35e-3, the
  JAX step's own distance from float64).
* bf16 step: the bf16 check (`_bf16_violations`): every leaf has a finite
  gradient, non-zero unless it is a zero-gradient leaf; the zero-gradient
  leaves stay below 2e-2 of the side's max; each PNA leaf within 0.5; each
  side's gradient within 0.35 (L2).  Net3DDense's leaves are held through
  the L2 alone: its bias leaves sum ~10^4 pair terms of both signs, and
  bf16 terms leave 1.1 to 2.5 of such a leaf's max on either side (the
  JAX bf16 step is 2.6 off its float32 one there).  Readings: against the
  JAX bf16 step at 16 molecules, PNA leaf 0.37, zero-gradient 1.6e-3, L2
  0.21 (PNA) and 0.27 (Net3DDense; the JAX bf16 step is 0.22 off its
  float32 one); against the port's float32 step at 64 molecules, PNA leaf
  0.23, zero-gradient 7.2e-3, L2 0.12 and 0.17.  Planted faults at 64
  molecules: zeroed affine cotangents d_a, d_b of the stats backward, or a
  detached (a, b), leave four BatchNorm leaves with no gradient and the
  zero-gradient leaves at 0.12; BatchNorm statistics without gradient read
  PNA leaves up to 3.6, zero-gradient 0.41, L2 0.80 and 5.8.  The bf16
  gap itself is the step's sensitivity to rounding: perturbing the float32
  master weights by 2**-16 relative (below bf16 resolution; it flips the
  rounding of a few weights) moves the bf16 step's PNA gradient by 0.14
  (16 molecules) and 0.09 (64) in L2, where the float32 step moves by
  3e-3 and 1.5e-2.  The loss is held to the JAX bf16 step within 5e-3
  (reading 1.5e-3; JAX bf16 against float32 3.0e-3) and the running
  statistics within 2e-2 of each buffer's max (readings 1.2e-2 and
  8.1e-3).
"""
import contextlib
import dataclasses
import importlib
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from infomax3d_tpu.graphs.batch import BucketSpec as JaxBucket
from infomax3d_tpu.graphs.batch import batch_graphs as jax_batch_graphs
from infomax3d_tpu.graphs.batch import to_graph_batch as jax_graph_batch
from infomax3d_tpu.graphs.dense import dense_batch as jax_dense_batch
from infomax3d_tpu.graphs.dense import to_dense_batch as jax_dense
from infomax3d_tpu.losses import LOSS_REGISTRY
from infomax3d_tpu.models import PNA as JaxPNA
from infomax3d_tpu.models import Net3DDense as JaxNet3D
from infomax3d_tpu.ops.pallas import spmm
from infomax3d_tpu.train.optim import GroupedOptimizer, label_params
from infomax3d_tpu.train.precision import cast_floats
from infomax3d_tpu_torch.data.synthetic import SyntheticMolecules
from infomax3d_tpu_torch.graphs.batch import batch_graphs, bucket_for
from infomax3d_tpu_torch.graphs.dense import dense_batch
from infomax3d_tpu_torch.interop import init_jax_variables, params_from_jax
from infomax3d_tpu_torch.models.base import MaskedBatchNorm
from infomax3d_tpu_torch.ops.kernels import (_build, edge_combine,
                                             multi_reduce, pair_segment_sum,
                                             pair_segment_sum_reference,
                                             pna_stats, pna_stats_bwd,
                                             pna_stats_bwd_reference)
from infomax3d_tpu_torch.ops.kernels import edge_combine as ec_mod
from infomax3d_tpu_torch.ops.kernels.multi_reduce import multi_reduce_bwd
from infomax3d_tpu_torch.train.optim import build_adam
from infomax3d_tpu_torch.train.pretrain import (PretrainStep,
                                                flagship_batches, pretrain)

# the flagship options of configs_clean/pre-train_QM9.yml at a small size
MODEL = dict(target_dim=16, hidden_dim=32, mid_batch_norm=True,
             last_batch_norm=True, readout_batchnorm=True,
             batch_norm_momentum=0.93, readout_hidden_dim=32,
             readout_layers=2, dropout=0.0, propagation_depth=2,
             aggregators=["mean", "max", "min", "std"],
             scalers=["identity", "amplification", "attenuation"],
             readout_aggregators=["min", "max", "mean"], pretrans_layers=2,
             posttrans_layers=1, residual=True)
MODEL3D = dict(target_dim=16, hidden_dim=8, hidden_edge_dim=8,
               node_wise_output_layers=0, message_net_layers=1,
               update_net_layers=1, reduce_func="mean", fourier_encodings=4,
               propagation_depth=1, dropout=0.0, batch_norm=True,
               readout_batchnorm=True, batch_norm_momentum=0.93,
               readout_hidden_dim=8, readout_layers=1,
               readout_aggregators=["min", "max", "mean"])
B = 16
DATA = dict(seed=0, n_min=10, n_max=26)
D = 24


def _t(x):
    return torch.from_numpy(np.array(x))


def _bf16(x):
    return np.asarray(jnp.asarray(x, jnp.bfloat16).astype(jnp.float32))


@pytest.fixture(scope="module")
def mols():
    ds = SyntheticMolecules(B, **DATA)
    return ([ds.graph2d(i) for i in range(B)],
            [ds.graph3d(i) for i in range(B)])


@pytest.fixture(scope="module")
def csr(mols):
    graphs = mols[0]
    b = bucket_for(graphs, B)
    jarr = jax_batch_graphs(graphs, JaxBucket(
        b.n_graphs, b.n_nodes, b.n_edges, max_deg=b.max_deg, csr=True,
        nmax=b.nmax))
    return batch_graphs(graphs, b), b, jarr


# --- the batches ------------------------------------------------------------

def test_csc_arrays_match_jax_batcher(csr):
    arr, _, jarr = csr
    for key in ("csc_perm", "csc_row_ptr", "csr_row_ptr", "senders",
                "receivers", "csr_pos"):
        assert arr[key].dtype == jarr[key].dtype, key
        np.testing.assert_array_equal(arr[key], jarr[key], err_msg=key)
    # the sender ranges of csc_perm hold exactly each node's sent edges
    N = len(arr["csc_row_ptr"]) - 1
    perm, ptr, snd = arr["csc_perm"], arr["csc_row_ptr"], arr["senders"]
    for n in range(0, N, 7):
        np.testing.assert_array_equal(snd[perm[ptr[n]:ptr[n + 1]]], n)


def test_dense_3d_batch_matches_jax(mols):
    from infomax3d_tpu.data.synthetic import SyntheticMolecules as JaxMols
    jds = JaxMols(B, **DATA)
    for i, m in enumerate(mols[1]):
        j = jds.graph3d(i)
        for key in ("coords", "edge_dist", "senders", "receivers"):
            np.testing.assert_array_equal(m[key], j[key], err_msg=key)
    nmax = max(m["node_feat"].shape[0] for m in mols[1])
    got = dense_batch(mols[1], B + 2, nmax)
    want = jax_dense_batch(mols[1], B + 2, nmax, with_edges=False)
    assert set(got) == set(want)
    for key in want:
        assert got[key].dtype == want[key].dtype, key
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)


# --- the Functions against the JAX package's custom VJPs -------------------

def _jnp(arr, *keys):
    return [jnp.asarray(arr[k]) for k in keys]


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_edge_combine_grad_matches_jax_vjp(csr, dtype):
    """Gradients of the combine against `jax.vjp` of `csr_edge_combine`
    (on the CPU its backward is `sorted_segment_sum`: float32 prefix-sum
    differences).  d_pe is the cotangent itself; d_hd, d_hs agree to 1e-5
    relative in float32 and to 2**-7 (one bf16 ulp at the max) in bf16,
    where a prefix difference can round to the neighbouring bf16 value."""
    arr, b, jarr = csr
    N, E, K = b.n_nodes, b.n_edges, b.max_deg
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    rng = np.random.default_rng(11)
    hd, hs = (_bf16(rng.normal(size=(N, D))) for _ in range(2))
    pe, ct = (_bf16(rng.normal(size=(E, D))) for _ in range(2))
    recv, send, rp, crp, perm, pb = _jnp(
        jarr, "receivers", "senders", "csr_row_ptr", "csc_row_ptr",
        "csc_perm", "csr_pair_base")

    def f(a, s, p):
        return spmm.csr_edge_combine(a, s, p, recv, send, rp, crp, perm, pb,
                                     K, 0, 0, 0, True,
                                     jarr["csr_pair_win"].shape[0])

    _, vjp = jax.vjp(f, *(jnp.asarray(x, jdt) for x in (hd, hs, pe)))
    want = vjp(jnp.asarray(ct, jdt))
    xs = [_t(x).to(tdt).requires_grad_() for x in (hd, hs, pe)]
    z = edge_combine(*xs, _t(arr["receivers"]), _t(arr["senders"]),
                     _t(arr["csr_row_ptr"]), _t(arr["csc_row_ptr"]),
                     _t(arr["csc_perm"]))
    z.backward(_t(ct).to(tdt))
    tol = 2.0 ** -7 if dtype == "bfloat16" else 1e-5
    for name, x, w in zip(("d_hd", "d_hs", "d_pe"), xs, want):
        w = np.asarray(w, np.float32)
        g = x.grad.float().numpy()
        assert np.abs(g - w).max() <= tol * np.abs(w).max(), name
    np.testing.assert_array_equal(xs[2].grad.float().numpy(), ct)


@pytest.mark.parametrize("want_sum", [True, False])
def test_pna_stats_grad_matches_jax_vjp(csr, want_sum):
    """Gradients of the bf16 stats (with the folded affine) against
    `jax.vjp` of `csr_pna_stats`.  On the CPU the JAX package runs its XLA
    fallback backward, which rounds to bf16 after each operation and sums
    the affine cotangents of the bf16-rounded d; the port rounds where the
    TPU's Pallas kernel does (bit-equal to it in
    tests/test_torch_port_kernels.py).  Measured: d_x 7.6e-3, d_a / d_b
    3.0e-3 of max|ref|; held to 1e-2."""
    arr, b, jarr = csr
    N, E, K = b.n_nodes, b.n_edges, b.max_deg
    rng = np.random.default_rng(12)
    x = _bf16(rng.normal(size=(E, D)) * 2.0)
    a = rng.uniform(0.5, 1.5, D).astype(np.float32)
    s = rng.normal(0.0, 0.3, D).astype(np.float32)
    cts = [_bf16(rng.normal(size=(N, D))) for _ in range(5)]
    recv, rp, pos = _jnp(jarr, "receivers", "csr_row_ptr", "csr_pos")

    def f(m, aa, ss):
        return spmm.csr_pna_stats(m, rp, recv, pos, K, True, 0,
                                  jarr["csr_bwd_span"].shape[0], want_sum,
                                  (aa, ss))

    _, vjp = jax.vjp(f, jnp.asarray(x, jnp.bfloat16), jnp.asarray(a),
                     jnp.asarray(s))
    jcts = [jnp.asarray(c, jnp.bfloat16) for c in cts]
    if not want_sum:              # the rebuilt sum is not read: no cotangent
        jcts[0] = jnp.zeros_like(jcts[0])
    want = vjp(tuple(jcts))
    tx = _t(x).bfloat16().requires_grad_()
    ta, ts = _t(a).requires_grad_(), _t(s).requires_grad_()
    outs = pna_stats(tx, _t(arr["csr_row_ptr"]), K, (ta, ts), want_sum)
    assert outs[5].requires_grad is False             # enc has no gradient
    sum((o.float() * _t(c)).sum() for o, c in zip(outs[:5], cts)
        if o is not None).backward()
    for name, g, w in (("d_x", tx.grad, want[0]), ("d_a", ta.grad, want[1]),
                       ("d_b", ts.grad, want[2])):
        w = np.asarray(w, np.float32)
        assert np.abs(g.float().numpy() - w).max() <= 1e-2 * np.abs(w).max(), \
            name


def test_multi_reduce_grad_matches_jax_vjp(csr):
    """float32: the plain backward is the JAX package's `_bwd` formula —
    every tie of the max / min gets the full cotangent (messages rounded to
    integers make ties): equal."""
    arr, b, jarr = csr
    N, E, K = b.n_nodes, b.n_edges, b.max_deg
    rng = np.random.default_rng(13)
    x = rng.normal(size=(E, D)).astype(np.float32)
    x[::3] = np.round(x[::3])
    cts = [rng.normal(size=(N, D)).astype(np.float32) for _ in range(4)]
    recv, rp = _jnp(jarr, "receivers", "csr_row_ptr")
    _, vjp = jax.vjp(lambda m: spmm.csr_multi_reduce(m, rp, recv, K, True),
                     jnp.asarray(x))
    want = np.asarray(vjp(tuple(jnp.asarray(c) for c in cts))[0])
    tx = _t(x).requires_grad_()
    outs = multi_reduce(tx, _t(arr["csr_row_ptr"]), K,
                        receivers=_t(arr["receivers"]))
    sum((o * _t(c)).sum() for o, c in zip(outs, cts)).backward()
    np.testing.assert_allclose(tx.grad.numpy(), want, rtol=1e-6, atol=1e-6)
    assert np.abs(want).max() > 0


def _csr_torch(arr):
    return {k: _t(arr[k]) for k in ("receivers", "senders", "csr_row_ptr",
                                    "csc_row_ptr", "csc_perm")}


def test_functions_pass_their_backward_twins(csr):
    """Each Function's gradient is its backward twin's output on the
    incoming cotangent, exactly, and is non-zero: the CPU path runs the
    backward the card runs."""
    arr, b, _ = csr
    g = _csr_torch(arr)
    N, E, K = b.n_nodes, b.n_edges, b.max_deg
    gen = torch.Generator().manual_seed(0)
    randn = lambda *s: torch.randn(*s, generator=gen)  # noqa: E731

    hd, hs, pe = (randn(N, D).requires_grad_(), randn(N, D).requires_grad_(),
                  randn(E, D).requires_grad_())
    ct = randn(E, D)
    edge_combine(hd, hs, pe, g["receivers"], g["senders"], g["csr_row_ptr"],
                 g["csc_row_ptr"], g["csc_perm"]).backward(ct)
    want = pair_segment_sum_reference(ct, g["csr_row_ptr"],
                                      g["csc_row_ptr"], g["csc_perm"])
    for got, w in ((hd.grad, want[0]), (hs.grad, want[1]), (pe.grad, ct)):
        assert torch.equal(got, w) and got.abs().max() > 0

    x = randn(E, D).bfloat16().requires_grad_()
    a, s = (torch.rand(D, generator=gen) + 0.5).requires_grad_(), \
        randn(D).requires_grad_()
    outs = pna_stats(x, g["csr_row_ptr"], K, (a, s), False)
    cts = [randn(N, D).bfloat16() for _ in range(4)]
    torch.autograd.backward(outs[1:5], cts)
    mean, std, enc = outs[1].detach(), outs[2].detach(), outs[5]
    want = pna_stats_bwd_reference(x.detach(), g["csr_row_ptr"], K, mean,
                                   std, enc, None, *cts,
                                   (a.detach(), s.detach()))
    for got, w in zip((x.grad, a.grad, s.grad), want):
        assert torch.equal(got, w) and got.float().abs().max() > 0

    x = randn(E, D).requires_grad_()
    outs = multi_reduce(x, g["csr_row_ptr"], K, receivers=g["receivers"])
    cts = [randn(N, D) for _ in range(4)]
    torch.autograd.backward(outs, cts)
    want = multi_reduce_bwd(x.detach(), g["receivers"], outs[2].detach(),
                            outs[3].detach(), cts)
    assert torch.equal(x.grad, want) and want.abs().max() > 0


def test_cuda_paths_refuse_grad_outside_their_function(csr, monkeypatch):
    """With the device check stubbed to take the CUDA path on CPU tensors:
    a raw launch given a tensor that requires grad raises before anything
    is built; the wrappers launch inside their Functions (grad mode off)
    and reach the launcher — forward and backward kernels alike."""
    import importlib
    arr, b, _ = csr
    g = _csr_torch(arr)
    N, E, K = b.n_nodes, b.n_edges, b.max_deg
    monkeypatch.setattr(_build, "on_card", lambda t, name: True)
    mods = {n: importlib.import_module(f"infomax3d_tpu_torch.ops.kernels.{n}")
            for n in ("edge_combine", "pna_stats", "multi_reduce",
                      "pair_segment_sum", "pna_stats_bwd")}
    x = torch.zeros(E, D, requires_grad=True)
    xb = torch.zeros(E, D, dtype=torch.bfloat16, requires_grad=True)
    nd = torch.zeros(N, D, requires_grad=True)
    nd_b = torch.zeros(N, D, dtype=torch.bfloat16)
    raw = {
        "edge_combine": lambda: mods["edge_combine"]._launch(
            nd, nd, x, g["receivers"], g["senders"]),
        "pna_stats": lambda: mods["pna_stats"]._launch(
            xb, g["csr_row_ptr"], K, None, True),
        "multi_reduce": lambda: mods["multi_reduce"]._launch(
            x, g["csr_row_ptr"], K),
        "pair_segment_sum": lambda: mods["pair_segment_sum"]._launch(
            x, g["csr_row_ptr"], g["csc_row_ptr"], g["csc_perm"]),
        "pna_stats_bwd": lambda: mods["pna_stats_bwd"]._launch(
            xb, g["csr_row_ptr"], K, nd_b, nd_b, nd_b, (None, nd_b) * 2 +
            (nd_b,), None),
    }
    for name, call in raw.items():
        with pytest.raises(RuntimeError, match="not differentiable"):
            call()

    launched = []

    def fake_launcher(name, symbol, argtypes):
        return lambda *args: launched.append(symbol) or 0

    for m in mods.values():
        monkeypatch.setattr(m, "launcher", fake_launcher)
        monkeypatch.setattr(m, "stream_of", lambda t: 0)
    z = edge_combine(nd, nd, x, g["receivers"], g["senders"],
                     g["csr_row_ptr"], g["csc_row_ptr"], g["csc_perm"])
    z.sum().backward()
    outs = pna_stats(xb, g["csr_row_ptr"], K, None, True)
    sum(o.float().sum() for o in outs[:5]).backward()
    outs = multi_reduce(x, g["csr_row_ptr"], K, receivers=g["receivers"])
    sum(o.sum() for o in outs).backward()
    assert launched == ["edge_combine_f32", "pair_segment_sum_f32",
                        "pna_stats_bf16", "pna_stats_bwd_bf16",
                        "multi_reduce_f32"]
    with_affine = pna_stats(xb, g["csr_row_ptr"], K,
                            (torch.ones(D, requires_grad=True),
                             torch.zeros(D)), True)
    launched.clear()
    with_affine[1].float().sum().backward()
    assert launched == ["pna_stats_bwd_bf16"]    # one launch, nothing else
    assert ec_mod.launches >= 1 and pair_segment_sum.launches >= 1
    assert pna_stats_bwd.launches >= 1


# --- MaskedBatchNorm in training mode ----------------------------------------

@pytest.mark.parametrize("affine_out", [False, True])
def test_masked_batch_norm_training_matches_jax(affine_out):
    """Output (or the (a, b) affine), the gradients through the batch
    statistics, and the updated running statistics against the JAX
    module with ``mutable=["batch_stats"]``: float32, 1e-5."""
    from infomax3d_tpu.models.base import MaskedBatchNorm as JaxBN
    rng = np.random.default_rng(14)
    x = (rng.normal(size=(40, 6)) * 1.5 + 0.7).astype(np.float32)
    mask = rng.random(40) < 0.7
    scale = rng.uniform(0.5, 1.5, 6).astype(np.float32)
    bias = rng.normal(0, 0.2, 6).astype(np.float32)
    rm = rng.normal(0, 0.2, 6).astype(np.float32)
    rv = rng.uniform(0.5, 2.0, 6).astype(np.float32)
    w = rng.normal(size=(40, 6)).astype(np.float32)
    bn = JaxBN(momentum=0.93, affine_out=affine_out)
    stats = {"mean": jnp.asarray(rm), "var": jnp.asarray(rv)}

    def jf(xx, sc, bi):
        out, mut = bn.apply({"params": {"scale": sc, "bias": bi},
                             "batch_stats": stats}, xx, jnp.asarray(mask),
                            mutable=["batch_stats"])
        y = xx * out[0] + out[1] if affine_out else out
        return (y * w).sum(), (y, mut["batch_stats"])

    (_, (want_y, want_st)), want_g = jax.value_and_grad(
        jf, argnums=(0, 1, 2), has_aux=True)(
        jnp.asarray(x), jnp.asarray(scale), jnp.asarray(bias))
    m = MaskedBatchNorm(6, momentum=0.93).train()
    with torch.no_grad():
        m.weight.copy_(_t(scale))
        m.bias.copy_(_t(bias))
        m.running_mean.copy_(_t(rm))
        m.running_var.copy_(_t(rv))
    tx = _t(x).requires_grad_()
    if affine_out:
        a, b = m.affine(tx, _t(mask))
        y = tx * a + b
    else:
        y = m(tx, _t(mask))
    (y * _t(w)).sum().backward()
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(want_y),
                               rtol=1e-5, atol=1e-5)
    for got, ref in ((tx.grad, want_g[0]), (m.weight.grad, want_g[1]),
                     (m.bias.grad, want_g[2])):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5,
                                   atol=1e-5)
    np.testing.assert_allclose(m.running_mean.numpy(),
                               np.asarray(want_st["mean"]), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(m.running_var.numpy(),
                               np.asarray(want_st["var"]), rtol=1e-5,
                               atol=1e-6)
    assert int(m.num_batches_tracked) == 1
    # eval mode normalizes with the running statistics and updates nothing
    m.eval()
    before = m.running_mean.clone()
    m(tx.detach(), _t(mask))
    assert torch.equal(m.running_mean, before)


# --- the whole step ---------------------------------------------------------

def _variables():
    p2, s2 = init_jax_variables(MODEL, 1)
    p3, s3 = init_jax_variables(MODEL3D, 2, "Net3DDense")
    return {"model": {"params": p2, "batch_stats": s2},
            "model3d": {"params": p3, "batch_stats": s3}}


def _jax_step(mols, variables, cdt):
    """`bench.py`'s step (value_and_grad of the loss through both models,
    batch statistics mutable), built the same way at this size.  Its
    outputs are cast to float32 with astype: `bench.py`'s `_out` is
    `cast_floats(z, float32)`, which only casts float32 leaves, so there a
    bf16 output reaches NT-Xent in bf16 (a fault of the reference, see
    ROADMAP.md); the port follows the recipe's stated float32 loss.  With
    `cdt` float64 (inside `_jax_float64`) everything, the loss included,
    runs in float64.  Returns the loss, the gradients and the running
    statistics, named as the port's state_dict (through
    `params_from_jax`), and the cotangents of the two models' outputs."""
    graphs, mols3 = mols
    b = bucket_for(graphs, B)
    g2 = jax_graph_batch(jax_batch_graphs(graphs, JaxBucket(
        B, b.n_nodes, b.n_edges, max_deg=b.max_deg, csr=True, nmax=b.nmax)))
    nmax = max(m["node_feat"].shape[0] for m in mols3)
    g3 = jax_dense(jax_dense_batch(mols3, B, nmax, with_edges=False))
    pna, net3d = JaxPNA(**MODEL), JaxNet3D(**{
        k: v for k, v in MODEL3D.items() if k != "hidden_edge_dim"})
    loss_obj = LOSS_REGISTRY["NTXent"](tau=0.1)
    out_dt = jnp.float64 if cdt == jnp.float64 else jnp.float32
    if cdt is None:
        cin = lambda t: t  # noqa: E731
    elif cdt == jnp.float64:
        cin = lambda t: jax.tree_util.tree_map(  # noqa: E731
            lambda x: x.astype(jnp.float64) if isinstance(x, jax.Array)
            and x.dtype == jnp.float32 else x, t)
    else:
        cin = lambda t: cast_floats(t, cdt)  # noqa: E731
    tree = lambda k: jax.tree_util.tree_map(  # noqa: E731
        jnp.asarray, {m: variables[m][k] for m in variables})
    params, stats = tree("params"), tree("batch_stats")
    g2c, g3c = cin(g2), cin(g3)

    def lf(p, z1_probe, z2_probe):
        pc = cin(p)
        z1, m2 = pna.apply({"params": pc["model"],
                            "batch_stats": stats["model"]}, g2c,
                           deterministic=False, mutable=["batch_stats"])
        z2, m3 = net3d.apply({"params": pc["model3d"],
                              "batch_stats": stats["model3d"]}, g3c,
                             deterministic=False, mutable=["batch_stats"])
        return loss_obj(z1.astype(out_dt) + z1_probe,
                        z2.astype(out_dt) + z2_probe), (m2, m3)

    zero = jnp.zeros((B, 16), out_dt)
    (loss, (m2, m3)), (grads, dz1, dz2) = jax.value_and_grad(
        lf, argnums=(0, 1, 2), has_aux=True)(params, zero, zero)
    np_dt = np.float64 if out_dt == jnp.float64 else np.float32
    to_np = lambda t: jax.tree_util.tree_map(  # noqa: E731
        lambda v: np.asarray(v, np_dt), t)
    out = {}
    for k, st in (("model", m2), ("model3d", m3)):
        sd = params_from_jax(to_np(grads[k]), to_np(st["batch_stats"]))
        out.update({f"{k}.{n}": v.numpy() for n, v in sd.items()
                    if "num_batches" not in n})
    return float(loss), out, (np.asarray(dz1), np.asarray(dz2))


@contextlib.contextmanager
def _jax_float64():
    """The JAX package evaluated in float64, as an independent witness of
    the float32 step: x64 on, and every one of its modules reads
    `jnp.float32` (the dtype its BatchNorm statistics, segment sums and
    casts pin) as float64 while the block runs.  No file changes."""
    class _F64(types.ModuleType):
        def __getattr__(self, name):
            return jnp.float64 if name == "float32" else getattr(jnp, name)

    f64 = _F64("jax.numpy in float64")
    patched = [(m, a) for n, m in list(sys.modules.items())
               if n.startswith("infomax3d_tpu.") for a in ("jnp", "_jnp")
               if getattr(m, a, None) is jnp]
    for m, a in patched:
        setattr(m, a, f64)
    try:
        with jax.enable_x64(True):
            yield
    finally:
        for m, a in patched:
            setattr(m, a, jnp)


def _port_step(variables, dtype, n=B):
    step = PretrainStep(MODEL, MODEL3D, variables, "cpu", dtype,
                        {"tau": 0.1}, {"lr": 8e-5})
    g2, g3, _ = flagship_batches(n, **DATA)
    g2, g3 = step.prepare(g2, g3)
    loss = step.loss_and_grads(g2, g3)
    out = {n: None if p.grad is None else p.grad.numpy().copy()
           for n, p in step.named_parameters()}
    for pre, m in (("model", step.model), ("model3d", step.model3d)):
        out.update({f"{pre}.{n}": v.numpy().copy()
                    for n, v in m.named_buffers() if "running" in n})
    return float(loss), out, step, (g2, g3)


@pytest.fixture(scope="module")
def steps(mols):
    variables = _variables()
    return {"variables": variables,
            "jax32": _jax_step(mols, variables, None),
            "jax16": _jax_step(mols, variables, jnp.bfloat16),
            "jax64": _jax64_step(mols, variables),
            "port32": _port_step(variables, None),
            "port16": _port_step(variables, torch.bfloat16)}


def _jax64_step(mols, variables):
    with _jax_float64():
        return _jax_step(mols, variables, jnp.float64)


def _grad_keys(ref, side):
    return [k for k in ref if k.startswith(side + ".")
            and "running" not in k]


def _l2(a, b, keys):
    fa = np.concatenate([a[k].ravel() for k in keys])
    fb = np.concatenate([b[k].ravel() for k in keys])
    return float(np.linalg.norm(fa - fb) / np.linalg.norm(fb))


# Leaves with an exactly zero gradient: a Linear bias or a BatchNorm shift
# that feeds a BatchNorm with no nonlinearity between.
ZERO_GRADIENT = ("pretrans.fully_connected.0.batch_norm.bias",
                 "pretrans.fully_connected.1.linear.bias",
                 "posttrans.fully_connected.0.linear.bias",
                 "update_network.fully_connected.0.linear.bias")


def _leaf_errors(got, ref, keys):
    """Each leaf's max |got - ref| over its max |ref|; a zero-gradient
    leaf reads its max |got| over the largest gradient of `keys`."""
    gmax = max(np.abs(ref[k]).max() for k in keys)
    return {k: (np.abs(got[k]).max() / gmax if k.endswith(ZERO_GRADIENT)
                else np.abs(got[k] - ref[k]).max() / np.abs(ref[k]).max())
            for k in keys}


def _hold_leaves(got, ref, keys, tol, zero_tol):
    errs = _leaf_errors(got, ref, keys)
    for k, e in errs.items():
        assert e <= (zero_tol if k.endswith(ZERO_GRADIENT) else tol), (k, e)


def _backward_under(model, g, ct, prefix):
    """A copy of `model`'s gradients for the output cotangent `ct`, named
    ``prefix.<parameter>``."""
    import copy
    net = copy.deepcopy(model)
    net.zero_grad()
    net(g).backward(ct)
    return {f"{prefix}.{n}": p.grad.numpy().copy()
            for n, p in net.named_parameters()}


def test_step_f32_matches_jax(steps):
    """The port's float32 step against the JAX package's float32 step (the
    tolerances and readings are in the module docstring)."""
    jl, jg, (jdz1, _) = steps["jax32"]
    pl, pg, step, (g2, _) = steps["port32"]
    assert abs(pl - jl) <= 1e-4 * abs(jl)
    assert set(pg) == set(jg)
    for k in jg:
        if "running" in k:
            tol = 1e-5 if k.startswith("model.") else 3e-3
            assert np.abs(pg[k] - jg[k]).max() <= tol * np.abs(jg[k]).max(), k
    # the 2D side under the JAX step's own cotangent, leaf by leaf
    keys2 = _grad_keys(jg, "model")
    _hold_leaves(_backward_under(step.model, g2, _t(jdz1), "model"), jg,
                 keys2, 3e-4, 1e-5)
    # and the whole step's 2D gradient, through the port's own cotangent
    assert _l2(pg, jg, keys2) <= 1e-2


def test_step_f32_matches_jax_float64(steps):
    """The port's float32 step against the JAX package's step evaluated in
    float64 (`_jax_float64`), an independent witness of the exact step (the
    tolerances and readings are in the module docstring)."""
    jl, jg, (jdz1, jdz2) = steps["jax64"]
    pl, pg, step, (g2, g3) = steps["port32"]
    assert abs(pl - jl) <= 1e-5 * abs(jl)
    for k in jg:
        if "running" in k:
            tol = 1e-5 if k.startswith("model.") else 1e-4
            assert np.abs(pg[k] - jg[k]).max() <= tol * np.abs(jg[k]).max(), k
    keys2, keys3 = _grad_keys(jg, "model"), _grad_keys(jg, "model3d")
    # PNA under the float64 step's cotangent, and in the whole step
    _hold_leaves(_backward_under(step.model, g2, _t(jdz1).float(), "model"),
                 jg, keys2, 1e-4, 1e-5)
    _hold_leaves(pg, jg, keys2, 3e-4, 1e-5)
    # Net3DDense in float32 under the float64 step's cotangent, and the
    # port's own Net3DDense run in float64 (fresh running statistics)
    _hold_leaves(_backward_under(step.model3d, g3, _t(jdz2).float(),
                                 "model3d"), jg, keys3, 5e-4, 1e-5)
    net64 = PretrainStep(MODEL, MODEL3D, steps["variables"], "cpu", None,
                         {"tau": 0.1}, {"lr": 8e-5}).model3d.double()
    net64(dataclasses.replace(g3, coords=g3.coords.double())).backward(
        _t(jdz2))
    got64 = {f"model3d.{n}": p.grad.numpy()
             for n, p in net64.named_parameters()}
    _hold_leaves(got64, jg, keys3, 1e-6, 1e-6)
    for n, v in net64.named_buffers():
        if "running" in n:
            ref = jg[f"model3d.{n}"]
            assert np.abs(v.numpy() - ref).max() <= 1e-6 * np.abs(ref).max(), n


# The bf16 check: a bf16 step's gradients held to a reference step's (see
# the module docstring for the readings these bounds sit between).
BF16_ZERO_FLOOR = 2e-2     # zero-gradient leaves, of the side's max
BF16_LEAF = 0.5            # each other PNA leaf, of its own max
BF16_L2 = 0.35             # each side's gradient, L2


def _bf16_violations(got, ref):
    """What `got` (a bf16 step's gradients and statistics) breaks of the
    bf16 check against `ref`: a leaf without a finite gradient, a zero
    gradient where the leaf has one, a zero-gradient leaf above
    BF16_ZERO_FLOOR, a PNA leaf off by more than BF16_LEAF, a side's L2
    above BF16_L2."""
    bad = []
    for side in ("model", "model3d"):
        keys = _grad_keys(ref, side)
        missing = [k for k in keys if got[k] is None
                   or not np.isfinite(got[k]).all()
                   or not (k.endswith(ZERO_GRADIENT)
                           or np.abs(got[k]).max() > 0)]
        if missing:
            bad += [f"{k}: no finite non-zero gradient" for k in missing]
            continue
        for k, e in _leaf_errors(got, ref, keys).items():
            if k.endswith(ZERO_GRADIENT):
                if e > BF16_ZERO_FLOOR:
                    bad.append(f"{k}: zero-gradient leaf at {e:.3g}")
            elif side == "model" and e > BF16_LEAF:
                bad.append(f"{k}: {e:.3g}")
        l2 = _l2(got, ref, [k for k in keys
                            if not k.endswith(ZERO_GRADIENT)])
        if l2 > BF16_L2:
            bad.append(f"{side}: L2 {l2:.3g}")
    return bad


def test_step_bf16_matches_jax(steps):
    """The port's bf16 step against the JAX package's bf16 step: the loss,
    the running statistics and the bf16 check (module docstring)."""
    jl, jg, _ = steps["jax16"]
    pl, pg, _, _ = steps["port16"]
    assert abs(pl - jl) <= 5e-3 * abs(jl)
    for k in jg:
        if "running" in k:
            assert np.abs(pg[k] - jg[k]).max() <= \
                2e-2 * np.abs(jg[k]).max(), k
    assert _bf16_violations(pg, jg) == []


def _plant(monkeypatch, fault):
    """Break the bf16 step the way `fault` names."""
    if fault == "zeroed d_a, d_b":
        # the stats backward's affine cotangents
        mod = importlib.import_module(
            "infomax3d_tpu_torch.ops.kernels.pna_stats")
        real = mod.pna_stats_bwd

        def zeroed(*args):
            d_x, d_a, d_b = real(*args)
            return d_x, *(None if d is None else torch.zeros_like(d)
                          for d in (d_a, d_b))
        monkeypatch.setattr(mod, "pna_stats_bwd", zeroed)
    elif fault == "detached (a, b)":
        # the folded pretrans BatchNorm reaches the stats without gradient
        mod = importlib.import_module("infomax3d_tpu_torch.ops.aggregate")
        real = mod.pna_stats

        def detached(x, row_ptr, max_deg, affine, *args, **kw):
            return real(x, row_ptr, max_deg, affine and tuple(
                t.detach() for t in affine), *args, **kw)
        monkeypatch.setattr(mod, "pna_stats", detached)
    elif fault == "statistics without gradient":
        real = MaskedBatchNorm._statistics
        monkeypatch.setattr(MaskedBatchNorm, "_statistics", lambda *a: tuple(
            t.detach() for t in real(*a)))


@pytest.fixture(scope="module")
def steps64():
    variables = _variables()
    return variables, _port_step(variables, None, 64)[1]


@pytest.mark.parametrize("fault", [None, "zeroed d_a, d_b", "detached (a, b)",
                                   "statistics without gradient"])
def test_step_bf16_check_against_f32(steps64, monkeypatch, fault):
    """The bf16 check holds the port's bf16 step to its float32 step at 64
    molecules, and fails on each planted fault of the bf16 composition."""
    variables, ref = steps64
    _plant(monkeypatch, fault)
    bad = _bf16_violations(_port_step(variables, torch.bfloat16, 64)[1], ref)
    if fault is None:
        assert bad == []
    else:
        assert bad, fault


def _perturbed(variables, rel, seed=7):
    """`variables` with every parameter scaled by 1 + rel * U(-1, 1)."""
    rng = np.random.default_rng(seed)

    def scale(v):
        v = np.asarray(v, np.float32)
        return (v * (1 + rel * rng.uniform(-1, 1, v.shape))).astype(
            np.float32)
    return {m: {"params": jax.tree_util.tree_map(scale, tr["params"]),
                "batch_stats": tr["batch_stats"]}
            for m, tr in variables.items()}


def test_step_bf16_gap_is_rounding_sensitivity(steps64):
    """The witness for the bf16 gap: master weights perturbed by 2**-16
    relative (below bf16 resolution) move the bf16 step's PNA gradient by
    a sizeable share of its distance from the float32 step (reading 0.088
    of 0.12, L2), and the float32 step's by far less (0.015)."""
    variables, ref = steps64
    keys = [k for k in _grad_keys(ref, "model")
            if not k.endswith(ZERO_GRADIENT)]
    moved = {}
    for dt in (torch.bfloat16, None):
        base = ref if dt is None else _port_step(variables, dt, 64)[1]
        moved[dt] = _l2(_port_step(_perturbed(variables, 2.0 ** -16), dt,
                                   64)[1], base, keys)
    gap = _l2(_port_step(variables, torch.bfloat16, 64)[1], ref, keys)
    assert moved[torch.bfloat16] >= gap / 3, (moved, gap)
    assert moved[None] <= moved[torch.bfloat16] / 4, moved


def test_adam_update_matches_grouped_optimizer(steps):
    """One Adam step from the same gradients: the port's torch.optim.Adam
    groups against `GroupedOptimizer.update` (lr 8e-5 on both groups);
    float32, 1e-6 of each parameter's max.  The BatchNorm parameters form
    the first group, as in the JAX package's `label_params`."""
    variables = steps["variables"]
    _, pg, step, _ = steps["port32"]
    params = {m: jax.tree_util.tree_map(jnp.asarray, variables[m]["params"])
              for m in ("model", "model3d")}
    grads = {}
    for m in ("model", "model3d"):
        # port gradients back onto the flax tree, through the JAX package's
        # own torch-name converter
        from flax import traverse_util
        from infomax3d_tpu.train.torch_interop import convert_state_dict
        flat = traverse_util.flatten_dict(variables[m]["params"])
        sd = {n[len(m) + 1:]: v for n, v in pg.items()
              if n.startswith(m + ".") and "running" not in n}
        out, _, report = convert_state_dict(sd, flat, {})
        assert report["missing"] == []
        grads[m] = traverse_util.unflatten_dict(
            {k: jnp.asarray(v) for k, v in out.items()})
    labels, active = label_params(params)
    assert active == ["batch_norm", "new"]
    opt = GroupedOptimizer(labels, name="Adam", lr=8e-5)
    state = opt.init(params)
    lrs = np.zeros(4, np.float32)
    lrs[:2] = 8e-5
    upd, _ = opt.update(grads, state, params, lrs)
    want = params_from_jax(jax.tree_util.tree_map(
        lambda p, u: np.asarray(p + u), params["model"], upd["model"]), {})
    assert [gr["name"] for gr in step.optimizer.param_groups] == \
        ["batch_norm", "new"]
    step.optimizer.step()
    got = dict(step.model.named_parameters())
    for n, w in want.items():
        w = w.numpy()
        assert np.abs(got[n].detach().numpy() - w).max() <= \
            1e-6 * max(np.abs(w).max(), 1.0), n


def test_weight_decay_skips_batch_norm():
    lin, bn = torch.nn.Linear(3, 3), MaskedBatchNorm(3)
    opt = build_adam([("l.weight", lin.weight), ("x.batch_norm.weight",
                                                 bn.weight)],
                     lr=1e-3, weight_decay=0.1)
    assert [(g["name"], g["weight_decay"]) for g in opt.param_groups] == \
        [("batch_norm", 0.0), ("new", 0.1)]


def test_pretrain_entry_point_on_cpu():
    """`pretrain()` trains the pair on the CPU when asked: finite losses
    that fall over 8 steps (lr 1e-3), the running statistics move, and
    without `device` it needs the card."""
    args = dict(model_parameters=MODEL, model3d_parameters=MODEL3D,
                loss_params={"tau": 0.1}, optimizer_params={"lr": 1e-3},
                batch_size=B, dataset_params=DATA, bf16_compute=False)
    out = pretrain(args, steps=8, device="cpu")
    losses = out["losses"]
    assert len(losses) == 8 and np.isfinite(losses).all()
    assert losses[-1] < losses[0]
    bn = out["step"].model.output.fully_connected[0].batch_norm
    assert int(bn.num_batches_tracked) == 8
    assert out["sizes"]["edges_3d"] == sum(
        n * (n - 1) for n in (m["node_feat"].shape[0]
                              for m in SyntheticMolecules(B, **DATA).mols))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            pretrain(args, steps=1)


def test_readout_regroup_gradient_is_the_inverse_gather(csr):
    """The readout's regroup backward gathers through `rd_inv_flat` (no
    scatter): the JAX package's `_graph_readout_dense` gradient, float32."""
    from infomax3d_tpu.ops.segment import _graph_readout_dense
    from infomax3d_tpu_torch.ops.segment import graph_readout_dense
    arr, b, _ = csr
    rng = np.random.default_rng(15)
    h = rng.normal(size=(b.n_nodes, 6)).astype(np.float32)
    ct = rng.normal(size=(B, 18)).astype(np.float32)
    aggs = ["min", "max", "mean"]
    th = _t(h).requires_grad_()
    out = graph_readout_dense(th, _t(arr["rd_node_idx"]),
                              _t(arr["rd_inv_flat"]), aggs,
                              _t(arr["n_nodes"]))
    (out * _t(ct)).sum().backward()
    want = jax.grad(lambda x: (_graph_readout_dense(
        x, jnp.asarray(arr["rd_node_idx"]), jnp.asarray(arr["rd_inv_flat"]),
        aggs, jnp.asarray(arr["n_nodes"])) * ct).sum())(jnp.asarray(h))
    np.testing.assert_allclose(th.grad.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)
    assert np.abs(want).max() > 0
