"""Each kernel's plain PyTorch version against the JAX package's Pallas
kernel, run in interpret mode on the CPU (the forward kernels, the pair
segment sum and the stats backward, the latter with `_stats_bwd`'s
node-side combination through `jax.vjp`).

Tolerances: a bf16 "ulp" tolerance is rtol = 2**-7 — one unit in the last
place of bf16 (8 significant bits) relative to the value, the most two
correctly rounded results of the same f32 statistic can differ by when the
f32 sums are taken in another order (the Pallas kernel sums through a 0/1
incidence matmul and splits sumsq into bf16 hi/lo halves).  Max, min and
the winner slots select existing values, so they must agree exactly.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from infomax3d_tpu.ops.pallas.spmm import (_csr_edge_combine_raw,
                                           _csr_reduce_raw, _csr_stats_raw)
from infomax3d_tpu_torch.data.synthetic import SyntheticMolecules
from infomax3d_tpu_torch.graphs.batch import batch_graphs, bucket_for
from infomax3d_tpu_torch.ops.kernels import (edge_combine_reference,
                                             multi_reduce_reference,
                                             pair_segment_sum_reference,
                                             pna_stats_bwd_reference,
                                             pna_stats_reference)
from infomax3d_tpu_torch.ops.kernels.pna_stats_bwd import COTANGENTS

BF16_ULP = 2.0 ** -7
D = 56


@pytest.fixture(scope="module")
def csr():
    """A real CSR batch: 24 molecules padded to 32 graphs (padding nodes
    and padding edges present)."""
    graphs = [SyntheticMolecules(24, seed=9, n_min=5, n_max=16).graph2d(i)
              for i in range(24)]
    b = bucket_for(graphs, 32)
    return batch_graphs(graphs, b), b, graphs


def _t(x):
    return torch.from_numpy(np.array(x))


def _bf16(x):
    return np.asarray(jnp.asarray(x, jnp.bfloat16).astype(jnp.float32))


def test_edge_combine_bf16_matches_pallas(csr):
    from infomax3d_tpu.graphs.batch import BucketSpec, batch_graphs as jbg
    arr, b, graphs = csr
    rng = np.random.default_rng(0)
    N, E = b.n_nodes, b.n_edges
    hd, hs = (_bf16(rng.normal(size=(N, D))) for _ in range(2))
    pe = _bf16(rng.normal(size=(E, D)))
    # the Pallas kernel's node window comes from the JAX batcher's marker
    jarr = jbg(graphs, BucketSpec(b.n_graphs, N, E, max_deg=b.max_deg,
                                  csr=True, nmax=b.nmax))
    want = _csr_edge_combine_raw(
        jnp.asarray(hd, jnp.bfloat16), jnp.asarray(hs, jnp.bfloat16),
        jnp.asarray(pe, jnp.bfloat16), jnp.asarray(arr["receivers"]),
        jnp.asarray(arr["senders"]), jarr["csr_cmb_span"].shape[0], True)
    got = edge_combine_reference(
        _t(hd).bfloat16(), _t(hs).bfloat16(), _t(pe).bfloat16(),
        _t(arr["receivers"]), _t(arr["senders"]))
    e_real = int(arr["csr_row_ptr"][-1])
    assert got.dtype == torch.bfloat16 and got.shape == (E, D)
    # one f32 sum rounded once on both sides: bit-exact on real edges
    np.testing.assert_array_equal(got.float().numpy()[:e_real],
                                  np.asarray(want, np.float32)[:e_real])
    # padding edges carry pe alone
    np.testing.assert_array_equal(got.float().numpy()[e_real:], pe[e_real:])


def test_edge_combine_f32_matches_gather_add(csr):
    """float32: the JAX package's f32 path is take + take + add."""
    arr, b, _ = csr
    rng = np.random.default_rng(1)
    N, E = b.n_nodes, b.n_edges
    hd, hs = (rng.normal(size=(N, D)).astype(np.float32) for _ in range(2))
    pe = rng.normal(size=(E, D)).astype(np.float32)
    r, s = arr["receivers"], arr["senders"]
    want = (jnp.take(hd, np.clip(r, 0, N - 1), axis=0)
            + jnp.take(hs, np.clip(s, 0, N - 1), axis=0) + pe)
    got = edge_combine_reference(_t(hd), _t(hs), _t(pe), _t(r), _t(s))
    e_real = int(arr["csr_row_ptr"][-1])
    np.testing.assert_array_equal(got.numpy()[:e_real],
                                  np.asarray(want)[:e_real])


@pytest.mark.parametrize("with_affine", [False, True])
@pytest.mark.parametrize("want_sum", [True, False])
def test_pna_stats_matches_pallas(csr, with_affine, want_sum):
    arr, b, _ = csr
    rng = np.random.default_rng(2)
    E, K = b.n_edges, b.max_deg
    x = _bf16(rng.normal(size=(E, D)) * 2.0)
    affine = None
    if with_affine:
        affine = (rng.uniform(0.5, 1.5, D).astype(np.float32),
                  rng.normal(0.0, 0.3, D).astype(np.float32))
    want = _csr_stats_raw(
        jnp.asarray(x, jnp.bfloat16), jnp.asarray(arr["csr_row_ptr"]), K,
        True, 0, want_sum,
        None if affine is None else tuple(jnp.asarray(a) for a in affine))
    got = pna_stats_reference(
        _t(x).bfloat16(), _t(arr["csr_row_ptr"]), K,
        None if affine is None else tuple(_t(a) for a in affine), want_sum)
    assert (got[0] is None) == (not want_sum)
    names = ("sum", "mean", "std", "max", "min", "enc")
    for name, g, w in zip(names, got, want):
        if g is None:
            continue
        assert g.dtype == torch.bfloat16 and g.shape == (b.n_nodes, D)
        g, w = g.float().numpy(), np.asarray(w, np.float32)
        if name in ("max", "min", "enc"):
            np.testing.assert_array_equal(g, w, err_msg=name)
        else:
            np.testing.assert_allclose(g, w, rtol=BF16_ULP, atol=1e-6,
                                       err_msg=name)
    # every statistic of a node without edges (padding nodes) is 0
    deg = np.diff(arr["csr_row_ptr"])
    for g in got[1:5]:
        assert (g.float().numpy()[deg == 0] == 0).all()


def test_pna_stats_rejects_wide_slots_and_f32():
    msgs = torch.zeros(4, 8, dtype=torch.bfloat16)
    rp = torch.tensor([0, 2, 4], dtype=torch.int32)
    with pytest.raises(ValueError, match="max_deg"):
        pna_stats_reference(msgs, rp, 17)
    with pytest.raises(TypeError, match="bf16"):
        pna_stats_reference(msgs.float(), rp, 2)


@pytest.mark.parametrize("dtype", [np.float32, "bfloat16"])
def test_multi_reduce_matches_pallas(csr, dtype):
    arr, b, _ = csr
    rng = np.random.default_rng(3)
    E, K = b.n_edges, b.max_deg
    x = rng.normal(size=(E, D)).astype(np.float32)
    if dtype == "bfloat16":
        x = _bf16(x)
        jx, tx = jnp.asarray(x, jnp.bfloat16), _t(x).bfloat16()
    else:
        jx, tx = jnp.asarray(x), _t(x)
    want = _csr_reduce_raw(jx, jnp.asarray(arr["csr_row_ptr"]), K, True)
    got = multi_reduce_reference(tx, _t(arr["csr_row_ptr"]), K)
    for name, g, w in zip(("sum", "sumsq", "max", "min"), got, want):
        assert g.dtype == torch.float32 and g.shape == (b.n_nodes, D)
        g, w = g.numpy(), np.asarray(w)
        if name in ("max", "min"):
            np.testing.assert_array_equal(g, w, err_msg=name)
        else:
            # f32 sums in another order (incidence matmul on the JAX side)
            np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-5,
                                       err_msg=name)
    deg = np.diff(arr["csr_row_ptr"])
    for g in got:
        assert (g.numpy()[deg == 0] == 0).all()


# --- the training kernels: the pair segment sum and the stats backward -----

@pytest.fixture(scope="module")
def jax_csr(csr):
    """The JAX batcher's arrays for the same molecules (its TPU window
    markers size the Pallas kernels' windows)."""
    from infomax3d_tpu.graphs.batch import BucketSpec, batch_graphs as jbg
    arr, b, graphs = csr
    return jbg(graphs, BucketSpec(b.n_graphs, b.n_nodes, b.n_edges,
                                  max_deg=b.max_deg, csr=True, nmax=b.nmax))


def test_pair_segment_sum_matches_pallas(csr, jax_csr):
    """bf16: the Pallas pair kernel (interpret mode) and the plain version
    both sum at most max_deg bf16 rows in float32 and round once: equal."""
    from infomax3d_tpu.ops.pallas.spmm import pair_segment_sum_bf16
    arr, b, _ = csr
    rng = np.random.default_rng(4)
    ct = _bf16(rng.normal(size=(b.n_edges, D)))
    want_hd, want_hs = pair_segment_sum_bf16(
        jnp.asarray(ct, jnp.bfloat16), jnp.asarray(arr["senders"]),
        jnp.asarray(arr["csr_row_ptr"]), jnp.asarray(jax_csr["csr_pair_base"]),
        jax_csr["csr_pair_win"].shape[0], True)
    got_hd, got_hs = pair_segment_sum_reference(
        _t(ct).bfloat16(), _t(arr["csr_row_ptr"]), _t(arr["csc_row_ptr"]),
        _t(arr["csc_perm"]))
    for g, w in ((got_hd, want_hd), (got_hs, want_hs)):
        assert g.dtype == torch.bfloat16 and g.shape == (b.n_nodes, D)
        np.testing.assert_array_equal(g.float().numpy(),
                                      np.asarray(w, np.float32))


def test_pair_segment_sum_f32_matches_segment_sum(csr):
    """float32 (the float32 step's combine backward, where the JAX package
    runs XLA segment sums): the same sums, 1e-6 relative (order)."""
    import jax
    arr, b, _ = csr
    rng = np.random.default_rng(5)
    N = b.n_nodes
    ct = rng.normal(size=(b.n_edges, D)).astype(np.float32)
    got = pair_segment_sum_reference(
        _t(ct), _t(arr["csr_row_ptr"]), _t(arr["csc_row_ptr"]),
        _t(arr["csc_perm"]))
    for g, ids in zip(got, (arr["receivers"], arr["senders"])):
        want = jax.ops.segment_sum(ct, np.minimum(ids, N),
                                   num_segments=N + 1)[:N]
        np.testing.assert_allclose(g.numpy(), np.asarray(want), rtol=1e-6,
                                   atol=1e-6)


def _stats_bwd_case(arr, b, seed, with_affine, want_sum=True, missing=()):
    """bf16 messages, an optional affine, the forward's residuals (mean,
    std, enc of the JAX package's Pallas forward in interpret mode) and the
    five cotangents of (sum, mean, std, max, min), each bf16 [N, D] or None
    where `missing` names it (and the sum's without `want_sum`).  The
    affine's scales are powers of two: XLA on the CPU contracts the
    interpreted kernels' ``x * a + b`` into one FMA, where the card's
    kernels and their twins round the product first; with an exact product
    both round once (an arbitrary scale put one element of seed 8 on the
    other side of a bf16 tie)."""
    from infomax3d_tpu.ops.pallas import spmm
    rng = np.random.default_rng(seed)
    N, E, K = b.n_nodes, b.n_edges, b.max_deg
    x = _bf16(rng.normal(size=(E, D)) * 2.0)
    affine = None
    if with_affine:
        affine = ((2.0 ** rng.integers(-1, 2, D)).astype(np.float32),
                  rng.normal(0.0, 0.3, D).astype(np.float32))
    _, mean, std, _, _, enc = spmm._csr_stats_raw(
        jnp.asarray(x, jnp.bfloat16), jnp.asarray(arr["csr_row_ptr"]), K,
        True, 0, True,
        None if affine is None else tuple(jnp.asarray(a) for a in affine))
    cts = {n: _bf16(rng.normal(size=(N, D))) for n in COTANGENTS}
    if not want_sum:
        missing = tuple(missing) + ("d_sum",)
    for n in missing:
        cts[n] = None
    res = tuple(np.asarray(r, np.float32) for r in (mean, std, enc))
    return x, affine, res, cts


def _bwd_twin(arr, b, x, affine, res, cts):
    return pna_stats_bwd_reference(
        _t(x).bfloat16(), _t(arr["csr_row_ptr"]), b.max_deg,
        *(_t(r).bfloat16() for r in res),
        *(None if cts[n] is None else _t(cts[n]).bfloat16()
          for n in COTANGENTS),
        None if affine is None else tuple(_t(a) for a in affine))


def _pallas_in_interpret_mode(monkeypatch):
    """Route the JAX package's Pallas stats forward and backward
    (`_csr_stats_raw`, `_csr_stats_bwd_raw`) through interpret mode, so
    that `csr_pna_stats(..., interpret=False, bwd_span > 0)` runs its TPU
    configuration on the CPU: the Pallas forward, `_stats_bwd`'s node-side
    combination and the Pallas backward kernel."""
    from infomax3d_tpu.ops.pallas import spmm
    fwd, bwd = spmm._csr_stats_raw, spmm._csr_stats_bwd_raw
    monkeypatch.setattr(spmm, "_csr_stats_raw",
                        lambda m, rp, K, _interp, *rest: fwd(m, rp, K, True,
                                                             *rest))
    monkeypatch.setattr(
        spmm, "_csr_stats_bwd_raw",
        lambda m, r, rp, pos, ops, span, _interp, aff=None: bwd(
            m, r, rp, pos, ops, span, True, aff))


def _jax_stats_vjp(arr, jax_csr, b, x, affine, cts, want_sum):
    """d_x (and d_a, d_b with an affine) of `jax.vjp` of `csr_pna_stats`
    in its TPU configuration; a missing cotangent is zero there."""
    import jax
    from infomax3d_tpu.ops.pallas import spmm
    rp, recv, pos = (jnp.asarray(arr[k]) for k in
                     ("csr_row_ptr", "receivers", "csr_pos"))
    span = jax_csr["csr_bwd_span"].shape[0]
    args = [jnp.asarray(x, jnp.bfloat16)]
    if affine is not None:
        args += [jnp.asarray(a) for a in affine]

    def f(m, *aff):
        return spmm.csr_pna_stats(m, rp, recv, pos, b.max_deg, False, 0,
                                  span, want_sum, tuple(aff) or None)

    _, vjp = jax.vjp(f, *args)
    zero = np.zeros((b.n_nodes, D), np.float32)
    return vjp(tuple(jnp.asarray(zero if cts[n] is None else cts[n],
                                 jnp.bfloat16) for n in COTANGENTS))


def _hold_to_jax(got, want, with_affine):
    """d_x bit-equal; d_a, d_b within 1e-5 relative (the Pallas kernel
    sums 128-edge blocks, then the blocks; the port tiles of nodes)."""
    np.testing.assert_array_equal(got[0].float().numpy(),
                                  np.asarray(want[0], np.float32))
    if not with_affine:
        assert got[1] is None and got[2] is None
        return
    for g, w in zip(got[1:], want[1:]):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-5,
                                   atol=1e-5 * np.abs(w).max())


@pytest.mark.parametrize("with_affine", [False, True])
def test_pna_stats_bwd_matches_pallas(csr, jax_csr, with_affine,
                                      monkeypatch):
    """The plain version against the JAX package's whole stats backward in
    its TPU configuration: `_stats_bwd`'s node-side combination (float32,
    rounded to bf16) and `_csr_stats_bwd_raw`, in interpret mode, from the
    same residuals and cotangents.  Both form d in float32 with the same
    rounding points and round once: d_x bit-equal, padding edges 0."""
    arr, b, _ = csr
    x, affine, res, cts = _stats_bwd_case(arr, b, 7, with_affine)
    _pallas_in_interpret_mode(monkeypatch)
    want = _jax_stats_vjp(arr, jax_csr, b, x, affine, cts, True)
    got = _bwd_twin(arr, b, x, affine, res, cts)
    assert got[0].dtype == torch.bfloat16 and got[0].shape == x.shape
    _hold_to_jax(got, want, with_affine)
    e_real = int(arr["csr_row_ptr"][-1])
    assert e_real < b.n_edges and (got[0].float().numpy()[e_real:] == 0).all()


@pytest.mark.parametrize("missing", [(), ("d_std",), ("d_mean", "d_max")],
                         ids=["all", "no-std", "no-mean-max"])
@pytest.mark.parametrize("want_sum", [True, False])
@pytest.mark.parametrize("with_affine", [False, True])
def test_pna_stats_bwd_matches_jax_vjp(csr, jax_csr, with_affine, want_sum,
                                       missing, monkeypatch):
    """`jax.vjp` of `csr_pna_stats` (Pallas forward and backward, interpret
    mode) against the plain version, with and without the affine and the
    sum section, and with cotangents missing (None in the port, zero in the
    JAX package): d_x bit-equal, d_a / d_b within 1e-5 relative."""
    arr, b, _ = csr
    x, affine, res, cts = _stats_bwd_case(arr, b, 8, with_affine, want_sum,
                                          missing)
    _pallas_in_interpret_mode(monkeypatch)
    want = _jax_stats_vjp(arr, jax_csr, b, x, affine, cts, want_sum)
    _hold_to_jax(_bwd_twin(arr, b, x, affine, res, cts), want, with_affine)


def test_pna_stats_bwd_degenerate_nodes():
    """Nodes of degree 0 route nothing: changing their cotangents changes
    no d_x.  At a node of degree 1 the message is its own mean, so the std
    term cancels exactly: with d_std alone, d_x is 0 on those edges (and
    non-zero elsewhere).  Padding edges (past row_ptr[N]) get 0.  A
    hand-built CSR batch (degrees 0 to 4, then padding edges), with the
    residuals of the port's own forward twin."""
    rng = np.random.default_rng(15)
    N, Dd, K = 40, 24, 4
    deg = rng.integers(0, K + 1, N)
    deg[:3] = (0, 1, K)
    rp = np.concatenate([[0], np.cumsum(deg)]).astype(np.int32)
    E = int(rp[-1]) + 5
    x = _t(_bf16(rng.normal(size=(E, Dd)) * 2.0)).bfloat16()
    affine = (_t(rng.uniform(0.5, 1.5, Dd).astype(np.float32)),
              _t(rng.normal(0.0, 0.3, Dd).astype(np.float32)))
    _, mean, std, _, _, enc = pna_stats_reference(x, _t(rp), K, affine,
                                                  False)
    cts = {n: _t(_bf16(rng.normal(size=(N, Dd)))).bfloat16()
           for n in COTANGENTS}

    def twin(c):
        return pna_stats_bwd_reference(x, _t(rp), K, mean, std, enc,
                                       *(c[n] for n in COTANGENTS), affine)

    base = twin(cts)
    moved = {n: c.clone() for n, c in cts.items()}
    for c in moved.values():
        c[_t(deg == 0)] = 7.0
    for g, w in zip(twin(moved), base):
        assert torch.equal(g, w)
    d_x = twin({n: (cts[n] if n == "d_std" else None)
                for n in COTANGENTS})[0].float().numpy()
    ones = np.repeat(deg == 1, deg)
    e_real = int(rp[-1])
    assert ones.any() and (d_x[:e_real][ones] == 0).all()
    assert (np.abs(d_x[:e_real][~ones]).max(axis=1) > 0).all()
    assert (base[0].float().numpy()[e_real:] == 0).all()
    assert (d_x[e_real:] == 0).all()


def test_pna_stats_bwd_column_sum_order():
    """The twin's column sums take the order the kernel documents (csrc/
    pna_stats_bwd.cu): nodes in order within a tile of `tile_nodes(D)`
    nodes, tiles in order within a chunk of CHUNK_TILES tiles, chunks in
    order, each level from 0.  Hand-built: 2**24 absorbs a following 1.0
    (ties round to even), so summing these node values in one sequence
    gives another float32 result than the grouped order."""
    from infomax3d_tpu_torch.ops.kernels.pna_stats_bwd import (
        CHUNK_TILES, column_sums, tile_nodes)
    Dw = 200
    tn = tile_nodes(Dw)
    assert tn == 10 and CHUNK_TILES == 32
    chunk = tn * CHUNK_TILES
    N = 2 * chunk + 3                             # 2 full chunks and a third
    vals = np.zeros(N, np.float32)
    vals[tn - 1] = 2.0 ** 24                      # the end of tile 0
    vals[tn:2 * tn] = 1.0                         # tile 1: 10
    vals[chunk:chunk + tn] = 1.0                  # chunk 1, tile 0: 10
    vals[-1] = 3.0                                # chunk 2
    node_sums = np.zeros((N, 2 * Dw), np.float32)
    node_sums[:, 7] = vals
    f32 = np.float32
    want = f32(0)
    for c0 in range(0, N, chunk):
        csum = f32(0)
        for t0 in range(c0, min(c0 + chunk, N), tn):
            tsum = f32(0)
            for v in vals[t0:min(t0 + tn, N)]:
                tsum = f32(tsum + v)
            csum = f32(csum + tsum)
        want = f32(want + csum)
    got = column_sums(torch.from_numpy(node_sums))
    assert got.shape == (2 * Dw,)
    assert float(got[7]) == float(want) == 2 ** 24 + 24
    assert float(np.cumsum(vals, dtype=np.float32)[-1]) == 2 ** 24 + 4
    assert (got.numpy()[np.arange(2 * Dw) != 7] == 0).all()


# --- the receiver-gather backward: the CSR segment sum ----------------------

@pytest.mark.parametrize("width", [50, 200, 300])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_csr_segment_sum_bf16_matches_pallas(csr, width, seed):
    """bf16: the plain version and `csr_segment_sum_bf16` (interpret mode)
    both sum at most max_deg bf16 rows in float32 and round once: equal,
    at the OT width (50), the pre-training width (200) and the GIN width
    (300).  Rows past row_ptr[N] (padding edges) never count."""
    from infomax3d_tpu.ops.pallas.spmm import csr_segment_sum_bf16
    from infomax3d_tpu_torch.ops.kernels import csr_segment_sum_reference
    arr, b, _ = csr
    rng = np.random.default_rng(10 + seed)
    ct = _bf16(rng.normal(size=(b.n_edges, width)) * 3.0)
    want = csr_segment_sum_bf16(jnp.asarray(ct, jnp.bfloat16),
                                jnp.asarray(arr["csr_row_ptr"]), b.max_deg,
                                interpret=True)
    got = csr_segment_sum_reference(_t(ct).bfloat16(),
                                    _t(arr["csr_row_ptr"]))
    assert got.dtype == torch.bfloat16 and got.shape == (b.n_nodes, width)
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want, np.float32))
    deg = np.diff(arr["csr_row_ptr"])
    assert (got.float().numpy()[deg == 0] == 0).all()
    e_real = int(arr["csr_row_ptr"][-1])
    assert e_real < b.n_edges
    ct = ct.copy()
    ct[e_real:] = 1e4
    again = csr_segment_sum_reference(_t(ct).bfloat16(),
                                      _t(arr["csr_row_ptr"]))
    assert torch.equal(again, got)


def test_csr_segment_sum_f32_matches_segment_sum(csr):
    """float32 (the OT step's receiver-gather backward, where the JAX
    package runs `sorted_segment_sum` on the CPU and XLA's segment sum is
    the plain reference): the receiver sums of `jax.ops.segment_sum`
    within 1e-6 relative (order)."""
    import jax
    from infomax3d_tpu_torch.ops.kernels import csr_segment_sum_reference
    arr, b, _ = csr
    N = b.n_nodes
    ct = np.random.default_rng(13).normal(size=(b.n_edges, 50)).astype(
        np.float32)
    got = csr_segment_sum_reference(_t(ct), _t(arr["csr_row_ptr"]))
    want = jax.ops.segment_sum(ct, np.minimum(arr["receivers"], N),
                               num_segments=N + 1)[:N]
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)
