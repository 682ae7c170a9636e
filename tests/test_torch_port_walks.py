"""The three small CSR walks, rows 1 (`multi_reduce`), 3
(`csr_segment_sum`) and 4 (`snd_segment_sum`), at the OT slice's batch:
each plain twin against the JAX package's Pallas kernel in interpret mode
(and rows 3 and 4 in float32 against `jax.ops.segment_sum`), also at the
other widths and on batches with nodes of degree 16 that the card checks
use, and the arguments the wrappers pass to the kernels.

The batch is the OT step's own (`train/ot.py::ot_batch(16, 10)`: 16
QM9-like molecules, seed 0, 308 real nodes and 638 real edges in a bucket
of N = 512, E = 1024), built by both batchers, at the slice's width
D = 50.  Tolerances as in `test_torch_port_kernels.py::
test_multi_reduce_matches_pallas`: max and min select, so they are equal;
the float32 sums of the Pallas multi-reduce run through an incidence
matmul in another order, 1e-5.  The bf16 Pallas kernels of rows 3 and 4
sum a node's rows in float32 (a 0/1 incidence matmul) and round once, as
the twins do: equal.  In float32 the twins sum in slot order and XLA's
segment sum in its own: 1e-6.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from infomax3d_tpu.graphs.batch import BucketSpec as JaxBucket
from infomax3d_tpu.graphs.batch import batch_graphs as jax_batch_graphs
from infomax3d_tpu.ops.pallas import spmm
from infomax3d_tpu_torch.data.synthetic import SyntheticMolecules
from infomax3d_tpu_torch.graphs.batch import batch_graphs, bucket_for
from infomax3d_tpu_torch.ops.kernels import (_build, csr_segment_sum,
                                             csr_segment_sum_reference,
                                             multi_reduce,
                                             multi_reduce_reference,
                                             snd_segment_sum,
                                             snd_segment_sum_reference)
from infomax3d_tpu_torch.train.ot import ot_batch

OT_B, OT_CONFS, D = 16, 10, 50
OT_DATA = dict(seed=0, n_min=10, n_max=26)


def _t(x):
    return torch.from_numpy(np.array(x))


def _bf16(x):
    return np.asarray(jnp.asarray(x, jnp.bfloat16).astype(jnp.float32))


@pytest.fixture(scope="module")
def ot_csr():
    """The OT slice's batch by the port's batcher (checked against
    `ot_batch`'s graph) and by the JAX batcher: (port arrays, bucket, JAX
    arrays)."""
    ds = SyntheticMolecules(OT_B, num_conformers=OT_CONFS, **OT_DATA)
    b = bucket_for(ds.mols, OT_B)
    arr = batch_graphs(ds.mols, b)
    g = ot_batch(OT_B, OT_CONFS, **OT_DATA)[0].graph
    for key in ("csr_row_ptr", "csc_row_ptr", "csc_perm", "senders"):
        np.testing.assert_array_equal(getattr(g, key).numpy(), arr[key])
    jarr = jax_batch_graphs(ds.mols, JaxBucket(
        b.n_graphs, b.n_nodes, b.n_edges, max_deg=b.max_deg, csr=True,
        nmax=b.nmax))
    return arr, b, jarr


def test_ot_batch_has_the_slice_shape(ot_csr):
    """N = 512, E = 1024 with 638 real edges; padding nodes (no edges in
    or out) and padding edges present."""
    arr, b, _ = ot_csr
    assert (b.n_nodes, b.n_edges) == (512, 1024)
    assert int(arr["csr_row_ptr"][-1]) == int(arr["csc_row_ptr"][-1]) == 638
    assert (np.diff(arr["csr_row_ptr"]) == 0).any()
    assert (np.diff(arr["csc_row_ptr"]) == 0).any()


@pytest.mark.parametrize("dtype", [np.float32, "bfloat16"])
def test_multi_reduce_matches_pallas_at_the_ot_batch(ot_csr, dtype):
    """Row 1's twin against `_csr_reduce_raw` (interpret mode) at D = 50:
    max / min equal, sum / sumsq within 1e-5; 0 on nodes without edges."""
    from infomax3d_tpu.ops.pallas.spmm import _csr_reduce_raw
    arr, b, _ = ot_csr
    x = np.random.default_rng(21).normal(size=(b.n_edges, D)).astype(
        np.float32)
    if dtype == "bfloat16":
        x = _bf16(x)
        jx, tx = jnp.asarray(x, jnp.bfloat16), _t(x).bfloat16()
    else:
        jx, tx = jnp.asarray(x), _t(x)
    rp = arr["csr_row_ptr"]
    want = _csr_reduce_raw(jx, jnp.asarray(rp), b.max_deg, True)
    got = multi_reduce_reference(tx, _t(rp), b.max_deg)
    deg = np.diff(rp)
    for name, g, w in zip(("sum", "sumsq", "max", "min"), got, want):
        assert g.dtype == torch.float32 and g.shape == (b.n_nodes, D)
        g, w = g.numpy(), np.asarray(w)
        if name in ("max", "min"):
            np.testing.assert_array_equal(g, w, err_msg=name)
        else:
            np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-5,
                                       err_msg=name)
        assert (g[deg == 0] == 0).all()


def test_multi_reduce_cuts_at_max_deg(ot_csr):
    """With K below a node's degree only its first K slots count: the twin
    at K = 1 is each node's first row (sum, max and min alike)."""
    arr, b, _ = ot_csr
    rp = arr["csr_row_ptr"]
    deg = np.diff(rp)
    assert deg.max() > 1
    x = np.random.default_rng(22).normal(size=(b.n_edges, D)).astype(
        np.float32)
    s1, s2, mx, mn = multi_reduce_reference(_t(x), _t(rp), 1)
    first = np.where(deg[:, None] > 0, x[np.minimum(rp[:-1], b.n_edges - 1)],
                     0)
    for got in (s1, mx, mn):
        np.testing.assert_array_equal(got.numpy(), first)
    np.testing.assert_array_equal(s2.numpy(), first * first)


def test_snd_segment_sum_bf16_matches_pallas_at_the_ot_batch(ot_csr):
    """Row 4's twin against `snd_segment_sum_bf16` (interpret mode, the
    JAX batcher's window markers) at D = 50: equal; nodes that send
    nothing get 0."""
    arr, b, jarr = ot_csr
    N = b.n_nodes
    ct = _bf16(np.random.default_rng(23).normal(size=(b.n_edges, D)))
    want = spmm.snd_segment_sum_bf16(
        jnp.asarray(ct, jnp.bfloat16), jnp.asarray(arr["senders"]),
        jnp.asarray(jarr["csr_pair_base"]), jarr["csr_pair_win"].shape[0],
        True)[:N]
    got = snd_segment_sum_reference(_t(ct).bfloat16(),
                                    _t(arr["csc_row_ptr"]),
                                    _t(arr["csc_perm"]))
    assert got.dtype == torch.bfloat16 and got.shape == (N, D)
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want, np.float32))
    sent = np.diff(arr["csc_row_ptr"])
    assert (got.float().numpy()[sent == 0] == 0).all()


def test_snd_segment_sum_f32_matches_segment_sum_at_the_ot_batch(ot_csr):
    """float32 (the OT step's variant): the sums over the senders of
    `jax.ops.segment_sum`, 1e-6 (order)."""
    arr, b, _ = ot_csr
    N = b.n_nodes
    ct = np.random.default_rng(24).normal(size=(b.n_edges, D)).astype(
        np.float32)
    want = jax.ops.segment_sum(ct, np.minimum(arr["senders"], N),
                               num_segments=N + 1)[:N]
    got = snd_segment_sum_reference(_t(ct), _t(arr["csc_row_ptr"]),
                                    _t(arr["csc_perm"]))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)


# --- other widths and nodes of degree 16 ----------------------------------


def _multi_reduce_against_pallas(x, rp, K, bf16: bool):
    """Row 1's twin against `_csr_reduce_raw` (interpret mode) on rows `x`
    (numpy float32), in bf16 where `bf16`: max / min equal, sum / sumsq
    within 1e-5; 0 on nodes without edges."""
    from infomax3d_tpu.ops.pallas.spmm import _csr_reduce_raw
    N, D = rp.shape[0] - 1, x.shape[1]
    x = _bf16(x) if bf16 else x
    jx = jnp.asarray(x, jnp.bfloat16) if bf16 else jnp.asarray(x)
    tx = _t(x).bfloat16() if bf16 else _t(x)
    want = _csr_reduce_raw(jx, jnp.asarray(rp), K, True)
    got = multi_reduce_reference(tx, _t(rp), K)
    deg = np.diff(rp)
    for name, g, w in zip(("sum", "sumsq", "max", "min"), got, want):
        assert g.dtype == torch.float32 and g.shape == (N, D)
        g, w = g.numpy(), np.asarray(w)
        if name in ("max", "min"):
            np.testing.assert_array_equal(g, w, err_msg=name)
        else:
            np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-5,
                                       err_msg=name)
        assert (g[deg == 0] == 0).all()


def _degree16(N: int, seed: int):
    """In- or out-degrees 0 to 4 with every 61st node of degree 16 (more
    than one chunk of the card's walk), as `chip_smoke.degree16_csr` /
    `degree16_csc` build them: (row_ptr, real edges)."""
    rng = np.random.default_rng(seed)
    deg = rng.integers(0, 5, N)
    deg[::61] = 16
    rp = np.concatenate([[0], np.cumsum(deg)]).astype(np.int32)
    return rp, int(rp[-1]), rng


@pytest.mark.parametrize("dtype", [np.float32, "bfloat16"])
@pytest.mark.parametrize("width", [200, 300, 302])
def test_multi_reduce_matches_pallas_at_other_widths(ot_csr, width, dtype):
    """The OT batch at the widths of the card checks (16-byte, 8-byte and
    element-wise vector paths)."""
    arr, b, _ = ot_csr
    x = np.random.default_rng(31).normal(size=(b.n_edges, width)).astype(
        np.float32)
    _multi_reduce_against_pallas(x, arr["csr_row_ptr"], b.max_deg,
                                 dtype == "bfloat16")


@pytest.mark.parametrize("dtype", [np.float32, "bfloat16"])
def test_multi_reduce_matches_pallas_with_degree16_nodes(dtype):
    """A CSR batch of 256 nodes with nodes of degree 16 (K = 16) and 24
    padding edges."""
    rp, e_real, _ = _degree16(256, 0)
    x = np.random.default_rng(32).normal(size=(e_real + 24, 50)).astype(
        np.float32)
    _multi_reduce_against_pallas(x, rp, 16, dtype == "bfloat16")


@pytest.mark.parametrize("K", [3, 5])
def test_multi_reduce_cuts_degree16_nodes_at_k(K):
    """With K below the degree-16 nodes' degree, the twin reduces exactly
    each node's first min(deg, K) rows, as numpy does."""
    rp, e_real, _ = _degree16(256, 0)
    x = np.random.default_rng(33).normal(size=(e_real + 24, 50)).astype(
        np.float32)
    s1, s2, mx, mn = multi_reduce_reference(_t(x), _t(rp), K)
    for n in range(256):
        rows = x[rp[n]:min(rp[n + 1], rp[n] + K)]
        if len(rows) == 0:
            for got in (s1, s2, mx, mn):
                assert (got[n] == 0).all()
            continue
        acc1 = acc2 = np.zeros(50, np.float32)
        for r in rows:
            acc1, acc2 = acc1 + r, acc2 + r * r
        np.testing.assert_array_equal(s1[n].numpy(), acc1)
        np.testing.assert_array_equal(s2[n].numpy(), acc2)
        np.testing.assert_array_equal(mx[n].numpy(), rows.max(0))
        np.testing.assert_array_equal(mn[n].numpy(), rows.min(0))


@pytest.mark.parametrize("width", [200, 300, 302])
def test_snd_segment_sum_bf16_matches_pallas_at_other_widths(ot_csr, width):
    """Row 4's bf16 twin against `snd_segment_sum_bf16` (interpret mode) on
    the OT batch at the widths of the card checks: equal."""
    arr, b, jarr = ot_csr
    N = b.n_nodes
    ct = _bf16(np.random.default_rng(34).normal(size=(b.n_edges, width)))
    want = spmm.snd_segment_sum_bf16(
        jnp.asarray(ct, jnp.bfloat16), jnp.asarray(arr["senders"]),
        jnp.asarray(jarr["csr_pair_base"]), jarr["csr_pair_win"].shape[0],
        True)[:N]
    got = snd_segment_sum_reference(_t(ct).bfloat16(),
                                    _t(arr["csc_row_ptr"]),
                                    _t(arr["csc_perm"]))
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want, np.float32))


@pytest.mark.parametrize("width", [50, 300])
def test_snd_segment_sum_matches_segment_sum_with_degree16_senders(width):
    """A sender-sorted CSC of 256 nodes with out-degree-16 nodes, its
    positions a random permutation of the real edges, and 24 padding
    edges: the float32 twin against `jax.ops.segment_sum` over the
    senders, 1e-6 (order); nodes that send nothing get 0."""
    N = 256
    crp, e_real, rng = _degree16(N, 1)
    E = e_real + 24
    perm = np.concatenate([rng.permutation(e_real),
                           np.arange(e_real, E)]).astype(np.int32)
    senders = np.full(E, N, np.int32)
    senders[perm[:e_real]] = np.repeat(np.arange(N), np.diff(crp))
    ct = np.random.default_rng(35).normal(size=(E, width)).astype(np.float32)
    want = jax.ops.segment_sum(ct, senders, num_segments=N + 1)[:N]
    got = snd_segment_sum_reference(_t(ct), _t(crp), _t(perm))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)
    assert (got.numpy()[np.diff(crp) == 0] == 0).all()


# --- row 3: the receiver-gather backward ----------------------------------


def _csr_segment_sum_against(ct, rp, K, bf16: bool):
    """Row 3's twin on rows `ct` (numpy float32) over the CSR `rp`: in bf16
    against `csr_segment_sum_bf16` (interpret mode, window for max_deg K),
    equal; in float32 against `jax.ops.segment_sum` over the receivers,
    1e-6 (order).  Nodes without edges get 0, and rows past rp[N]
    (padding edges, set to 1e4) never count."""
    from infomax3d_tpu.ops.pallas.spmm import csr_segment_sum_bf16
    N, D = rp.shape[0] - 1, ct.shape[1]
    e_real = int(rp[-1])
    assert e_real < ct.shape[0]
    if bf16:
        ct = _bf16(ct)
        want = np.asarray(csr_segment_sum_bf16(
            jnp.asarray(ct, jnp.bfloat16), jnp.asarray(rp), K,
            interpret=True), np.float32)
        tct = _t(ct).bfloat16()
    else:
        recv = np.full(ct.shape[0], N, np.int32)
        recv[:e_real] = np.repeat(np.arange(N), np.diff(rp))
        want = np.asarray(jax.ops.segment_sum(ct, recv,
                                              num_segments=N + 1)[:N])
        tct = _t(ct)
    got = csr_segment_sum_reference(tct, _t(rp))
    assert got.dtype == tct.dtype and got.shape == (N, D)
    if bf16:
        np.testing.assert_array_equal(got.float().numpy(), want)
    else:
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
    assert (got.float().numpy()[np.diff(rp) == 0] == 0).all()
    tct[e_real:] = 1e4
    assert torch.equal(csr_segment_sum_reference(tct, _t(rp)), got)


@pytest.mark.parametrize("dtype", [np.float32, "bfloat16"])
@pytest.mark.parametrize("width", [D, 300, 302])
def test_csr_segment_sum_matches_at_the_ot_batch(ot_csr, width, dtype):
    """Row 3 on the OT batch (the JAX batcher's row_ptr, equal to the
    port's) at the OT width and the other widths of the card check: bf16
    equal to the Pallas kernel, float32 within 1e-6 of the receivers'
    `jax.ops.segment_sum`."""
    arr, b, jarr = ot_csr
    np.testing.assert_array_equal(jarr["csr_row_ptr"], arr["csr_row_ptr"])
    ct = np.random.default_rng(36).normal(size=(b.n_edges, width)).astype(
        np.float32)
    _csr_segment_sum_against(ct, np.asarray(jarr["csr_row_ptr"]), b.max_deg,
                             dtype == "bfloat16")


@pytest.mark.parametrize("dtype", [np.float32, "bfloat16"])
def test_csr_segment_sum_matches_with_degree16_nodes(dtype):
    """A CSR batch of 256 nodes with in-degree-16 nodes (more than one
    chunk of the card's walk) and 24 padding edges, at D = 50."""
    rp, e_real, _ = _degree16(256, 0)
    ct = np.random.default_rng(37).normal(size=(e_real + 24, 50)).astype(
        np.float32)
    _csr_segment_sum_against(ct, rp, 16, dtype == "bfloat16")


# --- the card path's arguments ----------------------------------------------


def _fake_launches(monkeypatch):
    """Stub the device check to take the CUDA path on CPU tensors and each
    walk module's launcher to record (symbol, args), checking the count of
    arguments against the C signature's; returns the list of calls."""
    import importlib
    monkeypatch.setattr(_build, "on_card", lambda t, name: True)
    calls = []
    for name in ("multi_reduce", "csr_segment_sum", "snd_segment_sum"):
        m = importlib.import_module(f"infomax3d_tpu_torch.ops.kernels.{name}")

        def fake_launcher(name, symbol, argtypes):
            def fn(*args):
                assert len(args) == len(argtypes)
                calls.append((symbol, args))
                return 0
            return fn
        monkeypatch.setattr(m, "launcher", fake_launcher)
        monkeypatch.setattr(m, "stream_of", lambda t: 7)
    return calls


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_walks_pass_their_plan_to_the_kernel(ot_csr, monkeypatch, dtype):
    """Each public wrapper launches once with exactly its C signature's
    arguments: N, E, D (and row 1's K), then 0 (the kernel picks 32-bit or
    64-bit indices from N, E and D itself), the stream last; each launch
    is counted once."""
    arr, b, _ = ot_csr
    calls = _fake_launches(monkeypatch)
    x = torch.zeros(b.n_edges, D, dtype=dtype)
    rp, crp, perm = (_t(arr[k]) for k in ("csr_row_ptr", "csc_row_ptr",
                                          "csc_perm"))
    counters = (multi_reduce, csr_segment_sum, snd_segment_sum)
    before = [w.launches for w in counters]
    multi_reduce(x, rp, b.max_deg)
    csr_segment_sum(x, rp)
    snd_segment_sum(x, crp, perm)
    suffix = "f32" if dtype == torch.float32 else "bf16"
    (s1, a1), (s3, a3), (s4, a4) = calls
    assert (s1, s3, s4) == (f"multi_reduce_{suffix}",
                            f"csr_segment_sum_{suffix}",
                            f"snd_segment_sum_{suffix}")
    assert a1[3:] == (b.n_nodes, b.n_edges, D, b.max_deg, 0, 7)
    assert a3[3:] == (b.n_nodes, b.n_edges, D, 0, 7)
    assert a4[4:] == (b.n_nodes, b.n_edges, D, 0, 7)
    assert [w.launches for w in counters] == [n + 1 for n in before]


@pytest.mark.parametrize("row", ["multi_reduce", "csr_segment_sum",
                                 "snd_segment_sum"])
def test_walk_launch_forces_64bit_indices(ot_csr, monkeypatch, row):
    """`_launch(..., wide=True)`, the card check's way to the 64-bit path,
    passes 1 in the index-width argument."""
    import importlib
    arr, b, _ = ot_csr
    calls = _fake_launches(monkeypatch)
    mod = importlib.import_module(f"infomax3d_tpu_torch.ops.kernels.{row}")
    x = torch.zeros(b.n_edges, D)
    if row == "multi_reduce":
        mod._launch(x, _t(arr["csr_row_ptr"]), b.max_deg, wide=True)
    elif row == "csr_segment_sum":
        mod._launch(x, _t(arr["csr_row_ptr"]), wide=True)
    else:
        mod._launch(x, _t(arr["csc_row_ptr"]), _t(arr["csc_perm"]),
                    wide=True)
    (_, args), = calls
    assert args[-2:] == (1, 7)
