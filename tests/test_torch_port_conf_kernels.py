"""Rows 6 (`edge_combine`), 5 (`pair_segment_sum`) and 7 (`csr_sum`) at
the shape of the multi-conformer step's 3D side: complete graphs of C
conformers per molecule, packed molecule-major in one CSR batch, at the
flat Net3D's width D = 20 (40-byte bf16 rows, which the kernels gather in
8-byte pieces) and at D = 21 (42-byte rows, which fit no word:
element-wise gathers).  Each plain twin against the JAX package's Pallas
kernel in interpret mode (bf16; row 7 in both dtypes) or against XLA's
gathers and segment sums (float32), and the arguments the wrappers pass
to the kernels.

The batch: 4 synthetic molecules of 12 to 24 atoms (seed 3) with C = 3
conformers each, their 12 complete graphs in a bucket with padding nodes
and padding edges (in-degree up to 23), built by the port's and the JAX
package's batchers.  Tolerances: the bf16 twins and Pallas kernels sum the
same bf16 terms in float32 and round once: equal.  The float32 edge
combine adds the same three terms in the same order as XLA's take + take +
add: equal.  The float32 pair sum adds in slot order, XLA's segment sum in
its own: 1e-6 relative.  The CSR sum's twin adds a node's up to 23 rows in
slot order in float32, the Pallas `csr_sum` through a 0/1 incidence
matmul (interpret mode: XLA's float32 dot, whose order may differ): 1e-6
relative plus 1e-6 of the largest sum, for sums that cancel, as in
`tests/test_torch_port_gin.py` at in-degree 4; its gradient, a gather of
the cotangent at each edge's receiver, equals `jax.vjp`'s exactly.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from infomax3d_tpu.graphs.batch import BucketSpec as JaxBucket
from infomax3d_tpu.graphs.batch import batch_graphs as jax_batch_graphs
from infomax3d_tpu.ops.pallas.spmm import (_csr_edge_combine_raw,
                                           pair_segment_sum_bf16)
from infomax3d_tpu.ops.pallas.spmm import csr_sum as jax_csr_sum
from infomax3d_tpu_torch.data.synthetic import SyntheticMolecules
from infomax3d_tpu_torch.graphs.batch import batch_graphs, bucket_for
from infomax3d_tpu_torch.ops.kernels import (_build, csr_sum,
                                             csr_sum_reference, edge_combine,
                                             edge_combine_reference,
                                             pair_segment_sum,
                                             pair_segment_sum_reference)

B, C = 4, 3
DATA = dict(seed=3, n_min=12, n_max=24)
WIDTHS = (20, 21)


def _t(x):
    return torch.from_numpy(np.array(x))


def _bf16(x):
    return np.asarray(jnp.asarray(x, jnp.bfloat16).astype(jnp.float32))


@pytest.fixture(scope="module")
def conf():
    """The conformer batch by the port's batcher and by the JAX batcher
    (whose markers size the Pallas kernels' windows): (port arrays,
    bucket, JAX arrays)."""
    ds = SyntheticMolecules(B, num_conformers=C, **DATA)
    confs = [ds.graph3d(i, conformer=c) for i in range(B) for c in range(C)]
    b = bucket_for(confs, B * C)
    jarr = jax_batch_graphs(confs, JaxBucket(
        b.n_graphs, b.n_nodes, b.n_edges, max_deg=b.max_deg, csr=True,
        nmax=b.nmax))
    return batch_graphs(confs, b), b, jarr


def test_conformer_batch_shape(conf):
    """Complete graphs (every in-degree n - 1, up to 23), padding nodes
    and padding edges, both batchers' CSR and CSC arrays equal."""
    arr, b, jarr = conf
    deg = np.diff(arr["csr_row_ptr"])
    assert deg.max() >= 20 and b.max_deg == deg.max()
    assert (deg == 0).any() and int(arr["csr_row_ptr"][-1]) < b.n_edges
    np.testing.assert_array_equal(deg, np.diff(arr["csc_row_ptr"]))
    for key in ("senders", "receivers", "csr_row_ptr", "csc_row_ptr",
                "csc_perm"):
        np.testing.assert_array_equal(arr[key], jarr[key], err_msg=key)


@pytest.mark.parametrize("D", WIDTHS)
def test_edge_combine_bf16_matches_pallas_at_the_conformer_batch(conf, D):
    """bf16: the twin and `_csr_edge_combine_raw` (interpret mode) add the
    same three terms in float32 and round once: equal on real edges;
    padding edges get pe alone."""
    arr, b, jarr = conf
    rng = np.random.default_rng(30 + D)
    N, E = b.n_nodes, b.n_edges
    hd, hs = (_bf16(rng.normal(size=(N, D))) for _ in range(2))
    pe = _bf16(rng.normal(size=(E, D)))
    want = _csr_edge_combine_raw(
        jnp.asarray(hd, jnp.bfloat16), jnp.asarray(hs, jnp.bfloat16),
        jnp.asarray(pe, jnp.bfloat16), jnp.asarray(arr["receivers"]),
        jnp.asarray(arr["senders"]), jarr["csr_cmb_span"].shape[0], True)
    got = edge_combine_reference(
        _t(hd).bfloat16(), _t(hs).bfloat16(), _t(pe).bfloat16(),
        _t(arr["receivers"]), _t(arr["senders"]))
    e_real = int(arr["csr_row_ptr"][-1])
    assert got.dtype == torch.bfloat16 and got.shape == (E, D)
    np.testing.assert_array_equal(got.float().numpy()[:e_real],
                                  np.asarray(want, np.float32)[:e_real])
    np.testing.assert_array_equal(got.float().numpy()[e_real:], pe[e_real:])


@pytest.mark.parametrize("D", WIDTHS)
def test_edge_combine_f32_matches_gather_add_at_the_conformer_batch(conf, D):
    """float32: XLA's take + take + add over the real edges, the same
    terms in the same order: equal."""
    arr, b, _ = conf
    rng = np.random.default_rng(40 + D)
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
    np.testing.assert_array_equal(got.numpy()[e_real:], pe[e_real:])


@pytest.mark.parametrize("D", WIDTHS)
def test_pair_segment_sum_bf16_matches_pallas_at_the_conformer_batch(conf,
                                                                     D):
    """bf16: the twin and `pair_segment_sum_bf16` (interpret mode) sum a
    node's up to 23 rows per half in float32 and round once: equal; nodes
    without edges get 0."""
    arr, b, jarr = conf
    rng = np.random.default_rng(50 + D)
    ct = _bf16(rng.normal(size=(b.n_edges, D)))
    want = pair_segment_sum_bf16(
        jnp.asarray(ct, jnp.bfloat16), jnp.asarray(arr["senders"]),
        jnp.asarray(arr["csr_row_ptr"]), jnp.asarray(jarr["csr_pair_base"]),
        jarr["csr_pair_win"].shape[0], True)
    got = pair_segment_sum_reference(
        _t(ct).bfloat16(), _t(arr["csr_row_ptr"]), _t(arr["csc_row_ptr"]),
        _t(arr["csc_perm"]))
    empty = np.diff(arr["csr_row_ptr"]) == 0
    for g, w in zip(got, want):
        assert g.dtype == torch.bfloat16 and g.shape == (b.n_nodes, D)
        np.testing.assert_array_equal(g.float().numpy(),
                                      np.asarray(w, np.float32))
        assert (g.float().numpy()[empty] == 0).all()


@pytest.mark.parametrize("D", WIDTHS)
def test_pair_segment_sum_f32_matches_segment_sum_at_the_conformer_batch(
        conf, D):
    """float32: `jax.ops.segment_sum` by receiver and by sender, 1e-6
    relative (order)."""
    arr, b, _ = conf
    rng = np.random.default_rng(60 + D)
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


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("D", WIDTHS)
def test_csr_sum_matches_pallas_at_the_conformer_batch(conf, D, dtype):
    """The twin against the JAX `csr_sum` (Pallas, interpret mode) at the
    conformer batch, padding rows set to 1e4 in both inputs: 1e-6 relative
    plus 1e-6 of the max (module docstring); the same sums as with the
    padding rows zeroed (never read); degree-0 nodes get 0; the gradient
    equals `jax.vjp`'s, 0 on padding edges."""
    arr, b, _ = conf
    N, E = b.n_nodes, b.n_edges
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    rng = np.random.default_rng(70 + D)
    m = _bf16(rng.normal(size=(E, D))).copy()
    e_real = int(arr["csr_row_ptr"][-1])
    m[e_real:] = 1e4
    ct = rng.normal(size=(N, D)).astype(np.float32)
    rp, recv = jnp.asarray(arr["csr_row_ptr"]), jnp.asarray(arr["receivers"])
    want, vjp = jax.vjp(lambda x: jax_csr_sum(x, rp, recv, b.max_deg, True),
                        jnp.asarray(m, jdt))
    tm = _t(m).to(tdt).requires_grad_()
    trp = _t(arr["csr_row_ptr"])
    got = csr_sum(tm, trp, _t(arr["receivers"]))
    assert got.dtype == torch.float32 and want.dtype == jnp.float32
    assert got.shape == (N, D)
    w = np.asarray(want)
    np.testing.assert_allclose(got.detach().numpy(), w, rtol=1e-6,
                               atol=1e-6 * np.abs(w).max())
    assert np.abs(w).max() < 1e3          # no padding row entered a sum
    zeroed = tm.detach().clone()
    zeroed[e_real:] = 0
    assert torch.equal(got.detach(), csr_sum_reference(zeroed, trp))
    empty = np.diff(arr["csr_row_ptr"]) == 0
    assert empty.any() and (got.detach().numpy()[empty] == 0).all()
    got.backward(_t(ct))
    d_want = np.asarray(vjp(jnp.asarray(ct))[0], np.float32)
    assert tm.grad.dtype == tdt
    np.testing.assert_array_equal(tm.grad.float().numpy(), d_want)
    assert (tm.grad.float().numpy()[e_real:] == 0).all()


# --- the card path's arguments ----------------------------------------------


def _fake_launches(monkeypatch):
    """Stub the device check to take the CUDA path on CPU tensors and both
    modules' launchers to record (symbol, args), checking the count of
    arguments against the C signature's; returns the list of calls."""
    import importlib
    monkeypatch.setattr(_build, "on_card", lambda t, name: True)
    calls = []
    for name in ("edge_combine", "pair_segment_sum", "csr_sum"):
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
def test_wrappers_pass_their_shapes_to_the_kernel(conf, monkeypatch, dtype):
    """Each public wrapper launches once with exactly its C signature's
    arguments: N, E, D, then 0 (the kernel picks 32-bit or 64-bit indices,
    and row 7 its path, itself), the stream last; the pair sum's two
    outputs are separate allocations; row 7's output is float32; each
    launch is counted once."""
    arr, b, _ = conf
    calls = _fake_launches(monkeypatch)
    D = WIDTHS[0]
    x = torch.zeros(b.n_edges, D, dtype=dtype)
    h = torch.zeros(b.n_nodes, D, dtype=dtype)
    before = (edge_combine.launches, pair_segment_sum.launches,
              csr_sum.launches)
    edge_combine(h, h, x, _t(arr["receivers"]), _t(arr["senders"]))
    d_hd, d_hs = pair_segment_sum(x, _t(arr["csr_row_ptr"]),
                                  _t(arr["csc_row_ptr"]),
                                  _t(arr["csc_perm"]))
    s = csr_sum(x, _t(arr["csr_row_ptr"]))
    suffix = "f32" if dtype == torch.float32 else "bf16"
    (s6, a6), (s5, a5), (s7, a7) = calls
    assert (s6, s5, s7) == (f"edge_combine_{suffix}",
                            f"pair_segment_sum_{suffix}",
                            f"csr_sum_{suffix}")
    assert a6[6:] == (b.n_nodes, b.n_edges, D, 0, 7)
    assert a5[6:] == (b.n_nodes, b.n_edges, D, 0, 7)
    assert a5[4:6] == (d_hd.data_ptr(), d_hs.data_ptr())
    assert d_hd.shape == d_hs.shape == (b.n_nodes, D)
    assert a7[2:] == (s.data_ptr(), b.n_nodes, b.n_edges, D, 0, 7)
    assert s.dtype == torch.float32 and s.shape == (b.n_nodes, D)
    assert (edge_combine.launches, pair_segment_sum.launches,
            csr_sum.launches) == tuple(n + 1 for n in before)


def _bond_batch():
    """Port arrays and bucket of 12 molecules' bond graphs (in-degree up
    to 4)."""
    ds = SyntheticMolecules(12, **DATA)
    graphs = [ds.graph2d(i) for i in range(12)]
    b = bucket_for(graphs, 12)
    return batch_graphs(graphs, b), b


@pytest.mark.parametrize("side", ["stream", "walk"])
def test_csr_sum_passes_its_shape_on_either_side_of_the_path_rule(
        conf, monkeypatch, side):
    """Row 7's launcher picks its path from N, E and D (the stream where
    E >= 8 N, the walk below): on either side, the conformer batch (E =
    11 N) and a batch of bond graphs (E = 2 N), the wrapper passes the
    batch's N, E (padding edges counted), D, 0 and the stream, once per
    call."""
    arr, b = conf[:2] if side == "stream" else _bond_batch()
    N, E = b.n_nodes, b.n_edges
    assert (E >= 8 * N) == (side == "stream")
    calls = _fake_launches(monkeypatch)
    before = csr_sum.launches
    for D in WIDTHS:
        csr_sum(torch.zeros(E, D), _t(arr["csr_row_ptr"]))
    assert [(sym, args[3:]) for sym, args in calls] == [
        ("csr_sum_f32", (N, E, D, 0, 7)) for D in WIDTHS]
    assert csr_sum.launches == before + len(WIDTHS)


@pytest.mark.parametrize("row", ["edge_combine", "pair_segment_sum",
                                 "csr_sum"])
def test_launch_forces_64bit_indices(conf, monkeypatch, row):
    """`_launch(..., wide=True)`, the card check's way to the 64-bit path,
    passes 1 in the index-width argument."""
    import importlib
    arr, b, _ = conf
    calls = _fake_launches(monkeypatch)
    mod = importlib.import_module(f"infomax3d_tpu_torch.ops.kernels.{row}")
    x = torch.zeros(b.n_edges, WIDTHS[0])
    if row == "edge_combine":
        h = torch.zeros(b.n_nodes, WIDTHS[0])
        mod._launch(h, h, x, _t(arr["receivers"]), _t(arr["senders"]),
                    wide=True)
    elif row == "pair_segment_sum":
        mod._launch(x, _t(arr["csr_row_ptr"]), _t(arr["csc_row_ptr"]),
                    _t(arr["csc_perm"]), wide=True)
    else:
        mod._launch(x, _t(arr["csr_row_ptr"]), wide=True)
    (_, args), = calls
    assert args[-2:] == (1, 7)


def test_edge_combine_refuses_edges_without_nodes(monkeypatch):
    """E > 0 with N = 0: every id is out of range and the kernel has no
    row to clamp an address to, so the launch raises."""
    _fake_launches(monkeypatch)
    x = torch.zeros(4, WIDTHS[0])
    h = torch.zeros(0, WIDTHS[0])
    ids = torch.zeros(4, dtype=torch.int32)
    with pytest.raises(ValueError, match="no nodes"):
        edge_combine(h, h, x, ids, ids)
