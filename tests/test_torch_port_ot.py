"""The OT slice on the CPU: the receiver gather and the segment ops, the
GeoMol featurization (with the port's own cycle basis), `ot_collate`, the
geometry, the neighbourhood transformer, the `PNAGNNRandomEdgeUpdate`
backbone, the OT model's cost matrix and losses with their gradients, the
exact EMD and one whole OT step (cost pass, EMD, gradient pass, clip,
Adam), each against the JAX package.  Small sizes: hidden 16, 2 layers, 2
model and 3 true conformers, 5 molecule-like graphs of 6-16 atoms; every
input, weight and random draw comes from numpy seeds.

The JAX model draws its noise with `jax.random.normal` / `uniform`; the
tests hand it numpy draws instead (`_replay`: those two functions,
patched while a JAX pass runs, return the next draw when called from the
OT model's own modules) and hand the same draws to the port
(`ReplayNoise`).  Nothing in the JAX package changes.

Tolerances, each with its reason and its reading on this data.  A leaf's
error is its max |port - ref| over its max |ref|.

* `gather_dst`: the value is a gather (exact).  Its gradient against
  `jax.vjp` of the JAX `gather_dst` on the JAX CSR batch, whose CPU
  backward is `sorted_segment_sum` (float32 prefix-sum differences):
  float32 within 1e-6 of the max (reading 3.1e-7), bf16 within one bf16
  ulp (2**-7) of the max (reading 0: a prefix difference can round to the
  neighbouring bf16 value, none did here).
* `segment_sum` / `segment_mean` against `jax.ops.segment_sum` and the
  JAX `segment_mean`: the same float32 sums (index order): 1e-6.
* Geometry, forward and gradient (a random cotangent) in float32: 1e-5 of
  the max (readings at most 8.8e-8 forward, 2.0e-7 gradient);
  `signed_volume` forward exact.
* The transformer block, forward and every gradient leaf: 1e-5 of the max
  (readings 2.2e-7 and 3.1e-7); flax's LayerNorm takes the variance as
  E[x^2] - E[x]^2, torch's in two passes.
* The backbone, forward and every gradient leaf: 1e-5 (readings 2.3e-7,
  3.0e-6).
* The cost matrix: 1e-5 of its max (reading 2.4e-7), the same entries at
  `BIG`.  The losses: 1e-5 relative (readings 1.2e-7 `ot_emd`, 2.4e-7
  implicit MLE).  Every gradient leaf: 5e-3 (worst readings 6.4e-4 and
  4.0e-4, both in `c_mlp`, whose coefficients reach the loss through the
  2x2 inverse of each pair's torsion system, divided by its determinant;
  the backbones' leaves below 1.6e-4); the whole gradient within 1e-5
  (L2, readings 1.4e-6 and 2.7e-6).  No
  comparison sits on a sign tie: the batch has no chiral tags, so
  `signed_volume`'s sign never reaches the cost, and the min / max over
  hydrogen permutations and conformers split their gradient evenly among
  exact ties on both sides, so no float64 witness was needed.
* The whole step: the JAX trainer's own `_attach_ot_plans` and
  `loss_fn`, then the clip and `GroupedOptimizer` of its jitted update;
  the port's step fed the JAX plans.  Loss 1e-5, each clipped leaf 5e-3;
  the port's Adam on the JAX step's clipped gradients within 1e-6 of each
  updated leaf's max (on its own gradients the update differs by up to
  7.9e-6, where a gradient entry is near Adam's eps of 1e-8 and the
  update g / (|g| + eps) magnifies its rounding).  The port's own plans
  from its own cost equal the JAX plans to 1e-6.
"""
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from infomax3d_tpu.data.loader import get_collate
from infomax3d_tpu.graphs.batch import BucketSpec as JaxBucket
from infomax3d_tpu.models.attention import \
    TransformerEncoderBlock as JaxTransformer
from infomax3d_tpu.models.optimal_transport import \
    OptimalTransportModel as JaxOT
from infomax3d_tpu.models.random_variants import \
    PNAGNNRandomEdgeUpdate as JaxBackbone
from infomax3d_tpu.ops import geomol_geometry as jgeo
from infomax3d_tpu.ops import mailbox
from infomax3d_tpu.ops import segment as jseg
from infomax3d_tpu_torch.data.geomol_featurize import (cycle_basis,
                                                       geomol_featurize)
from infomax3d_tpu_torch.data.loader import OT_KEYS, ot_collate, to_ot_batch
from infomax3d_tpu_torch.data.synthetic import SyntheticMolecules
from infomax3d_tpu_torch.graphs.batch import bucket_for
from infomax3d_tpu_torch.interop import (init_jax_variables, load_variables,
                                         params_from_jax)
from infomax3d_tpu_torch.models.attention import (TransformerEncoderBlock,
                                                  masked_softmax)
from infomax3d_tpu_torch.models.optimal_transport import (
    BIG, OptimalTransportModel)
from infomax3d_tpu_torch.models.noise import GeneratorNoise, ReplayNoise
from infomax3d_tpu_torch.models.random_variants import PNAGNNRandomEdgeUpdate
from infomax3d_tpu_torch.ops import geomol_geometry as geo
from infomax3d_tpu_torch.ops.aggregate import gather_dst
from infomax3d_tpu_torch.ops.kernels import csr_segment_sum
from infomax3d_tpu_torch.ops.segment import segment_mean, segment_sum
from infomax3d_tpu_torch.train.ot import OTStep, exact_emd, ot, ot_plans

H, C, T, RVD, LAYERS = 16, 2, 3, 4, 2
GNN = {"hidden_dim": H, "mid_batch_norm": False, "last_batch_norm": False,
       "readout_batchnorm": True, "batch_norm_momentum": 0.1,
       "dropout": 0.0, "propagation_depth": LAYERS, "aggregators": ["sum"],
       "scalers": ["identity"], "pretrans_layers": 2, "posttrans_layers": 2,
       "residual": False}
HP = {"alpha_mlp": {"n_layers": 2}, "c_mlp": {"n_layers": 1},
      "coord_pred": {"n_layers": 2}, "d_mlp": {"n_layers": 1},
      "encoder": {"n_head": 2}, "global_transformer": False,
      "h_mol_mlp": {"n_layers": 1}, "loss_type": "ot_emd", "hidden_dim": H,
      "n_model_confs": C, "n_true_confs": T, "random_alpha": False,
      "random_vec_dim": RVD, "random_vec_std": 1.0, "teacher_force": False}
MP = {"gnn_model": "PNAGNNRandomEdgeUpdate", "gnn_params": GNN,
      "hyperparams": HP}
B = 5
DATA = dict(seed=3, n_min=6, n_max=16)


def _t(x):
    return torch.from_numpy(np.array(x))


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _items(num=B, seed=3, n_min=6, n_max=16, confs=T):
    ds = SyntheticMolecules(num, seed=seed, n_min=n_min, n_max=n_max,
                            num_conformers=confs)
    return [{"graph2d": m, "conformers3d": [{"coords": c}
                                            for c in m["conformers"]]}
            for m in ds.mols]


@pytest.fixture(scope="module")
def data():
    """One OT batch built by both collates: (port arrays, bucket, port
    `OTBatch`, the JAX `GraphBatch`); the bucket has one padding graph."""
    items = _items()
    b = bucket_for([it["graph2d"] for it in items], B + 1)
    arr = ot_collate(items, b, n_true_confs=T)
    jb = get_collate("ot_collate")(items, JaxBucket(
        b.n_graphs, b.n_nodes, b.n_edges, max_deg=b.max_deg, csr=True,
        nmax=b.nmax), n_true_confs=T)["graph"]
    return arr, b, to_ot_batch(arr, b, "cpu"), jb


def _draws(arr, seed=0):
    """The noise of one OT pass, in the JAX model's order: per model
    conformer the node and edge noise of `gnn`, then of `gnn2`; then the
    two frames' uniform vectors."""
    rng = np.random.default_rng(seed)
    N, E, P = (arr["node_feat"].shape[0], arr["senders"].shape[0],
               arr["dp_x"].shape[0])
    out = []
    for _ in range(2 * C):
        out.append(("normal", rng.normal(size=(N, RVD)).astype(np.float32)))
        out.append(("normal", rng.normal(size=(E, RVD)).astype(np.float32)))
    return out + [("uniform", rng.random((P, C, 3)).astype(np.float32))
                  for _ in range(2)]


_OWN = ("random_variants.py", "geomol_geometry.py")


class _replay:
    """While active, `jax.random.normal` / `uniform` called from the JAX
    OT model's modules return the next of `draws` (kind and shape
    checked); every other caller (flax's parameter shape checks) gets the
    real function.  On exit every draw must have been used."""

    def __init__(self, draws):
        self.draws, self.used = draws, 0

    def _fake(self, kind, real):
        def fn(key, shape=(), *args, **kwargs):
            if not sys._getframe(1).f_code.co_filename.endswith(_OWN):
                return real(key, shape, *args, **kwargs)
            k, v = self.draws[self.used]
            assert (k, v.shape) == (kind, tuple(shape)), (self.used, kind)
            self.used += 1
            return jnp.asarray(v)
        return fn

    def __enter__(self):
        self.real = jax.random.normal, jax.random.uniform
        jax.random.normal = self._fake("normal", self.real[0])
        jax.random.uniform = self._fake("uniform", self.real[1])
        return self

    def __exit__(self, *exc):
        jax.random.normal, jax.random.uniform = self.real
        if exc[0] is None:
            assert self.used == len(self.draws), (self.used, len(self.draws))


def _port_noise(draws):
    return ReplayNoise([(k, _t(v)) for k, v in draws])


def _jax_tree(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def _torch_named(jax_grads):
    return {n: v.numpy() for n, v in params_from_jax(
        jax.tree_util.tree_map(np.asarray, jax_grads), {}).items()}


# --- segment ops and the receiver gather -----------------------------------

def test_segment_sum_and_mean_match_jax(data):
    """Sums by graph id with padding ids (G) dropped, and their means."""
    arr, b, _, _ = data
    x = np.random.default_rng(1).normal(size=(b.n_nodes, 3, 4)).astype(
        np.float32)
    ids, G = arr["node_graph"], b.n_graphs
    want = jax.ops.segment_sum(x, ids, num_segments=G)
    got = segment_sum(_t(x), _t(ids), G)
    assert got.shape == (G, 3, 4) and _rel(got, want) <= 1e-6
    x2 = x.reshape(b.n_nodes, -1)
    assert _rel(segment_mean(_t(x2), _t(ids), G),
                jseg.segment_mean(x2, ids, G)) <= 1e-6
    assert (segment_sum(_t(x), _t(ids), G).numpy()[B:] == 0).all()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gather_dst_matches_jax(data, dtype):
    """The receiver gather's value and its gradient (the CSR segment sum)
    against `jax.vjp` of the JAX `gather_dst` (module docstring)."""
    arr, b, batch, jb = data
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    rng = np.random.default_rng(2)
    h = np.asarray(jnp.asarray(rng.normal(size=(b.n_nodes, 24)), jdt),
                   np.float32)
    ct = np.asarray(jnp.asarray(rng.normal(size=(b.n_edges, 24)), jdt),
                    np.float32)
    want, vjp = jax.vjp(lambda x: mailbox.gather_dst(jb, x),
                        jnp.asarray(h, jdt))
    th = _t(h).to(tdt).requires_grad_()
    got = gather_dst(batch.graph, th)
    np.testing.assert_array_equal(got.detach().float().numpy(),
                                  np.asarray(want, np.float32))
    got.backward(_t(ct).to(tdt))
    w = np.asarray(vjp(jnp.asarray(ct, jdt))[0], np.float32)
    assert th.grad.dtype == tdt
    assert _rel(th.grad.float(), w) <= (1e-6 if dtype == "float32"
                                        else 2.0 ** -7)
    assert torch.equal(th.grad, csr_segment_sum(_t(ct).to(tdt),
                                                batch.graph.csr_row_ptr))


def test_gather_dst_takes_the_card_path(data, monkeypatch):
    """With the device check stubbed to take the CUDA path on CPU tensors:
    a raw launch given a tensor that requires grad raises before anything
    is built; the receiver gather's backward launches the CSR segment sum
    once (from the CSR sum's library), in the cotangent's type, with its C
    signature's arguments (N, E, D, then 0: the kernel picks its index
    width), and counts it."""
    import importlib
    from infomax3d_tpu_torch.ops.kernels import _build
    _, b, batch, _ = data
    mod = importlib.import_module(
        "infomax3d_tpu_torch.ops.kernels.csr_segment_sum")
    monkeypatch.setattr(_build, "on_card", lambda t, name: True)
    rp = batch.graph.csr_row_ptr
    with pytest.raises(RuntimeError, match="not differentiable"):
        mod._launch(torch.zeros(b.n_edges, 8, requires_grad=True), rp)
    launched = []

    def fake_launcher(name, symbol, argtypes):
        def fn(*args):
            assert len(args) == len(argtypes)
            launched.append((name, symbol, args[3:]))
            return 0
        return fn
    monkeypatch.setattr(mod, "launcher", fake_launcher)
    monkeypatch.setattr(mod, "stream_of", lambda t: 0)
    before = csr_segment_sum.launches
    h = torch.zeros(b.n_nodes, 8, requires_grad=True)
    gather_dst(batch.graph, h).sum().backward()
    assert launched == [("csr_sum", "csr_segment_sum_f32",
                         (b.n_nodes, b.n_edges, 8, 0, 0))]
    assert csr_segment_sum.launches == before + 1


# --- featurization and the collate ------------------------------------------

def _digraph_cycles(senders, receivers, n):
    import networkx as nx
    G = nx.DiGraph()
    G.add_nodes_from(range(n))
    G.add_edges_from(zip(map(int, senders), map(int, receivers)))
    return [list(c) for c in nx.cycle_basis(nx.to_undirected(G))]


@pytest.mark.parametrize("kind", ["molecules", "random digraphs"])
def test_cycle_basis_matches_networkx(kind):
    """The port's `cycle_basis` is networkx's, cycle for cycle and in
    order: on ring-bearing synthetic molecules (up to 60 atoms), and on
    random directed multigraphs with self loops and one-way edges."""
    cases = []
    if kind == "molecules":
        for seed in range(8):
            ds = SyntheticMolecules(25, seed=seed, n_min=6, n_max=60)
            cases += [(m["senders"], m["receivers"], m["node_feat"].shape[0])
                      for m in ds.mols]
    else:
        rng = np.random.default_rng(0)
        for _ in range(200):
            n = int(rng.integers(3, 70))
            e = int(rng.integers(1, 3 * n))
            cases.append((rng.integers(0, n, e), rng.integers(0, n, e), n))
    with_rings = 0
    for s, r, n in cases:
        want = _digraph_cycles(s, r, n)
        assert cycle_basis(s, r, n) == want
        with_rings += bool(want)
    assert with_rings >= len(cases) // 2


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_geomol_featurize_matches_jax(seed):
    """Every array of `geomol_featurize` equals the JAX package's (which
    takes its cycle basis from networkx), on molecules with rings and on
    molecules with symmetric leaf hydrogens (atom code 0)."""
    from infomax3d_tpu.data.geomol_featurize import \
        geomol_featurize as jax_featurize
    ds = SyntheticMolecules(30, seed=seed, n_min=5, n_max=30)
    rings = perms = 0
    for m in ds.mols:
        m = dict(m, node_feat=m["node_feat"].copy())
        m["node_feat"][::3, 0] = 0                 # hydrogens
        want, got = jax_featurize(m), geomol_featurize(m)
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        rings += bool(_digraph_cycles(m["senders"], m["receivers"],
                                      m["node_feat"].shape[0]))
        perms += int((got["nbh_perms"] != got["nbh_perms"][:, :1]).any())
    assert rings > 0 and perms > 0


def test_ot_collate_matches_jax(data):
    """The graph arrays and every OT array equal the JAX `ot_collate`'s on
    the same CSR bucket (edges receiver-sorted on both sides)."""
    arr, b, batch, jb = data
    for k in OT_KEYS:
        want = np.asarray(jb.extras[k])
        assert arr[k].dtype == want.dtype, k
        np.testing.assert_array_equal(arr[k], want, err_msg=k)
    for k in ("senders", "receivers", "edge_feat", "node_feat",
              "node_graph", "csr_row_ptr"):
        np.testing.assert_array_equal(
            arr[k], np.asarray(getattr(jb, k, None) if k not in jb.extras
                               else jb.extras[k]), err_msg=k)
    assert set(batch.ex) == set(OT_KEYS)
    assert (arr["pos_mask"][:B] == 1).all() and (arr["pos_mask"][B:] == 0
                                                 ).all()


# --- geometry and the transformer ------------------------------------------

def _geometry_cases(rng):
    f = lambda *s: rng.normal(size=s).astype(np.float32)  # noqa: E731
    mask = (rng.random((7, 4)) < 0.8).astype(np.float32)
    mask[:, :2] = 1.0
    onehot = np.eye(4, dtype=np.float32)[rng.integers(0, 4, 6)]
    return {
        "safe_norm": ((f(5, 3, 3),), (f(5, 3, 3),), {}),
        "distance_metrics_4d": ((f(7, 4, 2, 3), mask),
                                (f(7, 4, 2, 3),), {"diff": (0,)}),
        "distance_metrics_5d": ((f(7, 6, 4, 2, 3), mask),
                                (f(7, 6, 4, 2, 3),), {"diff": (0,)}),
        "angles_4d": ((f(7, 4, 2, 3), mask), (f(7, 4, 2, 3),),
                      {"diff": (0,)}),
        "angles_5d": ((f(7, 6, 4, 2, 3), mask), (f(7, 6, 4, 2, 3),),
                      {"diff": (0,)}),
        "dihedrals": (tuple(f(6, 9, 2, 3) for _ in range(4)), None,
                      {"diff": (0, 1, 2, 3)}),
        "von_mises": ((np.tanh(f(6, 5)), np.tanh(f(6, 5))), None,
                      {"diff": (0, 1)}),
        "von_mises_sin": ((f(6, 5), f(6, 5), f(6, 5), f(6, 5)), None,
                          {"diff": (0, 1, 2, 3)}),
        "rotation_matrix_v2": ((f(6, 4, 2, 3), onehot,
                                rng.random((6, 2, 3)).astype(np.float32)),
                               None, {"diff": (0,)}),
        "alpha_rotation": ((f(6, 2), f(6, 2)), None, {"diff": (0, 1)}),
    }


def _geometry_fns(name):
    """(JAX function, port function) of each case; the JAX frame takes its
    auxiliary vector from a key, so `rotation_matrix_v2` replays the same
    uniform draw into it."""
    if name == "rotation_matrix_v2":
        def jfn(c, m, eta):
            with _replay([("uniform", np.asarray(eta))]):
                return jgeo.rotation_matrix_v2(c, m, jax.random.key(0))
        return jfn, geo.rotation_matrix_v2
    return {
        "safe_norm": (jgeo.safe_norm, geo.safe_norm),
        "distance_metrics_4d": (jgeo.batch_distance_metrics_from_coords,
                                geo.batch_distance_metrics_from_coords),
        "distance_metrics_5d": (jgeo.batch_distance_metrics_from_coords,
                                geo.batch_distance_metrics_from_coords),
        "angles_4d": (jgeo.batch_angles_from_coords,
                      geo.batch_angles_from_coords),
        "angles_5d": (jgeo.batch_angles_from_coords,
                      geo.batch_angles_from_coords),
        "dihedrals": (jgeo.batch_dihedrals, geo.batch_dihedrals),
        "von_mises": (jgeo.von_mises_loss, geo.von_mises_loss),
        "von_mises_sin": (jgeo.von_mises_loss, geo.von_mises_loss),
        "alpha_rotation": (jgeo.build_alpha_rotation,
                           geo.build_alpha_rotation),
    }[name]


@pytest.mark.parametrize("name", sorted(_geometry_cases(
    np.random.default_rng(0))))
def test_geometry_matches_jax(name):
    """Each geometry function's value and its gradient under a random
    cotangent, against the JAX package's (1e-5 of the max)."""
    rng = np.random.default_rng(4)
    args, _, spec = _geometry_cases(rng)[name]
    jfn, tfn = _geometry_fns(name)
    diff = spec.get("diff", tuple(range(len(args))))
    want, vjp = jax.vjp(lambda *d: jfn(*[d[diff.index(i)] if i in diff
                                         else jnp.asarray(a)
                                         for i, a in enumerate(args)]),
                        *[jnp.asarray(args[i]) for i in diff])
    targs = [_t(a).requires_grad_(i in diff) for i, a in enumerate(args)]
    got = tfn(*targs)
    want_l = list(want) if isinstance(want, tuple) else [want]
    got_l = list(got) if isinstance(got, tuple) else [got]
    cts = [rng.normal(size=np.shape(w)).astype(np.float32) for w in want_l]
    for g, w in zip(got_l, want_l):
        assert _rel(g.detach(), w) <= 1e-5
    torch.autograd.backward(got_l, [_t(c) for c in cts])
    d_want = vjp(tuple(jnp.asarray(c) for c in cts) if isinstance(want, tuple)
                 else jnp.asarray(cts[0]))
    for i, dw in zip(diff, d_want):
        assert _rel(targs[i].grad, dw) <= 1e-5, (name, i)


def test_signed_volume_matches_jax():
    """`signed_volume` is a sign: equal to the JAX package's, values in
    {-1, 0, 1} (a degenerate tetrahedron reads 0)."""
    c = np.random.default_rng(5).normal(size=(9, 4, 3, 3)).astype(np.float32)
    c[0, :, 0] = 0.0
    got = geo.signed_volume(_t(c)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jgeo.signed_volume(c)))
    assert got[0, 0] == 0 and set(np.unique(got)) <= {-1.0, 0.0, 1.0}


def test_transformer_block_matches_jax():
    """`TransformerEncoderBlock` (2 heads, feed-forward 3/2 of the width)
    against the JAX block from the same weights: the output and every
    parameter's gradient, with a key mask that leaves one sequence no
    valid key (its softmax row is zero, not uniform)."""
    rng = np.random.default_rng(6)
    D, F = 2 * H, 3 * H
    x = rng.normal(size=(12, 4, D)).astype(np.float32)
    mask = rng.random((12, 4)) < 0.7
    mask[0] = False
    mask[1:, 0] = True
    enc = init_jax_variables(MP, 2, "OptimalTransportModel")[0]["encoder"]
    jm = JaxTransformer(D, 2, F, dropout=0.0)
    ct = rng.normal(size=x.shape).astype(np.float32)
    want, vjp = jax.vjp(lambda p: jm.apply({"params": p}, jnp.asarray(x),
                                           jnp.asarray(mask)),
                        _jax_tree(enc))
    tm = TransformerEncoderBlock(D, 2, F)
    tm.load_state_dict(params_from_jax(enc, {}), strict=True)
    got = tm(_t(x), _t(mask))
    assert _rel(got.detach(), want) <= 1e-5
    got.backward(_t(ct))
    jg = _torch_named(vjp(jnp.asarray(ct))[0])
    for n, p in tm.named_parameters():
        assert _rel(p.grad, jg[n]) <= 1e-5, n
    scores = torch.randn(3, 4)
    m = torch.tensor([[True, False, True, False], [False] * 4, [True] * 4])
    out = masked_softmax(scores, m)
    assert (out[1] == 0).all() and (out[0, [1, 3]] == 0).all()
    assert torch.allclose(out[[0, 2]].sum(-1), torch.ones(2))


def test_backbone_matches_jax(data):
    """`PNAGNNRandomEdgeUpdate` (2 layers, [sum], 2-layer pre- and
    posttrans) from the same weights and noise: node embeddings and every
    parameter's gradient under a random cotangent (1e-5)."""
    arr, b, batch, jb = data
    gp = dict(GNN, random_vec_dim=RVD, random_vec_std=1.0)
    tree = init_jax_variables(MP, 3, "OptimalTransportModel")[0]["gnn"]
    draws = _draws(arr, 7)[:2]
    ct = np.random.default_rng(8).normal(size=(b.n_nodes, H)).astype(
        np.float32)
    jm = JaxBackbone(**{k: v for k, v in gp.items()
                        if k in PNAGNNRandomEdgeUpdate.FIELDS})
    with _replay(draws):
        want, vjp = jax.vjp(lambda p: jm.apply(
            {"params": p}, jb, deterministic=False,
            rngs={"random": jax.random.key(0)}), _jax_tree(tree))
        d_want = _torch_named(vjp(jnp.asarray(ct))[0])
    tm = PNAGNNRandomEdgeUpdate.from_config(gp)
    tm.load_state_dict(params_from_jax(tree, {}), strict=True)
    got = tm(batch.graph, _port_noise(draws))
    assert _rel(got.detach(), want) <= 1e-5
    got.backward(_t(ct))
    for n, p in tm.named_parameters():
        assert _rel(p.grad, d_want[n]) <= 1e-5, n


# --- the OT model -----------------------------------------------------------

def _jax_model():
    return JaxOT(hyperparams=HP, gnn_params=GNN,
                 gnn_model="PNAGNNRandomEdgeUpdate")


def _port_model(variables):
    return load_variables(OptimalTransportModel.from_config(MP), variables)


@pytest.fixture(scope="module")
def variables():
    params, stats = init_jax_variables(MP, 1, "OptimalTransportModel")
    return {"params": params, "batch_stats": stats}


def test_init_has_the_flax_layout(data, variables):
    """The seeded OT trees have the flax `init` tree's paths and shapes
    (no batch statistics) and load strictly into the port's model, each
    flax leaf under its name in the table of `interop.py` (Dense kernels
    transposed).  The JAX package's `convert_state_dict` has no rule for a
    GeoMol MLP's ``Dense_{k}``, which keeps its flax name here."""
    from flax import traverse_util
    _, _, _, jb = data
    tmpl = jax.eval_shape(lambda: _jax_model().init(
        {"params": jax.random.key(0), "random": jax.random.key(1)}, jb))
    assert "batch_stats" not in tmpl and variables["batch_stats"] == {}
    flat_t = traverse_util.flatten_dict(tmpl["params"])
    flat_p = traverse_util.flatten_dict(variables["params"])
    assert {k: tuple(v.shape) for k, v in flat_t.items()} == \
        {k: v.shape for k, v in flat_p.items()}
    sd = _port_model(variables).state_dict()
    names = {("gnn", "mp_1", "node_in", "kernel"):
             "gnn.mp_layers.1.node_in.weight",
             ("gnn2", "mp_0", "edge_eps"): "gnn2.mp_layers.0.edge_eps",
             ("gnn", "mp_0", "posttrans_2", "FCLayer_1", "Dense_0", "bias"):
             "gnn.mp_layers.0.posttrans_2.fully_connected.1.linear.bias",
             ("gnn2", "atom_encoder", "encoder", "emb_3"):
             "gnn2.atom_encoder.atom_embedding_list.3.weight",
             ("encoder", "norm1", "scale"): "encoder.norm1.weight",
             ("encoder", "self_attn", "in_proj", "kernel"):
             "encoder.self_attn.in_proj.weight",
             ("alpha_mlp", "Dense_2", "kernel"): "alpha_mlp.Dense_2.weight"}
    for path, name in names.items():
        v = flat_p[path]
        np.testing.assert_array_equal(sd[name].numpy(),
                                      v.T if path[-1] == "kernel" else v)
    assert len(sd) == len(flat_p)


def _jax_apply(jb, variables, draws, **kw):
    with _replay(draws):
        return _jax_model().apply(
            {"params": _jax_tree(variables["params"])}, jb,
            deterministic=True, rngs={"random": jax.random.key(0)}, **kw)


@pytest.fixture(scope="module")
def costs(data, variables):
    """The masked cost of one pass on both sides, from the same draws."""
    arr, _, batch, jb = data
    draws = _draws(arr)
    want = np.asarray(jax.jit(lambda: _jax_apply(
        jb, variables, draws, return_cost_matrix=True))())
    with torch.no_grad():
        got = _port_model(variables)(batch, _port_noise(draws),
                                     return_cost_matrix=True).numpy()
    return want, got, draws


def test_cost_matrix_matches_jax(data, costs):
    arr, _, _, _ = data
    want, got, _ = costs
    assert got.shape == want.shape == (T, C, B + 1)
    big = want >= BIG / 2
    np.testing.assert_array_equal(got >= BIG / 2, big)
    assert big[:, :, B].all() and not big[:, :, :B].any()
    assert _rel(got[~big], want[~big]) <= 1e-5


def _grad_errors(got: dict, want: dict):
    leaf = {n: _rel(got[n], want[n]) for n in want}
    fa = np.concatenate([got[n].ravel() for n in want])
    fb = np.concatenate([want[n].ravel() for n in want])
    return leaf, float(np.linalg.norm(fa - fb) / np.linalg.norm(fb))


@pytest.mark.parametrize("loss_type", ["ot_emd", "implicit_mle"])
def test_loss_and_gradients_match_jax(data, variables, costs, loss_type):
    """The loss and every gradient leaf: `ot_emd` with the plans of the
    JAX cost (both sides the same plans), and the implicit-MLE bound."""
    arr, _, batch, jb = data
    want_cost, _, draws = costs
    kw, tkw = {}, {}
    if loss_type == "ot_emd":
        plans = ot_plans(want_cost, arr["pos_mask"], arr["graph_mask"])
        kw, tkw = {"ot_plans": jnp.asarray(plans)}, {"ot_plans": _t(plans)}

    def loss_fn(p):
        return _jax_apply(jb, {"params": p}, draws, **kw)
    jl, jgrads = jax.jit(jax.value_and_grad(loss_fn))(variables["params"])
    m = _port_model(variables)
    loss = m(batch, _port_noise(draws), **tkw)
    loss.backward()
    assert abs(float(loss.detach()) - float(jl)) <= 1e-5 * abs(float(jl))
    got = {n: p.grad.numpy() for n, p in m.named_parameters()}
    want = _torch_named(jgrads)
    assert set(got) == set(want)
    leaf, l2 = _grad_errors(got, want)
    worst = max(leaf, key=leaf.get)
    assert leaf[worst] <= 5e-3, (worst, leaf[worst])
    assert l2 <= 1e-5


def test_exact_emd_matches_jax():
    """`exact_emd` on random costs and marginals (square and rectangular)
    gives the JAX trainer's plans; the plans meet their marginals."""
    from infomax3d_tpu.train.trainer import exact_emd as jax_emd
    rng = np.random.default_rng(9)
    for nt, nm in ((3, 3), (2, 5), (7, 10), (10, 10)):
        cost = rng.random((nt, nm)) * 10
        a, b = np.ones(nt) / nt, np.ones(nm) / nm
        got = exact_emd(cost, a, b)
        np.testing.assert_allclose(got, jax_emd(cost, a, b), atol=1e-9)
        np.testing.assert_allclose(got.sum(1), a, atol=1e-9)
        np.testing.assert_allclose(got.sum(0), b, atol=1e-9)


# --- the whole step ---------------------------------------------------------

def _jax_step(jb, variables, draws, lr):
    """One JAX OT step from its trainer's parts: `_attach_ot_plans` (the
    jitted cost pass and the host EMD) and `loss_fn` under
    `value_and_grad` on a bare `OptimalTransportTrainer`, then its jitted
    update's clip and `GroupedOptimizer` Adam.  Returns the plans, the
    loss, the clipped gradients and the updated parameters, in the
    port's names."""
    from infomax3d_tpu.train.optim import GroupedOptimizer, label_params
    from infomax3d_tpu.train.trainer import OptimalTransportTrainer
    tr = OptimalTransportTrainer.__new__(OptimalTransportTrainer)
    tr.models, tr.args, tr._epoch = {"model": _jax_model()}, {}, 1
    params = {"model": _jax_tree(variables["params"])}
    tr.state = types.SimpleNamespace(params=params,
                                     batch_stats={"model": {}})
    key = jax.random.key(0)
    with _replay(draws):
        batch = tr._attach_ot_plans({"graph": jb}, key)
    with _replay(draws):
        loss, grads = jax.jit(jax.value_and_grad(lambda p: tr.loss_fn(
            p, {"model": {}}, batch, 0, key, True)[0]))(params)
    gnorm = jnp.sqrt(sum(jnp.sum(x * x)
                         for x in jax.tree_util.tree_leaves(grads)))
    scale = jnp.minimum(1.0, tr.GRAD_CLIP / (gnorm + 1e-6))
    grads = jax.tree_util.tree_map(lambda x: x * scale, grads)
    labels, _ = label_params(params)
    opt = GroupedOptimizer(labels, name="Adam", lr=lr)
    lrs = np.zeros(4, np.float32)
    lrs[:2] = lr
    upd, _ = opt.update(grads, opt.init(params), params, lrs)
    new = jax.tree_util.tree_map(lambda p, u: p + u, params, upd)
    return (np.asarray(batch["_ot_plans"]), float(loss), float(gnorm),
            _torch_named(grads["model"]), _torch_named(new["model"]))


def test_ot_step_matches_jax_step(data, variables, costs):
    """The port's step against the JAX trainer's (module docstring): its
    own plans from its own cost pass, then, fed the JAX plans, the loss,
    the clipped gradients and the Adam update."""
    arr, _, batch, jb = data
    _, port_cost, draws = costs
    lr = 1e-3
    plans, jl, gnorm, jgrads, jnew = _jax_step(jb, variables, draws, lr)
    assert gnorm > 10.0       # the clip acts on this step
    step = OTStep(MP, variables, "cpu", {"lr": lr})
    own = step.plans(step.cost(batch, _port_noise(draws)), batch).numpy()
    np.testing.assert_allclose(own, plans, atol=1e-6)
    assert own.shape == (B + 1, T, C) and (own[B] == 0).all()
    np.testing.assert_allclose(own[:B].sum(axis=(1, 2)), 1.0, atol=1e-6)
    loss = step.loss_and_grads(batch, _port_noise(draws), _t(plans))
    assert abs(float(loss) - jl) <= 1e-5 * abs(jl)
    got = {n: p.grad.numpy().copy() for n, p in
           step.model.named_parameters()}
    leaf, _ = _grad_errors(got, jgrads)
    assert max(leaf.values()) <= 5e-3
    # Adam on the JAX step's clipped gradients
    for n, p in step.model.named_parameters():
        p.grad.copy_(_t(jgrads[n]))
    step.optimizer.step()
    for n, p in step.model.named_parameters():
        w = jnew[n]
        assert np.abs(p.detach().numpy() - w).max() <= \
            1e-6 * max(np.abs(w).max(), 1.0), n


def test_step_draws_once_for_both_passes(data, variables, monkeypatch):
    """`OTStep.step` draws its noise once, from the generator it is
    given: the gradient pass replays the cost pass's draws, and the
    generator has advanced by one pass's draws (42 at the configuration's
    10 model conformers; here 4 C + 2)."""
    _, _, batch, _ = data
    step = OTStep(MP, variables, "cpu", {"lr": 1e-3})
    seen = []
    real = step.loss_and_grads

    def spy(b, noise, plans=None):
        seen.append(noise)
        return real(b, noise, plans)
    monkeypatch.setattr(step, "loss_and_grads", spy)
    gen = torch.Generator().manual_seed(11)
    loss = step.step(batch, gen)
    (noise,), = [seen]
    assert isinstance(noise, ReplayNoise)
    assert noise.used == len(noise.draws) == 4 * C + 2
    ref = GeneratorNoise(torch.Generator().manual_seed(11))
    for kind, t in noise.draws:
        assert torch.equal(t, getattr(ref, kind)(t.shape))
    assert np.isfinite(float(loss))


def test_replay_noise_refuses_other_draws():
    noise = ReplayNoise([("normal", torch.zeros(2, 3))])
    with pytest.raises(RuntimeError, match="asked for uniform"):
        noise.uniform((2, 3))
    with pytest.raises(RuntimeError, match="asked for normal"):
        noise.normal((3, 3))
    noise.normal((2, 3))
    with pytest.raises(RuntimeError, match="no draw left"):
        noise.normal((2, 3))


@pytest.mark.parametrize("change", [
    {"gnn_model": "PNAGNNRandom"},
    {"hyperparams": dict(HP, random_alpha=True)},
    {"gnn_params": dict(GNN, hidden_dim=H + 2)},
    {"gnn_params": dict(GNN, mid_batch_norm=True)},
    {"gnn_params": dict(GNN, dropout=0.1)},
    {"gnn_model": "PNAGNNRandom", "gnn_params": dict(GNN, dropout=0.1)}])
def test_ot_model_refuses_unported_options(data, change):
    """The options the OT model once refused: the `PNAGNNRandom` backbone
    (also with dropout in its PNA layers), `random_alpha`, a backbone
    wider than the model (`gnn_output_mlp`), the edge-update layers' mid
    BatchNorm and their dropout now build and match the JAX model from
    the same weights and draws: the eval-mode cost within 1e-5 of its
    max, and the training-mode loss on that cost's plans within 1e-5
    relative (with the replayed dropout masks and the running
    statistics)."""
    from test_torch_port_ot_trainer import (_jax_apply, _port_noise,
                                            _stats_errors)
    mp = {**MP, **change}
    arr, _, batch, jb = data
    params, stats = init_jax_variables(mp, 1, "OptimalTransportModel")
    var = {"params": params, "batch_stats": stats}
    jm = JaxOT(hyperparams=mp["hyperparams"], gnn_params=mp["gnn_params"],
               gnn_model=mp["gnn_model"])
    tm = load_variables(OptimalTransportModel.from_config(mp), var)
    cost, _, rec = _jax_apply(jm, var, jb, return_cost_matrix=True)
    with torch.no_grad():
        got = tm.eval()(batch, _port_noise(rec),
                        return_cost_matrix=True).numpy()
    cost = np.asarray(cost)
    real = cost < BIG / 2
    assert _rel(got[real], cost[real]) <= 1e-5
    plans = ot_plans(cost, arr["pos_mask"], arr["graph_mask"])
    loss, new_stats, rec = _jax_apply(jm, var, jb, train=True, seed=1,
                                      ot_plans=jnp.asarray(plans))
    assert bool(rec["dropout"]) == bool(mp["gnn_params"]["dropout"])
    with torch.no_grad():
        got = tm.train()(batch, _port_noise(rec), ot_plans=_t(plans))
    assert abs(float(got) - float(loss)) <= 1e-5 * abs(float(loss))
    if new_stats:
        assert max(_stats_errors(tm, new_stats).values()) <= 1e-5


def test_ot_entry_point_on_cpu():
    """`ot()` trains on the CPU when asked: finite losses over 4 steps on
    one batch of true conformers, the batch's sizes; without `device` it
    needs the card."""
    args = {"model_parameters": MP, "optimizer_params": {"lr": 1e-3},
            "batch_size": 4, "dataset_params": DATA, "seed": 0}
    out = ot(args, steps=4, device="cpu")
    losses = out["losses"]
    assert len(losses) == 4 and np.isfinite(losses).all()
    assert out["sizes"]["graphs"] == 4 and out["sizes"]["pairs"] > 0
    assert out["batch"].ex["pos"].shape[1] == T
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            ot(args, steps=1)
