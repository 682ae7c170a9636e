"""SMP on the CPU against the JAX package: `smp_featurize`, the spherical
bases, `smp_collate` (the receiver-sorted radius graphs and the triplets'
edge ids remapped through the sort), the SMP forward, the bf16 dtype flow
and one supervised step.  Small sizes: 6 molecules of 4 to 10 atoms at a
cutoff of 5 angstrom (dense radius graphs: most pairs are in reach), SMP
hidden 8, 2 layers; every input from numpy seeds and
`init_jax_variables`, which draws every output Linear non-zero (with
``output_init: zeros`` the model's output would be 0 and hold nothing).

The featurizer's edge lists come sorted by receiver, so on real data the
batcher's sort leaves the edges where they are and the remap of the
triplet ids is the identity; `test_remap_through_a_permuting_sort`
shuffles each molecule's edge list (and its triplet ids with it) so that
the sort really moves edges, and a planted fault (the remap left out)
must fail there.

Tolerances, float32 (the worst reading on this data in brackets):
* `smp_featurize`, `smp_collate`: equal arrays (the triplets compared in
  the port's order, sorted by their edge j -> i);
* the bases: 1e-5 of each output's max [3.3e-7]; the Bessel zeros and
  normalisers equal;
* the SMP forward: 1e-5 of the output's max [1.2e-6];
* the supervised step (L1): as `test_torch_port_gin_options.check_step`
  (loss 1e-5, predictions 1e-5, each gradient leaf 1e-4 of its own max,
  `dist_emb_freq` included) [loss 2.0e-7, leaf 1.6e-5].
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from infomax3d_tpu.data import smp_featurize as jax_featurize
from infomax3d_tpu.data.loader import smp_collate as jax_smp_collate
from infomax3d_tpu.graphs.batch import BucketSpec as JaxBucket
from infomax3d_tpu.models.smp import SMP as JaxSMP
from infomax3d_tpu.ops import spherical as jax_sph
from infomax3d_tpu.train.precision import cast_floats
from infomax3d_tpu_torch.data import loader
from infomax3d_tpu_torch.data.smp_featurize import smp_featurize
from infomax3d_tpu_torch.data.synthetic import SyntheticMolecules
from infomax3d_tpu_torch.graphs.batch import BucketSpec
from infomax3d_tpu_torch.interop import init_jax_variables, load_variables
from infomax3d_tpu_torch.models.registry import build_model
from infomax3d_tpu_torch.ops import spherical as sph
from infomax3d_tpu_torch.train.precision import cast_batch, compute_params
from test_torch_port_gin_options import (check_step, jax_step, port_step,
                                         step_errors)
from test_torch_port_ot import _jax_tree, _rel

B, CUTOFF = 6, 5.0
DATA = dict(seed=2, n_min=4, n_max=10, num_targets=1)
N_CAP, E_CAP, G_CAP = 64, 512, B + 1
SMP = dict(hidden_channels=8, target_dim=1, int_emb_size=6, basis_emb_size=4,
           out_emb_size=10, num_spherical=3, num_radial=4,
           propagation_depth=2, cutoff=CUTOFF, output_init="zeros")
BASIS_TOL, FWD_TOL = 1e-5, 1e-5


def _items(num=B, **data):
    ds = SyntheticMolecules(num, **dict(DATA, **data))
    return [{"graph2d": ds.graph2d(i), "targets": ds.targets[i]}
            for i in range(num)]


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The port on one CPU thread while this file runs (at these sizes
    more threads cost CPU time and gain nothing; the test workers share
    the machine's cores)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def batches():
    """(port view, port GraphBatch, JAX GraphBatch) of the same molecules
    in buckets of the same size (the JAX one without CSR, as its CLI
    sizes SMP's)."""
    items = _items()
    view = loader.smp_collate(items, BucketSpec(
        G_CAP, N_CAP, E_CAP, max_deg=N_CAP, csr=True, nmax=10), CUTOFF)
    jb = jax_smp_collate(items, JaxBucket(G_CAP, N_CAP, E_CAP, nmax=10),
                         CUTOFF)["graph"]
    g = loader.to_device(view["graph"], "cpu")
    assert int(g.tri_mask.sum()) > 100 and not bool(g.tri_mask.all())
    return view["graph"], g, jb


@pytest.mark.parametrize("seed,cutoff", [(0, 5.0), (1, 2.5), (3, 8.0)])
def test_smp_featurize_matches_jax(seed, cutoff):
    """Every array of the port's (vectorized) featurizer equals the JAX
    package's loops on the same coordinates."""
    ds = SyntheticMolecules(4, seed=seed, n_min=3, n_max=14)
    for i in range(4):
        c = ds.graph2d(i)["coords"]
        got = smp_featurize(c, cutoff)
        want = jax_featurize.smp_featurize(c, cutoff)
        assert got.keys() == want.keys()
        for k in got:
            assert np.asarray(got[k]).dtype == np.asarray(want[k]).dtype, k
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_spherical_bases_match_jax():
    """The Bessel zeros and normalisers, j_l, the Legendre functions, the
    real harmonics, the envelope and the four bases against the JAX
    package's on random distances, angles and torsions."""
    rng = np.random.default_rng(0)
    L, K, E, T = 3, 4, 40, 90
    np.testing.assert_array_equal(sph.bessel_zeros(L, K),
                                  jax_sph.bessel_zeros(L, K))
    np.testing.assert_array_equal(sph.bessel_normalizers(L, K),
                                  jax_sph.bessel_normalizers(L, K))
    dist = rng.uniform(0.5, CUTOFF, E).astype(np.float32)
    angle = rng.uniform(0, np.pi, T).astype(np.float32)
    phi = rng.uniform(0, 2 * np.pi, T).astype(np.float32)
    idx = rng.integers(0, E + 3, T).astype(np.int32)    # some out of range
    freq = (np.arange(1, K + 1) * np.pi).astype(np.float32)
    x = np.concatenate([rng.uniform(0, 0.5, 20), rng.uniform(0.5, 12, 40)]
                       ).astype(np.float32)
    t = torch.from_numpy
    mine = {
        "spherical_jn": sph.spherical_jn(t(x), L),
        "legendre_p": sph.legendre_p(t(np.cos(angle)), L + 1),
        "real_sph_harm_m0": sph.real_sph_harm_m0(t(angle), L),
        "real_sph_harm_full": sph.real_sph_harm_full(t(angle), t(phi), L),
        "envelope": sph.envelope(t(dist / CUTOFF), 5),
        "dist_emb": sph.dist_emb(t(dist), t(freq), CUTOFF, 5),
        "bessel_rbf": sph.bessel_rbf(t(dist / CUTOFF), L, K),
        "angle_emb": sph.angle_emb(t(dist), t(angle), t(idx), L, K, CUTOFF),
        "torsion_emb": sph.torsion_emb(t(dist), t(angle), t(phi), t(idx), L,
                                       K, CUTOFF)}

    @jax.jit
    def jax_bases(x, angle, phi, dist, freq, idx):
        return {
            "spherical_jn": jax_sph.spherical_jn(x, L),
            "legendre_p": jax_sph.legendre_p(jnp.cos(angle), L + 1),
            "real_sph_harm_m0": jax_sph.real_sph_harm_m0(angle, L),
            "real_sph_harm_full": jax_sph.real_sph_harm_full(angle, phi, L),
            "envelope": jax_sph.envelope(dist / CUTOFF, 5),
            "dist_emb": jax_sph.dist_emb(dist, freq, CUTOFF, 5),
            "bessel_rbf": jax_sph.bessel_rbf(dist / CUTOFF, L, K),
            "angle_emb": jax_sph.angle_emb(dist, angle, idx, L, K, CUTOFF),
            "torsion_emb": jax_sph.torsion_emb(dist, angle, phi, idx, L, K,
                                               CUTOFF)}
    ref = jax_bases(x, angle, phi, dist, freq, idx)
    cases = {k: (mine[k], ref[k]) for k in mine}
    for name, (got, want) in cases.items():
        assert got.shape == want.shape, name
        assert _rel(got.numpy(), np.asarray(want)) <= BASIS_TOL, name
    P, Q = (sph.assoc_legendre(t(np.cos(angle)), L),
            jax_sph.assoc_legendre(np.cos(angle), L))
    assert P.keys() == Q.keys()
    assert all(_rel(P[k].numpy(), np.asarray(Q[k])) <= BASIS_TOL for k in P)


def test_smp_collate_matches_jax(batches):
    """The port's radius-graph batch equals the JAX collate's arrays (the
    featurizer's edges come receiver-sorted, so the CSR sort keeps them in
    place); its triplets are the JAX ones sorted by `idx_ji`, with row
    pointers over both edge orders."""
    view, g, jb = batches
    for k in ("node_feat", "senders", "receivers", "edge_dist", "edge_mask",
              "node_mask", "graph_mask", "coords", "snorm"):
        np.testing.assert_array_equal(view[k], np.asarray(getattr(jb, k)),
                                      err_msg=k)
    np.testing.assert_array_equal(view["targets"],
                                  np.asarray(jb.extras["targets"]))
    order = np.argsort(np.asarray(jb.extras["idx_ji"]), kind="stable")
    for k in ("angle", "torsion", "idx_kj", "idx_ji", "tri_mask"):
        np.testing.assert_array_equal(
            view[k], np.asarray(jb.extras[k])[order], err_msg=k)
    E = view["senders"].shape[0]
    np.testing.assert_array_equal(
        view["tri_ji_ptr"], np.searchsorted(view["idx_ji"], np.arange(E + 1)))
    kj = view["idx_kj"][view["tri_kj_perm"]]
    assert np.all(np.diff(kj) >= 0)
    np.testing.assert_array_equal(view["tri_kj_ptr"],
                                  np.searchsorted(kj, np.arange(E + 1)))


def _variables(mp=SMP, seed=3):
    params, stats = init_jax_variables(mp, seed, "SMP")
    for name, sub in params.items():
        if name.startswith(("init_v", "update_v")):
            assert np.abs(sub["lin"]["kernel"]).min() > 0, name
    return {"params": params, "batch_stats": stats}


def _forward(g, var, mp=SMP):
    model = load_variables(build_model("SMP", mp), var).eval()
    with torch.no_grad():
        return model(g).numpy()


@pytest.mark.parametrize("node_features", [True, False])
def test_smp_forward_matches_jax(batches, node_features):
    """The eval forward of SMP against the JAX module from the same
    weights (the flax tree's shapes first), with atom features or the
    learned node vector."""
    _, g, jb = batches
    mp = dict(SMP, use_node_features=node_features)
    var = _variables(mp)
    jm = JaxSMP(**mp)
    shapes = jax.tree_util.tree_map(np.shape, jax.eval_shape(
        jm.init, jax.random.key(0), jb))
    assert shapes["params"] == jax.tree_util.tree_map(np.shape,
                                                      var["params"])
    want = np.asarray(jax.jit(jm.apply)({"params": _jax_tree(
        var["params"])}, jb))
    assert np.abs(want).max() > 0
    assert _rel(_forward(g, var, mp), want) <= FWD_TOL


def _shuffled_featurize(rng):
    """`smp_featurize` with each molecule's edge list permuted at random
    (triplet edge ids renumbered to follow), so the batcher's receiver
    sort moves edges."""
    def featurize(coords, cutoff=5.0):
        f = smp_featurize(coords, cutoff)
        perm = rng.permutation(len(f["senders"]))
        new_id = np.empty_like(perm)
        new_id[perm] = np.arange(len(perm))
        out = dict(f, senders=f["senders"][perm],
                   receivers=f["receivers"][perm], dist=f["dist"][perm])
        out["idx_kj"] = new_id[f["idx_kj"]].astype(np.int32)
        out["idx_ji"] = new_id[f["idx_ji"]].astype(np.int32)
        return out
    return featurize


def test_remap_through_a_permuting_sort(batches, monkeypatch):
    """With shuffled edge lists the receiver sort permutes edges; the
    remapped triplets give the JAX forward on the unshuffled molecules.
    A planted fault, the remap left out (each edge assumed to stay in
    place), must fail that check."""
    _, _, jb = batches
    var = _variables()
    want = np.asarray(jax.jit(JaxSMP(**SMP).apply)({"params": _jax_tree(
        var["params"])}, jb))
    monkeypatch.setattr(loader, "smp_featurize",
                        _shuffled_featurize(np.random.default_rng(5)))
    bucket = BucketSpec(G_CAP, N_CAP, E_CAP, max_deg=N_CAP, csr=True,
                        nmax=10)
    items = _items()
    seen = []
    real = loader.edge_positions
    monkeypatch.setattr(loader, "edge_positions",
                        lambda *a: seen.append(real(*a)) or seen[-1])
    view = loader.smp_collate(items, bucket, CUTOFF)["graph"]
    assert not np.array_equal(seen[0], np.arange(E_CAP))
    g = loader.to_device(view, "cpu")
    assert _rel(_forward(g, var), want) <= FWD_TOL
    monkeypatch.setattr(loader, "smp_featurize",
                        _shuffled_featurize(np.random.default_rng(5)))
    monkeypatch.setattr(loader, "edge_positions",
                        lambda graphs, receivers, n: np.arange(
                            receivers.shape[0]))
    g = loader.to_device(loader.smp_collate(items, bucket, CUTOFF)["graph"],
                         "cpu")
    assert _rel(_forward(g, var), want) > 100 * FWD_TOL


def _call_dtypes(tree, prefix=()) -> dict:
    """Each module's output dtypes in a flax `capture_intermediates`
    tree."""
    out = {}
    for k, v in tree.items():
        if k == "__call__":
            leaves = jax.tree_util.tree_leaves(v[0])
            out["/".join(prefix)] = tuple(str(x.dtype) for x in leaves)
        elif isinstance(v, dict):
            out.update(_call_dtypes(v, prefix + (k,)))
    return out


def test_bf16_dtype_flow_matches_jax(batches):
    """Under the bf16 recipe the JAX model's first edge embedding and node
    update stay bf16 (its segment sum keeps the dtype, where the CSR-sum
    kernel returns float32 and the port casts back) and the bases built
    on the Bessel zeros promote the edge updates to float32: the port's
    modules return the same dtypes."""
    _, g, jb = batches
    var = _variables()
    jm = JaxSMP(**SMP)
    _, inter = jax.jit(functools.partial(
        jm.apply, capture_intermediates=True, mutable=["intermediates"]))(
        {"params": cast_floats(_jax_tree(var["params"]), jnp.bfloat16)},
        cast_floats(jb, jnp.bfloat16))
    want = _call_dtypes(inter["intermediates"])
    names = ("init_e", "init_v", "update_e_0", "update_v_0", "update_e_1",
             "update_v_1")
    model = load_variables(build_model("SMP", SMP), var).eval()
    mods = dict(model.named_modules())
    seen = {}
    hooks = [mods[n].register_forward_hook(
        lambda m, i, o, n=n: seen.setdefault(n, tuple(
            str(x.dtype).replace("torch.", "")
            for x in (o if isinstance(o, tuple) else (o,)))) and None)
        for n in names]
    with torch.no_grad():
        out = torch.func.functional_call(
            model, compute_params(model, torch.bfloat16),
            (cast_batch(g, torch.bfloat16),))
    for h in hooks:
        h.remove()
    assert {n: seen[n] for n in names} == {n: want[n] for n in names}
    assert want["init_v"] == ("bfloat16",)
    assert want["update_e_0"] == ("float32", "float32")
    assert out.dtype == torch.float32


def test_supervised_step_matches_jax(batches):
    """One float32 supervised step (L1) against the JAX trainer's: loss,
    predictions, every gradient leaf (the learned frequencies included);
    every parameter gets a gradient."""
    _, g, jb = batches
    var = _variables()
    want = jax_step(JaxSMP(**SMP), var, jb, "L1Loss")
    got = port_step("SMP", SMP, var, g, "L1Loss", want[3])
    assert np.abs(got[2]["dist_emb_freq"]).max() > 0
    check_step(step_errors(want, got, g.graph_mask.numpy()))
