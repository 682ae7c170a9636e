"""The port's data layer against the JAX package's, module by module, on
the CPU: the same numpy inputs through both, exact equality unless stated.

* `preprocess_qm9` on `tests/fixtures/qm9_slice` (12 molecules): the two
  caches array-equal, key for key and dtype for dtype; a cache whose
  `atom_slices` are shifted by one molecule must fail the same check.
* `parse_sdf`'s accessors on every fixture atom and bond, and the
  pure-Python chemistry (`parse_smiles`, `smiles_to_graph`) on the SMILES
  of `tests/test_splits_chem.py`.
* `write_synthetic_cache` with `float_features`, `split='random'`,
  `split='scaffold'` and `nan_targets`: array-equal npz, NaN positions
  included.
* The three dataset classes' items (the conformer clamp, `random_conformer`
  over 50 accesses, QM9's target selection and units, the GeoMol set's
  stored split), `max_in_degree`.
* The scaffold split: each molecule's `scaffold_key` and the split of a
  cache without a stored one (a `_wl_hash` without its 32-bit mask must
  fail the key check), and `read_ogb_split_dir` on a csv.gz split dir.
* Both samplers' batch lists over two epochs, and `GraphDataLoader` with a
  batch sampler.
* `laplacian_pe` within 1e-6 (eigenvector signs come from the same
  `np.linalg.eigh`), `lap_pe_node_array`, `random_sign_flip`.
* The seven augmentation and graph-only collates on one CSR `BucketSpec`,
  with the same generator and with the default one; the JAX collates
  return device `GraphBatch`es, so each view is compared after conversion
  (`_same_arrays`).
"""
import csv
import gzip
import os

import numpy as np
import pytest

from infomax3d_tpu.data import cached as jax_cached
from infomax3d_tpu.data import chem as jax_chem
from infomax3d_tpu.data import featurize as jax_featurize
from infomax3d_tpu.data import loader as jax_loader
from infomax3d_tpu.data import preprocess as jax_preprocess
from infomax3d_tpu.data import samplers as jax_samplers
from infomax3d_tpu.data import sdf as jax_sdf
from infomax3d_tpu.data import splits as jax_splits
from infomax3d_tpu.data import synthetic as jax_synthetic
from infomax3d_tpu.graphs.batch import BucketSpec as JaxBucket
from infomax3d_tpu_torch.data import cached, chem, featurize, loader
from infomax3d_tpu_torch.data import preprocess, samplers, sdf, splits
from infomax3d_tpu_torch.data import synthetic
from infomax3d_tpu_torch.graphs.batch import BucketSpec
from test_torch_port_trainer import _same_arrays

FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures", "qm9_slice")


def _npz_diff(a_path, b_path):
    """Keys whose arrays differ (values, dtype or presence)."""
    a, b = np.load(a_path), np.load(b_path)
    bad = sorted(set(a.files) ^ set(b.files))
    for k in set(a.files) & set(b.files):
        if a[k].dtype != b[k].dtype or a[k].shape != b[k].shape or \
                not np.array_equal(a[k], b[k],
                                   equal_nan=a[k].dtype.kind == "f"):
            bad.append(k)
    return sorted(bad)


@pytest.fixture(scope="module")
def qm9_caches(tmp_path_factory):
    root = tmp_path_factory.mktemp("qm9")
    mine, ref = str(root / "port.npz"), str(root / "jax.npz")
    preprocess.preprocess_qm9(FIXTURE, mine)
    jax_preprocess.preprocess_qm9(FIXTURE, ref)
    return mine, ref


def test_preprocess_qm9_cache_equal(qm9_caches):
    mine, ref = qm9_caches
    assert _npz_diff(mine, ref) == []
    z = np.load(mine)
    assert z["atom_slices"].shape == (13,) and z["targets"].shape == (12, 19)


def test_preprocess_check_catches_shifted_slices(qm9_caches, tmp_path):
    """Planted fault: the atom slices shifted by one molecule."""
    mine, ref = qm9_caches
    z = dict(np.load(mine))
    z["atom_slices"] = np.concatenate([z["atom_slices"][1:],
                                       z["atom_slices"][-1:]])
    bad = str(tmp_path / "shifted.npz")
    np.savez_compressed(bad, **z)
    assert _npz_diff(bad, ref) == ["atom_slices"]


ATOM_ACCESSORS = ("GetAtomicNum", "GetChiralTag", "GetTotalDegree",
                  "GetFormalCharge", "GetTotalNumHs",
                  "GetNumRadicalElectrons", "GetHybridization",
                  "GetIsAromatic", "IsInRing")
BOND_ACCESSORS = ("GetBeginAtomIdx", "GetEndAtomIdx", "GetBondType",
                  "GetStereo", "GetIsConjugated", "IsInRing")


def test_parse_sdf_accessors():
    path = os.path.join(FIXTURE, "gdb9.sdf")
    mols = list(sdf.parse_sdf(path))
    refs = list(jax_sdf.parse_sdf(path))
    assert len(mols) == len(refs) == 12
    n_atoms = n_bonds = 0
    for m, r in zip(mols, refs):
        assert (m.name, m.props, m.GetNumAtoms()) == \
            (r.name, r.props, r.GetNumAtoms())
        np.testing.assert_array_equal(m.GetConformers()[0].GetPositions(),
                                      r.GetConformers()[0].GetPositions())
        for a, b in zip(m.GetAtoms(), r.GetAtoms(), strict=True):
            assert [getattr(a, f)() for f in ATOM_ACCESSORS] == \
                [getattr(b, f)() for f in ATOM_ACCESSORS]
            n_atoms += 1
        for a, b in zip(m.GetBonds(), r.GetBonds(), strict=True):
            assert [getattr(a, f)() for f in BOND_ACCESSORS] == \
                [getattr(b, f)() for f in BOND_ACCESSORS]
            n_bonds += 1
    assert n_atoms > 12 and n_bonds > 12


def test_chem_sdf_parser_matches():
    text = open(os.path.join(FIXTURE, "gdb9.sdf")).read()
    for (m, p), (r, q) in zip(chem.parse_sdf(text), jax_chem.parse_sdf(text),
                              strict=True):
        assert p == q
        assert [vars(a) for a in m.atoms] == [vars(a) for a in r.atoms]
        assert [vars(b) for b in m.bonds] == [vars(b) for b in r.bonds]
        _same_graph(chem.mol_to_graph_arrays(m),
                    jax_chem.mol_to_graph_arrays(r))


SMILES = ("c1ccccc1", "CC(=O)O", "C#N", "[NH4+]", "[O-]C", "C1CC1C(F)(F)F",
          "C%10CC%10", "CCO")


def _same_graph(a, b):
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].dtype == b[k].dtype, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.mark.parametrize("smi", SMILES)
def test_smiles(smi):
    m, r = chem.parse_smiles(smi), jax_chem.parse_smiles(smi)
    assert [vars(a) for a in m.atoms] == [vars(a) for a in r.atoms]
    assert [vars(b) for b in m.bonds] == [vars(b) for b in r.bonds]
    n = len(m.atoms)
    assert [m.implicit_h(i) for i in range(n)] == \
        [r.implicit_h(i) for i in range(n)]
    assert [m.hybridization(i) for i in range(n)] == \
        [r.hybridization(i) for i in range(n)]
    assert m.ring_bond_mask() == r.ring_bond_mask()
    _same_graph(chem.smiles_to_graph(smi), jax_chem.smiles_to_graph(smi))


def test_unclosed_ring_raises():
    with pytest.raises(chem.SmilesError, match="unclosed"):
        chem.parse_smiles("C1CC")


CACHE_CASES = {
    "plain": dict(num=40, num_targets=3, seed=1),
    "conformers": dict(num=30, num_conformers=3, seed=2),
    "float_features": dict(num=30, seed=6, float_features=True,
                           split="random"),
    "scaffold": dict(num=60, seed=5, split="scaffold"),
    "nan_targets": dict(num=40, num_targets=4, seed=7, nan_targets=True),
}


@pytest.fixture(scope="module")
def caches(tmp_path_factory):
    root = tmp_path_factory.mktemp("caches")
    out = {}
    for name, kw in CACHE_CASES.items():
        mine = synthetic.write_synthetic_cache(str(root / name / "port.npz"),
                                               **kw)
        ref = jax_synthetic.write_synthetic_cache(
            str(root / name / "jax.npz"), **kw)
        out[name] = (mine, ref)
    return out


@pytest.mark.parametrize("name", sorted(CACHE_CASES))
def test_write_synthetic_cache_equal(caches, name):
    mine, ref = caches[name]
    assert _npz_diff(mine, ref) == []
    z = np.load(mine)
    if name == "nan_targets":
        assert np.isnan(z["targets"]).any()
    if name in ("float_features", "scaffold"):
        assert "split_train" in z.files


def _same_item(a, b):
    assert a.keys() == b.keys()
    for k in a:
        if isinstance(a[k], dict):
            _same_graph(a[k], b[k])
        elif isinstance(a[k], list):
            assert len(a[k]) == len(b[k])
            for x, y in zip(a[k], b[k]):
                _same_graph(x, y)
        else:
            assert a[k].dtype == b[k].dtype, k
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def _same_dataset(ds, ref, n=None):
    for attr in ("targets_mean", "targets_std", "split_indices",
                 "num_conformers"):
        x, y = getattr(ds, attr), getattr(ref, attr)
        if isinstance(x, dict):
            assert x.keys() == y.keys()
            for k in x:
                np.testing.assert_array_equal(x[k], y[k])
        else:
            np.testing.assert_array_equal(x, y)
    assert ds.max_in_degree() == ref.max_in_degree()
    np.testing.assert_array_equal(ds.node_counts(), ref.node_counts())
    np.testing.assert_array_equal(ds.edge_counts(), ref.edge_counts())
    for i in range(n or len(ds)):
        _same_item(ds[i], ref[i])


@pytest.mark.parametrize("kw", [
    dict(num_conformers=5),                       # clamped to the 3 stored
    dict(num_conformers=1, random_conformer=True, seed=3),
    dict(num_conformers=2, normalize_targets=True, target_indices=[0],
         target_scale=[2.0]),
], ids=["clamp", "random_conformer", "targets"])
def test_cached_dataset_items(caches, kw):
    mine, _ = caches["conformers"]
    ds = cached.CachedMoleculeDataset(mine, **kw)
    ref = jax_cached.CachedMoleculeDataset(mine, **kw)
    assert ds.num_conformers == (3 if kw["num_conformers"] == 5
                                 else kw["num_conformers"])
    _same_dataset(ds, ref)
    if kw.get("random_conformer"):
        # 50 accesses draw from one dataset-level generator, in order
        for _ in range(50 // len(ds) + 1):
            for i in range(len(ds)):
                _same_item(ds[i], ref[i])


def test_qm9_dataset_on_fixture(qm9_caches):
    mine, _ = qm9_caches
    kw = dict(target_tasks=["homo", "r2", "a"])
    ds, ref = cached.QM9Dataset(mine, **kw), jax_cached.QM9Dataset(mine, **kw)
    np.testing.assert_array_equal(ds.ev2mev, ref.ev2mev)
    assert ds.target_tasks == ref.target_tasks
    _same_dataset(ds, ref)
    denorm = ds.targets * ds.targets_std + ds.targets_mean
    np.testing.assert_allclose(denorm[0, 0], -0.3877 * cached.HAR2EV,
                               rtol=1e-5)


def test_geomol_finetune_dataset(caches):
    mine, _ = caches["float_features"]
    ds = cached.GeomolFineTuneDataset(mine, "bace_geomol_random")
    ref = jax_cached.GeomolFineTuneDataset(mine, "bace_geomol_random")
    assert (ds.ogb_metric_name, ds.float_features) == \
        (ref.ogb_metric_name, ref.float_features) == ("ogbg-molbace", True)
    _same_dataset(ds, ref)
    with pytest.raises(KeyError, match="split_train"):
        cached.GeomolFineTuneDataset(caches["plain"][0], "bace_geomol")


def test_max_in_degree_global_receivers(caches):
    """The maximum over global receiver ids (atom slice + local id)."""
    for name in ("plain", "nan_targets"):
        mine, _ = caches[name]
        ds = cached.CachedMoleculeDataset(mine)
        want = max(int(np.bincount(ds.graph2d(i)["receivers"]).max())
                   for i in range(len(ds)))
        assert ds.max_in_degree() == want == \
            jax_cached.CachedMoleculeDataset(mine).max_in_degree()


def test_scaffold_keys_and_split(caches):
    mine, _ = caches["plain"]
    ds = cached.CachedMoleculeDataset(mine)
    assert ds.split_indices is None
    keys = [splits.scaffold_key(ds.graph2d(i)) for i in range(len(ds))]
    assert keys == [jax_splits.scaffold_key(ds.graph2d(i))
                    for i in range(len(ds))]
    assert len(set(keys)) > 3
    got = splits.get_idx_split(ds, ds.cache_dir)
    want = jax_splits.get_idx_split(ds, ds.cache_dir)
    for k in ("train", "valid", "test"):
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k])
    assert sum(len(v) for v in got.values()) == len(ds)


def test_scaffold_key_check_catches_unmasked_hash(caches, monkeypatch):
    """Planted fault: `_wl_hash` without its 32-bit mask."""
    import hashlib

    def unmasked(labels, s, r, e_labels, iters=3):
        lab = [hash((int(x),)) for x in labels]
        for _ in range(iters):
            lab = [hash((lab[v], tuple(sorted(
                (lab[int(s[k])], int(e_labels[k])) for k in range(len(s))
                if int(r[k]) == v)))) for v in range(len(lab))]
        return hashlib.sha1(",".join(map(str, sorted(lab))).encode()
                            ).hexdigest()
    monkeypatch.setattr(splits, "_wl_hash", unmasked)
    ds = cached.CachedMoleculeDataset(caches["plain"][0])
    differ = [i for i in range(len(ds))
              if splits.scaffold_key(ds.graph2d(i))
              != jax_splits.scaffold_key(ds.graph2d(i))]
    assert len(differ) > 3


def test_stored_split_wins(caches):
    mine, _ = caches["scaffold"]
    ds = cached.CachedMoleculeDataset(mine)
    got = splits.get_idx_split(ds)
    for k, v in jax_splits.get_idx_split(ds).items():
        np.testing.assert_array_equal(got[k], v)


def test_read_ogb_split_dir(tmp_path, caches):
    split_dir = tmp_path / "split" / "scaffold"
    split_dir.mkdir(parents=True)
    parts = {"train": [3, 0, 7, 5], "valid": [1, 2], "test": [4, 6]}
    for part, idx in parts.items():
        with gzip.open(split_dir / f"{part}.csv.gz", "wt") as f:
            csv.writer(f).writerows([[i] for i in idx])
    got = splits.read_ogb_split_dir(str(split_dir))
    want = jax_splits.read_ogb_split_dir(str(split_dir))
    for k in parts:
        np.testing.assert_array_equal(got[k], parts[k])
        np.testing.assert_array_equal(got[k], want[k])
        assert got[k].dtype == want[k].dtype
    assert splits.read_ogb_split_dir(str(tmp_path)) is None
    ds = cached.CachedMoleculeDataset(caches["plain"][0])
    on_disk = splits.get_idx_split(ds, str(tmp_path))
    np.testing.assert_array_equal(on_disk["train"], parts["train"])


@pytest.mark.parametrize("cls", ["ConstantNumberAtomsCategorical",
                                 "ConstantNumberAtomsChunks"])
@pytest.mark.parametrize("drop_last", [False, True])
def test_samplers(cls, drop_last):
    n_atoms = np.random.default_rng(0).integers(4, 12, size=90)
    idx = np.arange(3, 80)
    s = getattr(samplers, cls)(n_atoms, 8, indices=idx, seed=4,
                               drop_last=drop_last)
    r = getattr(jax_samplers, cls)(n_atoms, 8, indices=idx, seed=4,
                                   drop_last=drop_last)
    assert len(s) == len(r)
    for _ in range(2):
        got, want = list(s), list(r)
        assert got == want and len(got) >= 9


def test_loader_with_batch_sampler(caches):
    mine, _ = caches["plain"]
    ds = cached.CachedMoleculeDataset(mine)
    ref = jax_cached.CachedMoleculeDataset(mine)
    deg, nmax = ds.max_in_degree(), int(ds.node_counts().max())
    idx = np.arange(2, 38)

    def sampler(mod):
        return mod.ConstantNumberAtomsChunks(ds.node_counts(), 8,
                                             indices=idx, seed=1)
    mine_l = loader.GraphDataLoader(
        ds, 8, "graph_collate", bucket=BucketSpec(
            8, 256, 512, max_deg=deg, csr=True, nmax=nmax),
        batch_sampler=sampler(samplers))
    ref_l = jax_loader.GraphDataLoader(
        ref, 8, "graph_collate", bucket=JaxBucket(
            8, 256, 512, max_deg=deg, csr=True, nmax=nmax),
        batch_sampler=sampler(jax_samplers))
    assert len(mine_l) == len(ref_l) == 5
    n = 0
    for _ in range(2):
        for pb, jb in zip(mine_l, ref_l, strict=True):
            _same_arrays(pb["graph"], jb["graph"])
            n += 1
    assert n == 10


@pytest.mark.parametrize("n", [1, 2, 5, 13])
def test_laplacian_pe(n):
    g = synthetic.SyntheticMolecules(1, seed=n, n_min=max(n, 4),
                                     n_max=max(n, 4)).graph2d(0)
    s, r = (g["senders"], g["receivers"]) if n >= 4 else \
        (np.arange(n - 1), np.arange(1, n))
    for k in (3, 10):
        vals, vecs = featurize.laplacian_pe(s, r, n, k)
        rv, rvec = jax_featurize.laplacian_pe(s, r, n, k)
        assert vals.dtype == rv.dtype and vecs.shape == rvec.shape
        np.testing.assert_allclose(vals, rv, atol=1e-6)
        np.testing.assert_allclose(vecs, rvec, atol=1e-6)
        pe = featurize.lap_pe_node_array(s, r, n, k)
        np.testing.assert_allclose(pe, jax_featurize.lap_pe_node_array(
            s, r, n, k), atol=1e-6)
        flipped = featurize.random_sign_flip(pe, np.random.default_rng(2))
        np.testing.assert_array_equal(flipped, jax_featurize.random_sign_flip(
            pe, np.random.default_rng(2)))


COLLATES = {
    "graph_only_collate": {},
    "contrastive_collate_ae": {},
    "noised_distances_collate": dict(std=0.2, num_noised=2),
    "noised_coordinates_collate": dict(std=0.2),
    "node_drop_3d_collate": dict(num_drop=4),
    "node_drop_2d3d_collate": dict(drop_ratio=0.25),
    "graphcl_collate": dict(drop_ratio=0.2),
}
NEEDS_3D_BUCKET = ("contrastive_collate_ae", "noised_distances_collate",
                   "noised_coordinates_collate", "node_drop_3d_collate",
                   "node_drop_2d3d_collate")


def _views(out):
    for name, v in out.items():
        if isinstance(v, list):
            for i, x in enumerate(v):
                yield f"{name}[{i}]", x
        else:
            yield name, v


@pytest.mark.parametrize("seeded", [True, False], ids=["rng", "default"])
@pytest.mark.parametrize("name", sorted(COLLATES))
def test_collates(name, seeded, caches):
    ds = cached.CachedMoleculeDataset(caches["plain"][0])
    items = [ds[i] for i in range(12)]
    G, nmax = 16, int(ds.node_counts().max())
    b2 = dict(n_graphs=G, n_nodes=256, n_edges=512,
              max_deg=ds.max_in_degree(), csr=True, nmax=nmax)
    b3 = dict(n_graphs=G, n_nodes=256, n_edges=G * nmax * (nmax - 1),
              max_deg=nmax - 1, csr=True, nmax=nmax)
    kw, ref_kw = dict(COLLATES[name]), dict(COLLATES[name])
    if name in NEEDS_3D_BUCKET:
        kw["bucket3d"], ref_kw["bucket3d"] = BucketSpec(**b3), JaxBucket(**b3)
    if seeded and name not in ("graph_only_collate",
                               "contrastive_collate_ae"):
        kw["rng"] = np.random.default_rng(11)
        ref_kw["rng"] = np.random.default_rng(11)
    got = loader.get_collate(name)(items, BucketSpec(**b2), **kw)
    want = jax_loader.get_collate(name)(items, JaxBucket(**b2), **ref_kw)
    got_views, want_views = dict(_views(got)), dict(_views(want))
    assert got_views.keys() == want_views.keys()
    for view in got_views:
        _same_arrays(got_views[view], want_views[view])
        assert int(got_views[view]["max_deg"]) > 0


def test_collate_aliases_and_not_ported():
    assert loader.get_collate("NodeDropCollate") is loader.graphcl_collate
    assert loader.get_collate("NodeDrop3dCollate") is \
        loader.node_drop_3d_collate
    # every JAX collate is ported: the padded ones too, with their aliases
    for name in ("egnn_padded_collate", "padded_collate",
                 "egnn_padded_collate3d"):
        assert loader.get_collate(name) is loader.egnn_padded_collate
    assert loader.get_collate("molhiv_padded_collate") is \
        loader.molhiv_padded_collate
    assert loader.get_collate("smp_collate") is loader.smp_collate
    assert loader.get_collate("padded_collate_positional_encoding") is \
        loader.padded_collate_positional_encoding
    assert set(jax_loader.COLLATE_REGISTRY) == set(loader.COLLATE_REGISTRY)


def test_node_drop(caches):
    ds = cached.CachedMoleculeDataset(caches["plain"][0])
    for i in range(8):
        g = ds.graph2d(i)
        got = loader.node_drop(g, np.random.default_rng(i), 0.3)
        want = jax_loader.node_drop(g, np.random.default_rng(i), 0.3)
        _same_graph(got, want)
