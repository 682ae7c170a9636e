"""The port's native host collate (`infomax3d_tpu_torch/native/`: the C
core of `graphs/batch.py::batch_graphs`) against its numpy path, array for
array (dtype, shape, values), across tests/test_native_batcher.py's bucket
configurations (CSR on and off, a zero-edge graph, the readout regroup,
an exact fit, one graph) and the port's collates (a conformer batch of
complete graphs); the capacity errors with the numpy path's messages; a
failed build raises.  Then the debug utilities (`utils/debug.py`): the
NaN checks raise on a planted NaN, forward and backward, and the
profiler writes its trace."""
import dataclasses
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from infomax3d_tpu_torch import native
from infomax3d_tpu_torch.data.loader import get_collate
from infomax3d_tpu_torch.data.synthetic import SyntheticMolecules
from infomax3d_tpu_torch.graphs.batch import (BucketSpec, batch_graphs,
                                              batch_graphs_numpy, bucket_for)
from infomax3d_tpu_torch.native.batcher import pack_batch
from infomax3d_tpu_torch.utils import debug, spans


def _mols(seed=0, n_graphs=24, with_zero_edge=True, targets=True):
    """tests/test_native_batcher.py's random graphs, with targets."""
    rng = np.random.default_rng(seed)
    graphs = []
    for i in range(n_graphs):
        n = int(rng.integers(2, 14))
        e = 0 if with_zero_edge and i == 3 else int(rng.integers(1, 3 * n))
        g = dict(node_feat=rng.integers(0, 5, (n, 4)).astype(np.int32),
                 senders=rng.integers(0, n, e).astype(np.int32),
                 receivers=rng.integers(0, n, e).astype(np.int32),
                 edge_feat=rng.integers(0, 3, (e, 2)).astype(np.int32),
                 coords=rng.standard_normal((n, 3)).astype(np.float32))
        if targets:
            g["targets"] = rng.standard_normal(7).astype(np.float32)
        graphs.append(g)
    return graphs


def _same(a, b):
    assert set(a) == set(b), sorted(set(a) ^ set(b))
    for k in a:
        x, y = np.asarray(a[k]), np.asarray(b[k])
        assert x.dtype == y.dtype and x.shape == y.shape, (k, x.dtype,
                                                           y.dtype)
        np.testing.assert_array_equal(x, y, err_msg=k)


def _fit(graphs, csr, nmax, pad_nodes=13, pad_edges=29, n_graphs=32):
    n_tot = sum(g["node_feat"].shape[0] for g in graphs)
    e_tot = sum(g["senders"].shape[0] for g in graphs)
    deg = max(max(np.bincount(g[k]).max() if len(g[k]) else 0
                  for k in ("senders", "receivers")) for g in graphs)
    return BucketSpec(n_graphs, n_tot + pad_nodes, e_tot + pad_edges,
                      max_deg=int(deg), csr=csr, nmax=nmax)


@pytest.mark.parametrize("csr", [False, True])
@pytest.mark.parametrize("nmax", [0, 16])
def test_native_matches_numpy(csr, nmax):
    graphs = _mols()
    bucket = _fit(graphs, csr, nmax)
    _same(pack_batch(graphs, bucket), batch_graphs_numpy(graphs, bucket))


@pytest.mark.parametrize("case", ["exact_fit", "single_graph",
                                  "no_degree_bound", "complete_graphs"])
def test_native_matches_numpy_edge_cases(case):
    if case == "exact_fit":
        graphs = _mols(seed=1, n_graphs=5, targets=False)
        bucket = _fit(graphs, True, 0, 0, 0, 5)
    elif case == "single_graph":
        graphs = _mols(seed=2, n_graphs=1, with_zero_edge=False)
        bucket = BucketSpec(1, 64, 128, max_deg=16, csr=True, nmax=32)
    elif case == "no_degree_bound":
        graphs = _mols(seed=3, n_graphs=8)
        bucket = dataclasses.replace(_fit(graphs, False, 0), max_deg=0)
    else:
        ds = SyntheticMolecules(12, seed=4, n_min=3, n_max=20)
        graphs = [ds.graph3d(i) for i in range(12)]
        bucket = bucket_for(graphs, 16)
    _same(pack_batch(graphs, bucket), batch_graphs_numpy(graphs, bucket))


def test_conformer_collate_native_matches_numpy(monkeypatch):
    """`conformer_collate` (2D batch and the B * C complete graphs of a
    multi-conformer batch) through the native core, then through numpy."""
    ds = SyntheticMolecules(6, seed=5, n_min=4, n_max=12, num_conformers=3)
    items = [{"graph2d": ds.graph2d(i),
              "conformers3d": [ds.graph3d(i, conformer=c) for c in range(3)]}
             for i in range(6)]
    b2 = bucket_for([it["graph2d"] for it in items], 6)
    b3 = bucket_for([c for it in items for c in it["conformers3d"]], 18)
    collate = get_collate("conformer_collate")
    got = collate(items, b2, bucket3d=b3, num_conformers=3)
    monkeypatch.setenv("INFOMAX3D_NO_NATIVE", "1")
    ref = collate(items, b2, bucket3d=b3, num_conformers=3)
    assert set(got) == set(ref)
    for view in ref:
        _same(got[view], ref[view])


def test_batch_graphs_takes_the_core_unless_opted_out(monkeypatch):
    calls = []

    def spy(graphs, bucket):
        calls.append(len(graphs))
        return batch_graphs_numpy(graphs, bucket)

    import infomax3d_tpu_torch.native.batcher as nb
    monkeypatch.setattr(nb, "pack_batch", spy)
    graphs = _mols(seed=6, n_graphs=4)
    bucket = _fit(graphs, True, 0)
    batch_graphs(graphs, bucket)
    assert calls == [4]
    monkeypatch.setenv("INFOMAX3D_NO_NATIVE", "1")
    batch_graphs(graphs, bucket)
    assert calls == [4]


@pytest.mark.parametrize("fault", ["degree", "nmax", "graphs", "nodes",
                                   "csr_without_degree"])
def test_capacity_errors_match_numpy(fault):
    """Each capacity error raises with the numpy path's message (the
    degree check before the regroup's, as there)."""
    g = dict(node_feat=np.zeros((3, 2), np.int32),
             senders=np.zeros(5, np.int32), receivers=np.zeros(5, np.int32))
    graphs, bucket = [g], {
        "degree": BucketSpec(1, 8, 16, max_deg=2, nmax=2),
        "nmax": BucketSpec(1, 8, 16, max_deg=8, nmax=2),
        "graphs": BucketSpec(0, 8, 16),
        "nodes": BucketSpec(1, 2, 16),
        "csr_without_degree": BucketSpec(1, 8, 16, csr=True)}[fault]
    with pytest.raises(ValueError) as want:
        batch_graphs_numpy(graphs, bucket)
    with pytest.raises(ValueError) as got:
        pack_batch(graphs, bucket)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("index", [-1, 3])
def test_endpoint_outside_its_graph_raises(index):
    """An edge endpoint outside its graph's nodes raises before the C
    core's sorts could index past their counts."""
    g = dict(node_feat=np.zeros((3, 2), np.int32),
             senders=np.array([0, index], np.int32),
             receivers=np.array([1, 2], np.int32))
    with pytest.raises(ValueError, match="outside its graph"):
        pack_batch([g], BucketSpec(1, 8, 16, max_deg=4, csr=True))


def test_failed_build_raises(tmp_path, monkeypatch):
    """A source that does not compile raises with the compiler's message;
    no compiler raises too; nothing falls back to numpy."""
    bad = tmp_path / "batcher.c"
    bad.write_text("int pack_topology( {\n")
    monkeypatch.setattr(native, "SOURCE", bad)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="batcher.c") as err:
        native.build()
    assert "error" in str(err.value)
    assert not list((tmp_path / "build").glob("*.so"))
    monkeypatch.setenv("CC", "")
    monkeypatch.setenv("PATH", str(tmp_path / "empty"))
    with pytest.raises(RuntimeError, match="no C compiler"):
        native.build()


def test_library_builds_in_the_ignored_build_dir():
    """The library goes to ``build/infomax3d_tpu_torch/`` at the root of
    the checkout (which .gitignore lists), keyed by the source's hash;
    nothing is written next to the source."""
    path = native.build()
    root = Path(native.__file__).resolve().parents[2]
    assert path.parent == root / "build" / "infomax3d_tpu_torch"
    assert "build/" in (root / ".gitignore").read_text().split()
    assert path.name.startswith("batcher-") and path.exists()
    assert not list(Path(native.__file__).parent.glob("*.so"))


# --- the debug utilities -----------------------------------------------------

def test_nan_checks_raise_on_a_planted_nan():
    """A NaN planted in a module's weight raises in the forward, naming
    the module; one reaching only the backward (0 * inf) raises there; and
    without the checks the NaN passes silently."""
    lin = torch.nn.Linear(4, 3)
    x = torch.ones(2, 4)
    with torch.no_grad():
        lin.weight[1, 2] = float("nan")
    assert torch.isnan(lin(x)).any()
    with debug.debug_mode():
        with pytest.raises(FloatingPointError, match="Linear"):
            lin(x)
        w = torch.tensor([0.0], requires_grad=True)
        y = torch.sqrt(w) * 0.0   # finite forward, d sqrt(0) = inf -> NaN
        with pytest.raises(RuntimeError, match="nan"):
            y.sum().backward()
    assert not debug.nan_checks_enabled()
    assert not torch.is_anomaly_enabled()
    assert torch.isnan(lin(x)).any()


def test_profile_trace_writes_a_chrome_trace(tmp_path):
    with spans.span("before the trace"):     # no profiler: a fresh tally
        pass
    with debug.profile_trace(str(tmp_path / "trace")):
        with spans.span("step.forward"):
            torch.nn.Linear(8, 8)(torch.ones(4, 8)).sum()
        spans.count("h2d_bytes", 128)
    with open(tmp_path / "trace" / "trace.json") as f:
        events = json.load(f)["traceEvents"]
    assert any("linear" in str(e.get("name", "")).lower() for e in events)
    names = {e.get("name") for e in events}
    assert {"debug.profile_trace", "step.forward"} <= names
    with open(tmp_path / "trace" / "spans.json") as f:
        tally = json.load(f)
    assert set(tally["spans"]) == {"debug.profile_trace", "step.forward"}
    whole, forward = (tally["spans"]["debug.profile_trace"],
                      tally["spans"]["step.forward"])
    assert whole["calls"] == forward["calls"] == 1
    assert 0 < forward["host_s"] <= whole["host_s"]
    assert whole["self_s"] == pytest.approx(
        whole["host_s"] - forward["host_s"], abs=1e-9)
    assert tally["counters"] == {"h2d_bytes": 128}
