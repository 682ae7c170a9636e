"""The edge- and node-partitioned modes (`graph_shards`, `node_shards`:
`infomax3d_tpu_torch/parallel/edge_partition.py`, `node_partition.py`,
the (data, graph) grid of `parallel/mesh.py`) on the CPU.

* Host arrays against the JAX package's: `partition_edges` and
  `shard_edge_arrays`, the plan of `build_node_partition`, and
  `shard_graph_batch`'s shard g against slice g of the JAX stack, on a
  molecular batch (2D and complete 3D graphs) and on
  tests/test_node_partition.py's single giant graph.
* Gloo ranks (`tests/torch_dp_cases.py`, started once for the module:
  two ranks for ``graph_shards: 2`` and ``node_shards: 2`` on the
  contrastive step and the GIN step, four for ``n_shards: 2`` x
  ``graph_shards: 2`` on the GIN step) against the port's one process on
  the whole batch, with the tolerances of the JAX package's own tests
  (tests/test_edge_partition_mode.py, test_node_partition_mode.py): the
  loss within 2e-4 relative, each gradient leaf within max(8e-4 x its
  scale, 5e-4), the running statistics within 1.2e-2 relative + 2e-5 in
  edge mode (node-space rows count k times in the unbiased correction, as
  in JAX) and 2e-3 + 2e-5 in node mode.  Readings, in units of those
  bounds: gradients 0.0016 to 0.038, statistics up to 0.20 (edge) and
  1.8e-4 (node), losses up to 2.4e-7 relative.  The ranks bit-equal; the
  node step under remat bit-equal to the one without.
* The contrastive case's rank 0 in both modes against the JAX package's
  partitioned step (`shard_map` over a (1 data, 2 graph) mesh of virtual
  CPU devices, tests/test_edge_partition_mode.py's and
  test_node_partition_mode.py's setup) on the same batch and weights: the
  loss within 1e-5 relative (readings 8.2e-8 edge, 5.7e-7 node), each
  gradient leaf within JAX's rule above (0.022, 0.046 of the bound), the
  running statistics within 1e-4 of each buffer's largest entry (4.6e-6,
  2.0e-6).  That bound holds the k-fold count of rows whole on every rank
  to JAX's: an edge-mode correction without it reads 2.4e-3 here and
  passes the one-process comparison.
* Planted faults, each beyond the gradient bound by 100x: an edge-mode
  aggregation without its completion, a halo exchange whose backward
  drops the ghost cotangents, a BatchNorm not completed over the graph
  group.
* The JAX CLI's refusals, one test each, and both modes through the CLI.

One torch thread per process; ~35 s on one worker.
"""
import json
import os
import pickle
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from infomax3d_tpu.data.loader import GraphDataLoader as JaxLoader
from infomax3d_tpu.graphs.batch import BucketSpec as JaxBucket
from infomax3d_tpu.graphs.batch import GraphBatch as JaxGraphBatch
from infomax3d_tpu.graphs.batch import batch_graphs as jax_batch_graphs
from infomax3d_tpu.graphs.batch import to_graph_batch as jax_to_graph_batch
from infomax3d_tpu.losses import LOSS_REGISTRY
from infomax3d_tpu.models import PNA as JaxPNA
from infomax3d_tpu.models.net3d import Net3D as JaxNet3D
from infomax3d_tpu.parallel import make_mesh
from infomax3d_tpu.parallel.context import (using_cross_replica_axis,
                                            using_edge_partition_axis,
                                            using_node_partition_axis)
from infomax3d_tpu.parallel.edge_partition import (
    partition_edges as jax_partition_edges,
    shard_batch_edges as jax_shard_batch_edges,
    shard_edge_arrays as jax_shard_edge_arrays)
from infomax3d_tpu.parallel.node_partition import (
    build_node_partition as jax_build_node_partition,
    shard_graph_batch as jax_shard_graph_batch)
from infomax3d_tpu.train.trainer import SelfSupervisedTrainer
from infomax3d_tpu_torch.graphs.batch import BucketSpec, batch_graphs
from infomax3d_tpu_torch.interop import params_from_jax
from infomax3d_tpu_torch.parallel.edge_partition import (partition_edges,
                                                         shard_batch_edges,
                                                         shard_edge_arrays)
from infomax3d_tpu_torch.parallel.node_partition import (
    build_node_partition, shard_graph_batch)

import torch_dp_cases as cases

ROOT = Path(__file__).resolve().parents[1]
LOSS_RTOL, GRAD_RTOL, GRAD_FLOOR = 2e-4, 8e-4, 5e-4
STATS_RTOL = {"edge": 1.2e-2, "node": 2e-3}
JAX_LOSS, JAX_STATS = 1e-5, 1e-4


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# --- host arrays against JAX -------------------------------------------------

def _molecular_arrays(view):
    """The cases' 16 molecules in their tight non-CSR bucket, batched by
    both packages (the JAX batch keeps edge_graph)."""
    items = cases.Molecules().items
    b = cases.tight_buckets(items)[0 if view == "graph2d" else 1]
    mols = [dict(it[view], targets=it["targets"]) for it in items]
    port = batch_graphs(mols, BucketSpec(b.n_graphs, b.n_nodes, b.n_edges,
                                         nmax=b.nmax))
    ref = jax_batch_graphs(mols, JaxBucket(b.n_graphs, b.n_nodes, b.n_edges,
                                           nmax=b.nmax),
                           extras_keys=["targets"])
    return port, ref


def _giant_graph():
    """tests/test_node_partition.py's ring with random chords, N = 512."""
    rng = np.random.default_rng(7)
    N = 512
    src, dst = np.arange(N), (np.arange(N) + 1) % N
    a, b = rng.integers(0, N, 300), rng.integers(0, N, 300)
    keep = a != b
    senders = np.concatenate([src, dst, a[keep], b[keep]]).astype(np.int32)
    receivers = np.concatenate([dst, src, b[keep], a[keep]]).astype(np.int32)
    return senders, receivers, np.ones_like(senders, bool), N


def _same_plan(a, b):
    for f in ("k", "n_local", "halo_sizes"):
        assert getattr(a, f) == getattr(b, f), f
    for f in ("node_idx", "node_mask", "senders_loc", "receivers_loc",
              "edge_mask", "edge_perm"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f), f)
    for x, y in zip(a.send_idx, b.send_idx, strict=True):
        np.testing.assert_array_equal(x, y)
    for f in ("node_payload", "edge_payload"):
        assert set(getattr(a, f)) == set(getattr(b, f))
        for key in getattr(a, f):
            np.testing.assert_array_equal(getattr(a, f)[key],
                                          getattr(b, f)[key])


@pytest.mark.parametrize("view", ["graph2d", "graph3d"])
def test_partition_edges_match_jax(view):
    port, ref = _molecular_arrays(view)
    for k in (2, 3):
        got = partition_edges(ref["edge_graph"], ref["edge_mask"], k)
        want = jax_partition_edges(ref["edge_graph"], ref["edge_mask"], k)
        np.testing.assert_array_equal(got, want)
        keys = [key for key in ("senders", "receivers", "edge_feat",
                                "edge_dist") if key in port]
        a = shard_edge_arrays(port, got, k, keys)
        b = jax_shard_edge_arrays(ref, want, k, keys)
        assert set(a) == set(b)
        for key in a:
            np.testing.assert_array_equal(a[key], b[key], key)


@pytest.mark.parametrize("graph", ["graph2d", "graph3d", "giant"])
@pytest.mark.parametrize("k", [2, 3, 8])
def test_node_partition_plan_matches_jax(graph, k):
    if graph == "giant":
        s, r, m, n = _giant_graph()
        extra = {}
    else:
        port, _ = _molecular_arrays(graph)
        s, r, m, n = (port["senders"], port["receivers"], port["edge_mask"],
                      port["node_feat"].shape[0])
        extra = dict(node_arrays={"node_feat": port["node_feat"]},
                     edge_arrays={"edge_mask": port["edge_mask"]})
    _same_plan(build_node_partition(s, r, m, n, k, **extra),
               jax_build_node_partition(s, r, m, n, k, **extra))


@pytest.mark.parametrize("pads", [(0, 0), (None, 24)])
@pytest.mark.parametrize("view", ["graph2d", "graph3d"])
def test_shard_graph_batch_is_the_jax_slice(view, pads):
    """Each rank's shard equals slice g of the JAX package's stacked
    `shard_graph_batch`, field for field (the halo send lists under the
    port's names), with measured pads and with fixed ones."""
    port, ref = _molecular_arrays(view)
    k = 2
    el_pad = pads[0] if pads[0] is not None else int(
        np.ceil(port["senders"].shape[0] * 1.5 / k / 8) * 8)
    stacked = jax_shard_graph_batch(jax_to_graph_batch(ref, ["targets"]), k,
                                    el_pad, pads[1])
    fields = ("node_feat", "senders", "receivers", "node_graph",
              "node_mask", "edge_mask", "graph_mask", "n_nodes", "edge_feat",
              "edge_dist", "node_pos", "snorm", "coords")
    for g in range(k):
        got = shard_graph_batch(port, k, g, el_pad, pads[1])
        for f in fields:
            want = getattr(stacked, f)
            assert (f in got) == (want is not None), f
            if want is not None:
                np.testing.assert_array_equal(got[f], np.asarray(want)[g], f)
        for f in ("targets", "in_degree"):
            np.testing.assert_array_equal(got[f],
                                          np.asarray(stacked.extras[f])[g], f)
        r = 0
        while f"np_send_{r}" in stacked.extras:
            np.testing.assert_array_equal(
                got[f"halo_send_{r}"],
                np.asarray(stacked.extras[f"np_send_{r}"])[g])
            r += 1
        assert f"halo_send_{r}" not in got and int(got["nmax"]) == 0


def test_shard_batch_edges_cuts_round_robin():
    """The k edge shards hold every edge once (edge e on rank e % k), the
    node fields whole and the CSR arrays gone."""
    items = cases.Molecules().items
    b = cases.tight_buckets(items)[0]
    view = batch_graphs([it["graph2d"] for it in items], b)
    parts = [shard_batch_edges(view, 2, g) for g in range(2)]
    for f in ("senders", "receivers", "edge_mask", "edge_feat"):
        both = np.stack([p[f] for p in parts], axis=1).reshape(
            view[f].shape)
        np.testing.assert_array_equal(both, view[f])
    for p in parts:
        assert not any(f.startswith(("csr_", "csc_")) for f in p)
        np.testing.assert_array_equal(p["in_degree"], view["in_degree"])


# --- gloo ranks against one process ------------------------------------------

@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Each suite's ranks' results: "partition" (two ranks) and "grid"
    (four), started together."""
    env = dict(os.environ, OMP_NUM_THREADS="1")
    runs = {}
    for suite, world in (("partition", 2), ("grid", 4)):
        out = tmp_path_factory.mktemp(suite)
        runs[suite] = (out, world, [subprocess.Popen(
            [sys.executable, str(ROOT / "tests" / "torch_dp_cases.py"),
             str(r), str(world), str(out), suite], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True, env=env)
            for r in range(world)])
    results = {}
    for suite, (out, world, procs) in runs.items():
        logs = [p.communicate(timeout=300)[0] for p in procs]
        for p, log in zip(procs, logs):
            assert p.returncode == 0, log
        results[suite] = []
        for r in range(world):
            with open(out / f"rank{r}.pkl", "rb") as f:
                results[suite].append(pickle.load(f))
    return results


@pytest.fixture(scope="module")
def single():
    """Each partition case in one process on the whole batch."""
    return {name: cases.partition(name, None)
            for name in {**cases.PARTITION_CASES, **cases.GRID_CASES}}


def _suite(name):
    return "grid" if name in cases.GRID_CASES else "partition"


def _grad_error(got, ref):
    """The worst gradient leaf in units of its bound (JAX's
    `_assert_tree_close`: max(rtol x the leaf's scale, floor))."""
    errs = {}
    for k in ref:
        if k == "loss" or "running" in k:
            continue
        a, b = np.asarray(got[k]), np.asarray(ref[k])
        scale = max(np.abs(a).max(), np.abs(b).max())
        errs[k] = np.abs(a - b).max() / max(GRAD_RTOL * scale, GRAD_FLOOR)
    k = max(errs, key=errs.get)
    return k, errs[k]


@pytest.mark.parametrize("name", sorted({**cases.PARTITION_CASES,
                                         **cases.GRID_CASES}))
def test_partitioned_ranks_match_one_process(ranks, single, name):
    mode = {**cases.PARTITION_CASES, **cases.GRID_CASES}[name][0]
    got, ref = ranks[_suite(name)][0][name], single[name]
    assert got["loss"] == pytest.approx(ref["loss"], rel=LOSS_RTOL)
    k, e = _grad_error(got, ref)
    assert e <= 1.0, (k, e)
    for k in (k for k in ref if "running" in k):
        np.testing.assert_allclose(got[k], ref[k], rtol=STATS_RTOL[mode],
                                   atol=2e-5, err_msg=k)


@pytest.mark.parametrize("name", sorted({**cases.PARTITION_CASES,
                                         **cases.GRID_CASES}))
def test_partitioned_ranks_agree(ranks, name):
    results = ranks[_suite(name)]
    for other in results[1:]:
        for k in results[0][name]:
            np.testing.assert_array_equal(np.asarray(results[0][name][k]),
                                          np.asarray(other[name][k]),
                                          err_msg=k)


def test_node_remat_step_is_bit_equal(ranks):
    """Under remat the recompute repeats the halo exchanges and the
    BatchNorm all-reduces on every rank: the node step equals the one
    without remat bit for bit."""
    a = ranks["partition"][0]["node_contrastive_remat"]
    b = ranks["partition"][0]["node_contrastive"]
    for k in a:
        np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]),
                                      err_msg=k)


def _jax_partitioned(mode):
    """The JAX package's partitioned contrastive step (PNA + Net3D,
    NT-Xent) over a (1 data, 2 graph) mesh of virtual CPU devices, as its
    trainer runs it (edge mode: the replicated batch cut in the step by
    `shard_batch_edges`; node mode: the host's `shard_graph_batch` stack,
    one shard per device), on the cases' whole batch in its tight non-CSR
    buckets and from their seeded weights; returns the loss, the gradients
    (one pmean over both axes) and the updated running statistics in the
    port's names."""
    k = cases.K
    mesh = make_mesh(k, axis_names=("data", "graph"), shape=(1, k))
    ds = cases.Molecules()
    b2, b3 = (JaxBucket(b.n_graphs, b.n_nodes, b.n_edges, nmax=b.nmax)
              for b in cases.tight_buckets(ds.items))
    batch = next(iter(JaxLoader(ds, cases.B, "contrastive_collate",
                                bucket=b2, shuffle=False, prefetch=0,
                                collate_kwargs={"bucket3d": b3})))

    def is_graph(v):
        return isinstance(v, JaxGraphBatch)

    def cut(fn, b):
        return jax.tree_util.tree_map(
            lambda v: fn(v) if is_graph(v) else v, b, is_leaf=is_graph)
    if mode == "node":
        batch = cut(lambda v: jax_shard_graph_batch(v, k), batch)
    tr = SelfSupervisedTrainer.__new__(SelfSupervisedTrainer)
    tr.models = {"model": JaxPNA(**cases.PNA),
                 "model3d": JaxNet3D(**cases.NET3D)}
    tr.loss_func = LOSS_REGISTRY["NTXent"](tau=0.1)
    tr.compute_dtype, tr.args, tr.mesh = None, {}, mesh
    tr._loss_fn_extra = None
    var = cases.variables({"model": ("PNA", cases.PNA),
                           "model3d": ("Net3D", cases.NET3D)})
    params = {key: jax.tree_util.tree_map(jnp.asarray, v["params"])
              for key, v in var.items()}
    stats = {key: jax.tree_util.tree_map(jnp.asarray, v["batch_stats"])
             for key, v in var.items()}
    axis = (using_edge_partition_axis if mode == "edge"
            else using_node_partition_axis)

    def step(p, b):
        if mode == "edge":
            local = cut(lambda v: jax_shard_batch_edges(v, k, "graph"), b)
        else:
            local = jax.tree_util.tree_map(lambda a: a[0], b)
        with using_cross_replica_axis("data"), axis("graph"):
            def lf(pp):
                loss, _, new_stats = tr.loss_fn(pp, stats, local, 0,
                                                jax.random.key(0), True)
                return loss, new_stats
            (loss, new_stats), g = jax.value_and_grad(lf, has_aux=True)(p)
        both = ("data", "graph")
        return jax.lax.pmean(loss, both), jax.lax.pmean(g, both), new_stats

    loss, grads, new_stats = jax.jit(jax.shard_map(
        step, mesh=mesh, in_specs=(P(), P() if mode == "edge" else
                                   P("graph")),
        out_specs=(P(), P(), P()), check_vma=False))(params, batch)
    out = {"loss": float(loss)}
    for key in var:
        sd = params_from_jax(
            jax.tree_util.tree_map(lambda v: np.asarray(v, np.float32),
                                   jax.device_get(grads[key])),
            jax.tree_util.tree_map(lambda v: np.asarray(v, np.float32),
                                   jax.device_get(new_stats[key])))
        out.update({f"{key}.{n}": v.numpy() for n, v in sd.items()
                    if "num_batches" not in n})
    return out


@pytest.mark.parametrize("mode", ["edge", "node"])
def test_partitioned_ranks_match_jax(ranks, mode):
    """The port's partitioned contrastive step (rank 0 of two) against the
    JAX package's partitioned step on the same batch and weights.  Both
    count the rows that every rank of the group holds k times in the
    BatchNorm statistics, so the running statistics agree far inside the
    bound the one-process comparison needs for that (`STATS_RTOL`): within
    JAX_STATS of each buffer's largest entry.  The loss within JAX_LOSS
    relative, each gradient leaf within JAX's own rule (`_grad_error`).
    Readings in the module docstring."""
    ref = _jax_partitioned(mode)
    got = ranks["partition"][0][f"{mode}_contrastive"]
    assert set(got) == set(ref)
    assert abs(got["loss"] - ref["loss"]) <= JAX_LOSS * abs(ref["loss"]), \
        (got["loss"], ref["loss"])
    k, e = _grad_error(got, ref)
    assert e <= 1.0, (k, e)
    errs = {k: float(np.abs(np.asarray(got[k]) - ref[k]).max()
                     / np.abs(ref[k]).max()) for k in ref if "running" in k}
    k = max(errs, key=errs.get)
    assert errs[k] <= JAX_STATS, (k, errs[k])


@pytest.mark.parametrize("fault", sorted(cases.PARTITION_FAULTS))
def test_planted_partition_fault_fails(ranks, single, fault):
    got = ranks["partition"][0][fault]
    ref = single[cases.PARTITION_FAULTS[fault][0]]
    k, e = _grad_error(got, ref)
    assert e > 100.0, (k, e)


# --- the CLI -------------------------------------------------------------------

def _cli_args(tmp_path, **over):
    from infomax3d_tpu_torch.cli.config import load_config
    return load_config(str(ROOT / "configs_clean/pre-train_synthetic.yml"),
                       dict(dict(
                           logdir=str(tmp_path), use_tensorboard=False,
                           device="cpu", num_epochs=1, log_iterations=1,
                           dataset_params={"num": 176, "n_max": 16},
                           num_train=32, batch_size=16, eval_on_test=False,
                           model_parameters=dict(
                               cases.PNA, target_dim=8,
                               readout_aggregators=["mean"]),
                           model3d_parameters=dict(cases.NET3D,
                                                   target_dim=8)), **over))


def _first_loss(d):
    run = os.path.join(d, os.listdir(d)[0])
    with open(os.path.join(run, "metrics.jsonl")) as f:
        return json.loads(f.readline())["NTXent"]


def test_cli_partitioned_modes(tmp_path, monkeypatch):
    """`graph_shards: 2` and `node_shards: 2` through the training CLI
    (two gloo ranks the CLI starts): one run directory each, the first
    logged loss within 1e-5 of the one-process run on the non-CSR batch
    (readings 1.4e-6 and 7.8e-8)."""
    from infomax3d_tpu_torch.cli.train import train
    for k in ("WORLD_SIZE", "COORDINATOR_ADDRESS"):
        monkeypatch.delenv(k, raising=False)
    train(_cli_args(tmp_path / "one", csr_buckets=False, dense_3d=False))
    ref = _first_loss(tmp_path / "one")
    for knob in ("graph_shards", "node_shards"):
        train(_cli_args(tmp_path / knob, dist_backend="gloo", **{knob: 2}))
        assert len(os.listdir(tmp_path / knob)) == 1
        assert _first_loss(tmp_path / knob) == pytest.approx(ref, rel=1e-5)


# --- the JAX CLI's refusals ----------------------------------------------------

def test_refuses_graph_and_node_shards_together(tmp_path):
    from infomax3d_tpu_torch.cli.train import train
    with pytest.raises(ValueError, match="pick one"):
        train(_cli_args(tmp_path, graph_shards=2, node_shards=2))


def test_refuses_node_shards_with_another_collate(tmp_path):
    from infomax3d_tpu_torch.cli.train import train
    with pytest.raises(ValueError, match="pure-GraphBatch collates"):
        train(_cli_args(tmp_path, node_shards=2,
                        collate_function="graphcl_collate",
                        trainer="graphcl_trainer", model3d_type=None))


def test_refuses_node_shards_with_pairwise_distances(tmp_path):
    from infomax3d_tpu_torch.cli.train import train
    with pytest.raises(NotImplementedError, match="pairwise_distances"):
        train(_cli_args(tmp_path, node_shards=2, model_parameters=dict(
            cases.PNA, target_dim=8, pairwise_distances=True)))


@pytest.mark.parametrize("knob", ["graph_shards", "node_shards"])
def test_refuses_model_shards_with_a_partition(tmp_path, knob):
    from infomax3d_tpu_torch.cli.train import train
    with pytest.raises(ValueError, match="model_shards cannot combine"):
        train(_cli_args(tmp_path, model_shards=2, **{knob: 2}))


def test_model_shards_alone_names_item_9c_and_trainers_refuse_a_grid(
        tmp_path):
    """`model_shards` alone, item 9c, is ported (tests/
    test_torch_port_tp.py): it starts its ranks as `n_shards` does, so on
    the CPU it needs gloo named.  The philosophy and OT trainers refuse a
    partitioned grid as they refuse a data-parallel group, and a
    tensor-parallel grid of two data shards; one of one data shard they
    take (the JAX package runs both under `model_shards` alone)."""
    from infomax3d_tpu_torch.cli.train import train
    from infomax3d_tpu_torch.parallel.mesh import Grid
    from infomax3d_tpu_torch.train.trainer import (OptimalTransportTrainer,
                                                   PhilosophyTrainer)
    with pytest.raises(ValueError, match="gloo"):
        train(_cli_args(tmp_path, model_shards=2))
    two_data = Grid(2, 2, "model", 0, 0, object(), object(), object())
    for cls in (PhilosophyTrainer, OptimalTransportTrainer):
        for grid in (object(), two_data):
            with pytest.raises(NotImplementedError, match="n_shards"):
                cls({}, {}, {}, "loss", str(tmp_path), device="cpu",
                    grid=grid)
