"""Tensor parallelism (`infomax3d_tpu_torch/parallel/tp.py`, the JAX
package's ``model_shards`` mode) on the CPU: gloo ranks started once for
the module (`tests/torch_tp_cases.py`: two ranks with ``model_shards: 2``,
then four with ``n_shards: 2`` x ``model_shards: 2``; rendezvous in a file
store, one torch thread each), held against the port's own step in one
process, against the JAX package's step on `make_tp_mesh(1, 2)` (2 of the
8 virtual CPU devices), against data parallelism alone, and each other.
tests/test_tp_mode.py's and tests/torch_dp_cases.py's small widths
(hidden 16, depth 2), 16 seeded molecules.

Tolerances, each with its reading:

* The sharded step against one process on the same batch: bit for bit,
  loss, every gradient leaf (the shards gathered), the running statistics
  and, for the trainers, the parameters after the update and the eval
  loss.  Each rank runs the one process's forward on the gathered
  parameters, and its gradient of a sharded leaf is its slice of the one
  process's (readings 0).  The optimal-transport trainer's within 1e-6
  of each reading's max (reading 1.4e-7): its clip at norm 10 scales
  the gradient by the whole gradient's norm, summed in another order.
* ``n_shards: 2`` x ``model_shards: 2`` against data parallelism alone on
  the same ranks' data shards: bit for bit (readings 0).
* The model ranks against each other: bit for bit.
* Against the JAX step on `make_tp_mesh(1, 2)` (its non-CSR batch, the
  port's CSR batch of the same molecules): the bounds of
  tests/test_torch_port_parallel.py's JAX comparison, the loss within
  1e-5 relative, each gradient leaf within 1e-3 of the larger of its max
  and 1e-2 of the case's largest gradient, the running statistics within
  1e-4 of their max.
* The CLI with ``model_shards: 2`` against ``model_shards: 1``: the final
  metric at tests/test_tp_mode.py's rtol 5e-4 (atol 5e-5); a one-process
  run resumed from the tensor-parallel checkpoint evaluates its weights to
  the tensor-parallel run's metric at 1e-6.
* Planted faults (in the ranks, on the contrastive case) must read beyond
  the gradient bound 1e-3 by 10x: the gather's backward summing the
  cotangent over the model ranks (reading 1.0: every shard's gradient
  doubled), the shards gathered in reversed rank order (6.6), the
  gradient mean taken over the model ranks too (0.93).
"""
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

from infomax3d_tpu.data.loader import GraphDataLoader as JaxLoader
from infomax3d_tpu.graphs.batch import BucketSpec as JaxBucket
from infomax3d_tpu.losses import LOSS_REGISTRY
from infomax3d_tpu.models import PNA as JaxPNA
from infomax3d_tpu.models.net3d import Net3D as JaxNet3D
from infomax3d_tpu.parallel.tp import (make_tp_mesh, tp_shard_params,
                                       tp_shard_tree)
from infomax3d_tpu.parallel.tp import tp_spec_for as jax_tp_spec_for
from infomax3d_tpu.train.trainer import SelfSupervisedTrainer, Trainer
from infomax3d_tpu_torch.interop import (flax_paths, init_jax_variables,
                                         load_variables, params_from_jax)
from infomax3d_tpu_torch.models.registry import build_model
from infomax3d_tpu_torch.parallel import tp

import torch_dp_cases as dp
import torch_tp_cases as cases
from test_torch_port_parallel import (JAX_GRAD, JAX_LOSS, JAX_STATS,
                                      _grad_keys, _leaf_errors,
                                      _stats_errors, _worst)

ROOT = Path(__file__).resolve().parents[1]
META = ("shapes", "bytes")
# the OT step against one process: its clip reads the norm of the whole
# gradient summed in another order (shards, then the replicated leaves)
OT_REL = 1e-6


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _start(out, world, suite):
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, str(ROOT / "tests" / "torch_tp_cases.py"), str(r),
         str(world), str(out), suite], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True, env=env)
        for r in range(world)]
    return procs


def _collect(procs, out, world):
    logs = [p.communicate(timeout=300)[0] for p in procs]
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log
    results = []
    for r in range(world):
        with open(out / f"rank{r}.pkl", "rb") as f:
            results.append(pickle.load(f))
    return results


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both suites' ranks, started together, and meanwhile each case in one
    process on the whole batch and the JAX TP steps: ([the two
    ``model_shards: 2`` ranks], [the four grid ranks], {case: one
    process}, {case: the JAX step})."""
    tp_out = tmp_path_factory.mktemp("tp_ranks")
    grid_out = tmp_path_factory.mktemp("tp_grid_ranks")
    a = _start(tp_out, cases.K, "tp")
    b = _start(grid_out, 2 * cases.K, "grid")
    out = tmp_path_factory.mktemp("tp_single")
    single = {name: cases.run(name, None, str(out / name))
              for name in cases.CASES + cases.TRAINERS}
    jax_refs = {name: _jax_reference(name)
                for name in ("contrastive", "supervised")}
    return (_collect(a, tp_out, cases.K),
            _collect(b, grid_out, 2 * cases.K), single, jax_refs)


@pytest.fixture(scope="module")
def ranks(runs):
    return runs[0]


@pytest.fixture(scope="module")
def grid_ranks(runs):
    return runs[1]


@pytest.fixture(scope="module")
def single(runs):
    return runs[2]


# --- the layout -----------------------------------------------------------

@pytest.mark.parametrize("shape", [(64, 128), (128,), (64, 65), ()])
def test_spec_for_matches_jax(shape):
    """`tp_spec_for` on the four cases of tests/test_tensor_parallel.py:
    the same spec as the JAX package's, as a tuple."""
    a = np.zeros(shape)
    assert tp.tp_spec_for("k", a, 4) == tuple(jax_tp_spec_for("k", a, 4))


LAYOUT_MODELS = {
    "PNA": dp.PNA, "OGBGNN": dp.GIN,
    "Net3DDense": dict(dp.NET3D, hidden_dim=20, target_dim=16)}


@pytest.mark.parametrize("model_type", sorted(LAYOUT_MODELS))
def test_sharded_leaves_match_jax(model_type):
    """The flax paths of the leaves `shard_module` shards over two model
    ranks equal those the JAX package's `tp_shard_params` puts on the
    ``model`` axis of `make_tp_mesh(1, 2)`, on the same tree; each shard
    is its rank's half of the whole leaf."""
    mp = LAYOUT_MODELS[model_type]
    params, stats = init_jax_variables(mp, 3, model_type)
    sharded = tp_shard_params(jax.tree_util.tree_map(jnp.asarray, params),
                              make_tp_mesh(1, 2))
    flat, _ = jax.tree_util.tree_flatten_with_path(sharded)
    want = {"/".join(k.key for k in path) for path, leaf in flat
            if "model" in tuple(leaf.sharding.spec)}
    model = load_variables(build_model(model_type, mp),
                           {"params": params, "batch_stats": stats})
    paths = flax_paths(model)
    whole = {n: p.detach().clone() for n, p in model.named_parameters()}
    for index in (0, 1):
        m = load_variables(build_model(model_type, mp),
                           {"params": params, "batch_stats": stats})
        assert tp.shard_module(m, 2, index) == len(want)
        got = tp.sharded_leaves(m)
        assert {paths[n] for n in got} == want
        for n, p in m.named_parameters():
            expect = whole[n] if n not in got else \
                whole[n].chunk(2, got[n].dim)[index]
            assert torch.equal(p.detach(), expect), n
    assert len(want) >= 4


# --- the step against one process, each other, JAX -------------------------

def _keys(res):
    """The gradient leaves of a case's result."""
    return _grad_keys({k: v for k, v in res.items() if k not in META})


def _same(got, ref, rel=0.0):
    """Every reading of `got` equal to `ref`'s, or within `rel` of each
    reading's max."""
    assert set(ref) - set(META) <= set(got)
    for k, v in ref.items():
        if k in META:
            continue
        a, b = np.asarray(got[k]), np.asarray(v)
        if rel:
            assert np.abs(a - b).max() <= rel * np.abs(b).max(), k
        else:
            np.testing.assert_array_equal(a, b, err_msg=k)


@pytest.mark.parametrize("name", cases.CASES + cases.TRAINERS)
def test_tp_step_matches_one_process(ranks, single, name):
    """Each case's two-rank ``model_shards: 2`` step against the one
    process's step on the same batch: bit for bit, the OT trainer's within
    1e-6 (module docstring)."""
    _same(ranks[0][name], single[name], OT_REL if name == "optimal_transport"
          else 0.0)


@pytest.mark.parametrize("name", cases.CASES + cases.TRAINERS)
def test_model_ranks_bit_equal(ranks, name):
    _same(ranks[1][name], ranks[0][name])


@pytest.mark.parametrize("name", cases.CASES + cases.TRAINERS)
def test_no_rank_holds_a_whole_master(ranks, single, name):
    """Between steps each rank holds half of every sharded leaf (its
    master, and for the trainers its Adam moments), at least 4 leaves,
    and so a little over half of the one process's bytes."""
    got = ranks[0][name]
    assert len(got["shapes"]) >= 4
    for n, shape in got["shapes"].items():
        whole = single[name][n].shape
        assert np.prod(shape) * 2 == np.prod(whole), (n, shape, whole)
    assert got["bytes"] < 0.55 * single[name]["bytes"], (
        got["bytes"], single[name]["bytes"])


@pytest.mark.parametrize("fault", sorted(cases.FAULTS))
def test_planted_fault_fails(ranks, single, fault):
    got, ref = ranks[0][fault], single["contrastive"]
    k, e = _worst(_leaf_errors(got, ref, _keys(ref)))
    assert e > 10 * JAX_GRAD, (k, e)


@pytest.mark.parametrize("name", cases.GRID_CASES)
def test_grid_matches_data_parallel_alone(grid_ranks, name):
    """``n_shards: 2`` x ``model_shards: 2`` against ``n_shards: 2`` alone
    on the same data shards, rank by rank, bit for bit; the four ranks
    bit-equal."""
    for r in grid_ranks:
        _same(r[name], r[f"dp_{name}"])
        _same(r[name], grid_ranks[0][name])
        assert r[name]["bytes"] < 0.55 * r[f"dp_{name}"]["bytes"]


def _jax_batch(collate):
    ds = dp.Molecules()
    b2, b3 = dp.buckets(ds.items)
    kw = {} if collate == "graph_collate" else {
        "bucket3d": JaxBucket(b3.n_graphs, b3.n_nodes, b3.n_edges)}
    return next(iter(JaxLoader(ds, dp.B, collate, bucket=JaxBucket(
        b2.n_graphs, b2.n_nodes, b2.n_edges), shuffle=False, prefetch=0,
        collate_kwargs=kw)))


def _jax_tp_step(tr, models, batch):
    """`tr.loss_fn`'s value and gradient, jitted, on the cases' seeded
    weights put in the JAX package's TP layout on `make_tp_mesh(1, 2)`
    (`tp_shard_params` / `tp_shard_tree`); the loss, gradients and updated
    running statistics in the port's names."""
    mesh = make_tp_mesh(1, cases.K)
    var = dp.variables(models)
    keys = sorted(models)
    params = {k: tp_shard_params(jax.tree_util.tree_map(
        jnp.asarray, var[k]["params"]), mesh) for k in keys}
    stats = {k: tp_shard_tree(jax.tree_util.tree_map(
        jnp.asarray, var[k]["batch_stats"]), mesh) for k in keys}
    assert any("model" in tuple(p.sharding.spec)
               for p in jax.tree_util.tree_leaves(params))

    def lf(pp):
        loss, _, new_stats = tr.loss_fn(pp, stats, batch, 0,
                                        jax.random.key(0), True)
        return loss, new_stats

    with mesh:
        (loss, new_stats), grads = jax.jit(jax.value_and_grad(
            lf, has_aux=True))(params)
    out = {"loss": float(loss)}
    for k in keys:
        sd = params_from_jax(
            jax.tree_util.tree_map(lambda v: np.asarray(v, np.float32),
                                   jax.device_get(grads[k])),
            jax.tree_util.tree_map(lambda v: np.asarray(v, np.float32),
                                   jax.device_get(new_stats[k])))
        out.update({f"{k}.{n}": v.numpy() for n, v in sd.items()
                    if "num_batches" not in n})
    return out


def _jax_reference(name):
    if name == "contrastive":
        tr = SelfSupervisedTrainer.__new__(SelfSupervisedTrainer)
        tr.models = {"model": JaxPNA(**dp.PNA),
                     "model3d": JaxNet3D(**dp.NET3D)}
        tr.loss_func = LOSS_REGISTRY["NTXent"](tau=0.1)
        models = {"model": ("PNA", dp.PNA), "model3d": ("Net3D", dp.NET3D)}
        batch = _jax_batch("contrastive_collate")
    else:
        tr = Trainer.__new__(Trainer)
        tr.models = {"model": JaxPNA(**cases.SUP_PNA)}
        tr.loss_name = "L1Loss"
        models = {"model": ("PNA", cases.SUP_PNA)}
        batch = _jax_batch("graph_collate")
    tr.compute_dtype, tr.args, tr.mesh, tr._loss_fn_extra = None, {}, None, \
        None
    return _jax_tp_step(tr, models, batch)


@pytest.mark.parametrize("name", ["contrastive", "supervised"])
def test_tp_step_matches_jax_tp_step(runs, name):
    """The port's ``model_shards: 2`` step against the JAX package's step
    with its parameters and statistics in the TP layout of
    `make_tp_mesh(1, 2)`: loss, gradients and running statistics
    (tolerances in the module docstring)."""
    ref, got = runs[3][name], runs[0][0][name]
    assert abs(got["loss"] - ref["loss"]) <= JAX_LOSS * abs(ref["loss"]), \
        (got["loss"], ref["loss"])
    keys = _grad_keys(ref)
    assert set(keys) == set(_keys(got))
    k, e = _worst(_leaf_errors(got, ref, keys))
    assert e <= JAX_GRAD, (k, e)
    stats = [k for k in ref if "running" in k]
    assert stats
    k, e = _worst(_stats_errors(got, ref, stats))
    assert e <= JAX_STATS, (k, e)


# --- the CLI ----------------------------------------------------------------

@pytest.fixture(scope="module")
def qm9_root(tmp_path_factory):
    from infomax3d_tpu_torch.data.synthetic import write_synthetic_cache
    root = tmp_path_factory.mktemp("tp_data")
    write_synthetic_cache(str(root / "QM9" / "processed.npz"), num=96,
                          num_targets=19, seed=21)
    return str(root)


def _tp_args(tmp_path, model_shards, **over):
    """tests/test_tp_mode.py's run, on the CPU through gloo."""
    from infomax3d_tpu_torch.cli.config import load_config
    return load_config(None, dict(dict(
        dataset="qm9", targets=["homo"], model_type="PNA",
        model_parameters=dict(hidden_dim=16, target_dim=1,
                              aggregators=["mean", "max"],
                              scalers=["identity"],
                              readout_aggregators=["mean"],
                              propagation_depth=2, readout_layers=1,
                              readout_batchnorm=False),
        loss_func="L1Loss", metrics=["mae"], main_metric="mae",
        batch_size=16, num_train=48, num_epochs=2, patience=5,
        minimum_epochs=0, log_iterations=-1, use_tensorboard=False,
        eval_per_epochs=0, logdir=str(tmp_path), seed=123,
        model_shards=model_shards, bf16_compute=False, device="cpu",
        dist_backend="gloo"), **over))


def test_cli_model_shards_matches_one_process_and_checkpoint_loads(
        qm9_root, tmp_path, monkeypatch):
    """`model_shards: 2` through the training CLI (two gloo ranks it
    starts): its metric is the `model_shards: 1` run's at rtol 5e-4; one
    run directory, written by rank 0, whose checkpoint holds whole
    tensors (the one-process model's shapes, Adam's moments shaped as
    their parameters) and resumes a one-process run that evaluates them
    to the tensor-parallel run's metric."""
    from infomax3d_tpu_torch.cli.train import train
    from infomax3d_tpu_torch.train.checkpoint import load_checkpoint
    monkeypatch.setenv("INFOMAX3D_DATA", qm9_root)
    for k in ("WORLD_SIZE", "COORDINATOR_ADDRESS"):
        monkeypatch.delenv(k, raising=False)
    res_tp = train(_tp_args(tmp_path / "tp", 2))
    res_1 = train(_tp_args(tmp_path / "one", 1))
    assert np.isfinite(res_tp["mae"])
    np.testing.assert_allclose(res_tp["mae"], res_1["mae"], rtol=5e-4,
                               atol=5e-5)
    runs = os.listdir(tmp_path / "tp")
    assert len(runs) == 1
    ckpt = tmp_path / "tp" / runs[0] / "best_checkpoint.pt"
    payload = load_checkpoint(str(ckpt))
    one = load_checkpoint(str(tmp_path / "one" / os.listdir(
        tmp_path / "one")[0] / "best_checkpoint.pt"))
    assert {n: tuple(t.shape) for n, t in
            payload["model_state_dict"].items()} == {
        n: tuple(t.shape) for n, t in one["model_state_dict"].items()}
    opt, opt1 = (p["optimizer_state_dict"]["state"] for p in (payload, one))
    assert opt.keys() == opt1.keys()
    for i in opt:
        for key in ("exp_avg", "exp_avg_sq"):
            assert opt[i][key].shape == opt1[i][key].shape, (i, key)
    resumed = train(_tp_args(tmp_path / "resumed", 1, num_epochs=1,
                             checkpoint=str(ckpt)))
    np.testing.assert_allclose(resumed["mae"], res_tp["mae"], rtol=1e-6)


def test_cli_refuses_model_shards_with_graph_shards(tmp_path):
    from infomax3d_tpu_torch.cli.train import train
    with pytest.raises(ValueError, match="model_shards cannot combine"):
        train(_tp_args(tmp_path, 2, graph_shards=2))
