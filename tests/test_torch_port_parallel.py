"""Data parallelism (`infomax3d_tpu_torch/parallel/`, the JAX package's
``n_shards`` mode) on the CPU: two gloo ranks, started once for the module
(`tests/torch_dp_cases.py`, rendezvous in a file store under a temporary
directory, one torch thread each), run every case; the test holds them
against the JAX package's `shard_map` step on 2 of the 8 virtual CPU
devices, against the port's own single-process step on the concatenated
batch, and each other.  16 molecules (8 per rank), tests/test_parallel.py's
small widths, every weight and input from numpy seeds.

Tolerances, each with its reading on this data.  A gradient leaf's error
is its max |got - ref| over the larger of its own max |ref| and 1e-2 of
the case's largest gradient (`FLOOR`): the leaves whose true gradient is
zero (a bias or BatchNorm shift feeding a BatchNorm) carry only rounding,
which this reads against the gradients around them.  A running statistic's
error is its max |got - ref| over the buffer's max |ref|.

* Two ranks against one process on the concatenated batch (the same
  float32 code; the ranks' partial sums, then the all-reduce, change only
  the summation order): losses within 1e-5 relative (readings 0 to
  2.2e-6, GraphCL's, whose loss of 0.39 is a difference of near-equal
  terms), the autoencoder's within 1e-4 (2.8e-5, its reconstruction part
  3.2e-5: a mean of ~2.5e3 squared distance errors of size ~20); every
  gradient leaf within 1e-3 (readings: contrastive 2.1e-4, supervised
  1.9e-5, alternating 1.9e-4, noisy negatives 2.4e-4, GraphCL 7.8e-5,
  BYOL 1.8e-4, distance 1.2e-5), the autoencoder's within 1e-2 (2.8e-3:
  Net3DAE's edge BatchNorms sum ~2.5e3 rows whose mean^2 / var is large,
  and `var = E[x^2] - mean^2`, the JAX package's formula, multiplies
  float32's rounding by it); the running statistics within 1e-4 (readings
  up to 5.7e-6), the autoencoder's within 1e-3 (5.1e-5); BYOL's teachers
  after their EMA within 1e-3 (6.8e-4: the EMA takes the students after
  one Adam step, whose sign-like first step flips on the zero-gradient
  leaves); the eval loss (before the step) within 1e-5 (readings 0 and
  1.8e-7) and the gathered rows the metrics read within 1e-5 (readings
  0).  The Local loss through `CrossDeviceLoss` is exact (reading 0).
* Two ranks against the JAX `shard_map` step (JAX on its non-CSR batch,
  the port on the CSR batch of the same shards): the loss within 1e-5
  relative (readings 3.3e-7 contrastive, 0 supervised), each gradient
  leaf within 1e-3 (1.9e-4, 2.8e-5), the running statistics within 1e-4
  (2.1e-6, 7.0e-8).  The JAX package's own tests/test_parallel.py holds
  its sharded step to its single-device step at 3e-4 of the leaf scale
  with a 5e-4 floor.
* The ranks against each other: losses, gradients and running statistics
  bit-equal (every rank reads the same all-reduced sums).
* Planted faults (in the ranks, on the contrastive case) must read beyond
  the gradient bound by 10x: BatchNorm statistics left local (reading
  2.7), the loss on local rows only (3.3), gradients summed instead of
  averaged (1.0, and the loss 1.0 off).

The file takes ~45 s on one worker: the ranks ~8 s, the CLI's two ranks
and its single-process run ~6 s, the JAX philosophy trainer's init and
trace ~13 s, the two JAX `shard_map` steps ~5 s.
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
from jax.sharding import PartitionSpec as P

from infomax3d_tpu.data.loader import GraphDataLoader as JaxLoader
from infomax3d_tpu.graphs.batch import BucketSpec as JaxBucket
from infomax3d_tpu.losses import LOSS_REGISTRY
from infomax3d_tpu.models import PNA as JaxPNA
from infomax3d_tpu.models.gin import OGBGNN as JaxOGBGNN
from infomax3d_tpu.models.net3d import Net3D as JaxNet3D
from infomax3d_tpu.parallel import CrossDeviceLoss as JaxCrossDeviceLoss
from infomax3d_tpu.parallel import make_mesh
from infomax3d_tpu.parallel.context import using_cross_replica_axis
from infomax3d_tpu.parallel.multihost import \
    host_shard_indices as jax_host_shard_indices
from infomax3d_tpu.train.trainer import SelfSupervisedTrainer, Trainer
from infomax3d_tpu_torch.data.loader import GraphDataLoader
from infomax3d_tpu_torch.interop import params_from_jax
from infomax3d_tpu_torch.parallel import (host_shard_indices, rank_devices)
from infomax3d_tpu_torch.parallel.multihost import launch_environment
from infomax3d_tpu_torch.train.trainer import rank_seed

import torch_dp_cases as cases
from test_torch_port_trainer import _same_arrays

ROOT = Path(__file__).resolve().parents[1]
FLOOR = 1e-2
LOSS_TOL = {"autoencoder": 1e-4}
GRAD_TOL = {"autoencoder": 1e-2}
STATS_TOL = {"autoencoder": 1e-3}
LOSS_RTOL, GRAD_RTOL, STATS_RTOL = 1e-5, 1e-3, 1e-4
JAX_LOSS, JAX_GRAD, JAX_STATS = 1e-5, 1e-3, 1e-4


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Both ranks' results of every case (`torch_dp_cases.main`)."""
    out = tmp_path_factory.mktemp("dp_ranks")
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, str(ROOT / "tests" / "torch_dp_cases.py"), str(r),
         str(cases.K), str(out)], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True, env=env)
        for r in range(cases.K)]
    logs = [p.communicate(timeout=300)[0] for p in procs]
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log
    results = []
    for r in range(cases.K):
        with open(out / f"rank{r}.pkl", "rb") as f:
            results.append(pickle.load(f))
    return results


@pytest.fixture(scope="module")
def single(tmp_path_factory):
    """Each case in one process on the whole batch."""
    out = tmp_path_factory.mktemp("dp_single")
    return {name: cases.run(name, None, 0, 1, str(out / name))
            for name in cases.CASES}


def _grad_keys(ref):
    return [k for k, v in ref.items()
            if k not in ("loss", "eval_loss", "preds", "targets", "zn", "zg")
            and not k.startswith(("extra.", "teacher."))
            and "running" not in k]


def _leaf_errors(got, ref, keys):
    gmax = max(np.abs(ref[k]).max() for k in keys)
    return {k: float(np.abs(np.asarray(got[k]) - ref[k]).max()
                     / max(np.abs(ref[k]).max(), FLOOR * gmax))
            for k in keys}


def _stats_errors(got, ref, keys):
    return {k: float(np.abs(np.asarray(got[k]) - ref[k]).max()
                     / np.abs(ref[k]).max()) for k in keys}


def _worst(errs):
    k = max(errs, key=errs.get)
    return k, errs[k]


# --- against one process ----------------------------------------------------

@pytest.mark.parametrize("name", cases.CASES)
def test_two_ranks_match_one_process(ranks, single, name):
    """Each case's two-rank step against the single-process step on the
    concatenated batch (tolerances in the module docstring)."""
    got, ref = ranks[0][name], single[name]
    if name == "local":
        # each rank's rows get the sum of both ranks' cotangents: K times
        # the whole loss's gradient of its rows
        assert got["loss"] == pytest.approx(ref["loss"], rel=LOSS_RTOL)
        for k in ("zn", "zg"):
            both = np.concatenate([ranks[r][name][k] for r in range(cases.K)])
            np.testing.assert_allclose(both / cases.K, ref[k], rtol=1e-6,
                                       atol=1e-7)
        return
    assert abs(got["loss"] - ref["loss"]) <= \
        LOSS_TOL.get(name, LOSS_RTOL) * abs(ref["loss"]), (got["loss"],
                                                           ref["loss"])
    keys = _grad_keys(ref)
    assert set(keys) <= set(got)
    k, e = _worst(_leaf_errors(got, ref, keys))
    assert e <= GRAD_TOL.get(name, GRAD_RTOL), (k, e)
    stats = [k for k in ref if "running" in k]
    if stats:
        k, e = _worst(_stats_errors(got, ref, stats))
        assert e <= STATS_TOL.get(name, STATS_RTOL), (k, e)
    if name in cases.FLAVOURS:
        assert got["eval_loss"] == pytest.approx(ref["eval_loss"],
                                                 rel=1e-5)
        for k in ("preds", "targets"):
            assert got[k].shape == ref[k].shape, k
            np.testing.assert_allclose(got[k], ref[k], rtol=1e-5,
                                       atol=1e-5 * np.abs(ref[k]).max())
        for k in (k for k in ref if k.startswith("extra.")):
            assert got[k] == pytest.approx(ref[k], rel=LOSS_TOL.get(
                name, LOSS_RTOL)), k
    teacher = [k for k in ref if k.startswith("teacher.")
               and "running" not in k]
    if teacher:
        k, e = _worst(_leaf_errors(got, ref, teacher))
        assert e <= 1e-3, (k, e)


@pytest.mark.parametrize("name", cases.CASES)
def test_ranks_agree(ranks, name):
    """Both ranks hold the same loss, gradients and running statistics
    (the all-reduced sums are the same on both), bit for bit."""
    a, b = ranks[0][name], ranks[1][name]
    skip = ("zn", "zg") if name == "local" else ()
    for k in a:
        if k not in skip:
            np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]),
                                          err_msg=k)


@pytest.mark.parametrize("fault", sorted(cases.FAULTS))
def test_planted_fault_fails(ranks, single, fault):
    """A planted fault of the data-parallel step (the contrastive case)
    reads beyond the gradient bound by 10x."""
    got, ref = ranks[0][fault], single["contrastive"]
    k, e = _worst(_leaf_errors(got, ref, _grad_keys(ref)))
    assert e > 10 * GRAD_RTOL, (k, e)


# --- against the JAX shard_map step ------------------------------------------

def _jax_stacked(collate):
    """The JAX loader's two stacked shards of the cases' batch on the
    non-CSR buckets of the same sizes."""
    ds = cases.Molecules()
    b2, b3 = cases.buckets(ds.items)
    kw = {} if collate == "graph_collate" else {
        "bucket3d": JaxBucket(b3.n_graphs, b3.n_nodes, b3.n_edges)}
    return next(iter(JaxLoader(ds, cases.B, collate, bucket=JaxBucket(
        b2.n_graphs, b2.n_nodes, b2.n_edges), shuffle=False, prefetch=0,
        n_shards=cases.K, collate_kwargs=kw)))


def _jax_dp_step(tr, keys, batch):
    """`tr.loss_fn` under `shard_map` over 2 devices as the JAX parallel
    step runs it (cross-replica axis set, pmean of loss and gradients),
    from the cases' seeded weights; returns the loss and the gradients
    and updated running statistics in the port's names."""
    mesh = make_mesh(cases.K)
    var = cases.variables(tr.case_models)
    params = {k: jax.tree_util.tree_map(jnp.asarray, var[k]["params"])
              for k in keys}
    stats = {k: jax.tree_util.tree_map(jnp.asarray, var[k]["batch_stats"])
             for k in keys}

    def shard(p, b):
        local = jax.tree_util.tree_map(lambda a: a[0], b)
        with using_cross_replica_axis("data"):
            def lf(pp):
                loss, _, new_stats = tr.loss_fn(pp, stats, local, 0,
                                                jax.random.key(0), True)
                return loss, new_stats
            (loss, new_stats), g = jax.value_and_grad(lf, has_aux=True)(p)
        return jax.lax.pmean(loss, "data"), jax.lax.pmean(g, "data"), \
            new_stats

    loss, grads, new_stats = jax.jit(jax.shard_map(
        shard, mesh=mesh, in_specs=(P(), P("data")), out_specs=(P(), P(), P()),
        check_vma=False))(params, batch)
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


def _jax_contrastive():
    tr = SelfSupervisedTrainer.__new__(SelfSupervisedTrainer)
    tr.models = {"model": JaxPNA(**cases.PNA),
                 "model3d": JaxNet3D(**cases.NET3D)}
    tr.case_models = {"model": ("PNA", cases.PNA),
                      "model3d": ("Net3D", cases.NET3D)}
    tr.loss_func = JaxCrossDeviceLoss(LOSS_REGISTRY["NTXent"](tau=0.1),
                                      "data")
    tr.compute_dtype, tr.args, tr.mesh = None, {}, make_mesh(cases.K)
    tr._loss_fn_extra = None
    return _jax_dp_step(tr, ("model", "model3d"),
                        _jax_stacked("contrastive_collate"))


def _jax_supervised():
    tr = Trainer.__new__(Trainer)
    tr.models = {"model": JaxOGBGNN(**{k: v for k, v in cases.GIN.items()
                                      if k != "emb_dim"})}
    tr.case_models = {"model": ("OGBGNN", cases.GIN)}
    tr.loss_name, tr.compute_dtype, tr.args = "BCEWithLogitsLoss", None, {}
    tr.mesh, tr._loss_fn_extra = make_mesh(cases.K), None
    return _jax_dp_step(tr, ("model",), _jax_stacked("graph_collate"))


@pytest.mark.parametrize("name", ["contrastive", "supervised"])
def test_two_ranks_match_jax_shard_map(ranks, name):
    """The port's two-rank step against the JAX package's `shard_map`
    step on the same shards and weights: loss, running statistics and
    gradients (tolerances in the module docstring)."""
    ref = _jax_contrastive() if name == "contrastive" else _jax_supervised()
    got = ranks[0][name]
    assert abs(got["loss"] - ref["loss"]) <= JAX_LOSS * abs(ref["loss"]), \
        (got["loss"], ref["loss"])
    keys = _grad_keys(ref)
    assert set(keys) == set(_grad_keys(got))
    k, e = _worst(_leaf_errors(got, ref, keys))
    assert e <= JAX_GRAD, (k, e)
    stats = [k for k in ref if "running" in k]
    assert stats and set(stats) == {k for k in got if "running" in k}
    k, e = _worst(_stats_errors(got, ref, stats))
    assert e <= JAX_STATS, (k, e)


# --- the loader, the launch, the refusals ------------------------------------

@pytest.mark.parametrize("case", ["contrastive_collate", "graph_collate",
                                  "batch_sampler"])
def test_loader_shard_matches_jax(case):
    """Shard r of the port's loader holds the arrays of the JAX loader's
    shard r (CSR buckets; the batch sampler path shards the same way),
    two batches each."""
    ds = cases.Molecules()
    b2, b3 = cases.buckets(ds.items)
    collate = "graph_collate" if case == "graph_collate" \
        else "contrastive_collate"
    kw = {} if collate == "graph_collate" else {"bucket3d": b3}
    jkw = {} if collate == "graph_collate" else {"bucket3d": b3}
    sampler = [[3, 1, 4, 15, 9, 2, 6, 5], [8, 0, 7, 14, 13, 10, 12, 11]] \
        if case == "batch_sampler" else None
    bs = 8 if sampler else cases.B // 2
    # buckets for `bs` graphs whose K-way cut holds any `bs` / K of them
    jax_batches = list(JaxLoader(ds, bs, collate, bucket=JaxBucket(
        bs, 2 * b2.n_nodes, 2 * b2.n_edges, max_deg=b2.max_deg, csr=True,
        nmax=b2.nmax), shuffle=True, seed=3,
        prefetch=0, n_shards=cases.K, collate_kwargs={
            k: JaxBucket(bs, 2 * v.n_nodes, 2 * v.n_edges,
                         max_deg=v.max_deg, csr=True, nmax=v.nmax)
            for k, v in jkw.items()}, batch_sampler=sampler))
    assert len(jax_batches) == 2
    from infomax3d_tpu_torch.graphs.batch import BucketSpec
    wide = lambda b: BucketSpec(bs, 2 * b.n_nodes,  # noqa: E731
                                2 * b.n_edges, b.max_deg, True, b.nmax)
    for r in range(cases.K):
        port = list(GraphDataLoader(
            ds, bs, collate, bucket=wide(b2), shuffle=True, seed=3,
            prefetch=0, collate_kwargs={k: wide(v) for k, v in kw.items()},
            n_shards=cases.K, shard=r, batch_sampler=sampler))
        assert len(port) == len(jax_batches)
        for pb, jb in zip(port, jax_batches):
            assert set(pb) == set(jb)
            for view in pb:
                _same_arrays(pb[view], jax.tree_util.tree_map(
                    lambda a: np.asarray(a)[r], jb[view]))


@pytest.mark.parametrize("n,seed,count", [(10, 0, 2), (37, 5, 3),
                                          (1000, 11, 4)])
def test_host_shard_indices_match_jax(n, seed, count):
    shards = [host_shard_indices(n, seed, i, count) for i in range(count)]
    for i, s in enumerate(shards):
        np.testing.assert_array_equal(
            s, jax_host_shard_indices(n, seed, i, count))
    assert sorted(np.concatenate(shards)) == list(range(n))


def test_rank_devices_refuse_what_they_cannot_give():
    """NCCL takes one card per rank and never the CPU; gloo only where it
    is named; no backend or device is switched."""
    assert rank_devices(2, "gloo", "cpu") == [torch.device("cpu")] * 2
    with pytest.raises(ValueError, match="gloo"):
        rank_devices(2, "nccl", "cpu")
    with pytest.raises(RuntimeError, match="one CUDA card per rank"):
        rank_devices(torch.cuda.device_count() + 1, "nccl", "cuda")
    with pytest.raises(ValueError, match="backend"):
        rank_devices(2, "mpi", "cpu")


def test_launch_environment(monkeypatch):
    for k in ("WORLD_SIZE", "RANK", "LOCAL_RANK", "LOCAL_WORLD_SIZE",
              "COORDINATOR_ADDRESS", "NUM_PROCESSES", "PROCESS_ID"):
        monkeypatch.delenv(k, raising=False)
    assert launch_environment() is None
    monkeypatch.setenv("COORDINATOR_ADDRESS", "10.0.0.1:1234")
    monkeypatch.setenv("NUM_PROCESSES", "4")
    monkeypatch.setenv("PROCESS_ID", "2")
    assert launch_environment() == dict(
        rank=2, world=4, local_rank=0, local_world=1,
        init_method="tcp://10.0.0.1:1234")
    for k, v in (("WORLD_SIZE", "8"), ("RANK", "5"), ("LOCAL_RANK", "1"),
                 ("LOCAL_WORLD_SIZE", "4")):
        monkeypatch.setenv(k, v)
    assert launch_environment() == dict(rank=5, world=8, local_rank=1,
                                        local_world=4, init_method="env://")


def test_rank_seed():
    assert rank_seed(7, 0) == 7
    assert len({rank_seed(7, r) for r in range(4)}) == 4
    assert rank_seed(7, 3) == rank_seed(7, 3)


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
                                                   target_dim=8),
                           dense_3d=False), **over))


def _records(run):
    import json
    with open(os.path.join(run, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def test_cli_starts_two_ranks(tmp_path, monkeypatch):
    """`n_shards: 2` through the training CLI (the ranks started by the
    CLI on gloo): one run directory, written by rank 0, whose first
    logged training loss is the single-process run's (1e-5 relative,
    reading 2.4e-6: the same step on the same global batch, summed in
    another order)."""
    from infomax3d_tpu_torch.cli.train import train
    for k in ("WORLD_SIZE", "COORDINATOR_ADDRESS"):
        monkeypatch.delenv(k, raising=False)
    dp = train(_cli_args(tmp_path / "dp", n_shards=2, dist_backend="gloo"))
    one = train(_cli_args(tmp_path / "one"))
    runs = os.listdir(tmp_path / "dp")
    assert len(runs) == 1
    got = _records(tmp_path / "dp" / runs[0])
    ref = _records(tmp_path / "one" / os.listdir(tmp_path / "one")[0])
    assert [r["split"] for r in got] == [r["split"] for r in ref]
    assert got[0]["NTXent"] == pytest.approx(ref[0]["NTXent"], rel=1e-5)
    assert np.isfinite(dp["NTXent"]) and np.isfinite(one["NTXent"])
    assert {"best_checkpoint.pt", "last_checkpoint.pt",
            "train_arguments.yaml", "timing.json"} <= set(
                os.listdir(tmp_path / "dp" / runs[0]))


def test_cli_refusals(tmp_path, monkeypatch):
    """Philosophy and OT refuse `n_shards: 2` (the JAX package fails
    there: test_jax_has_no_dp_step_for_philosophy_or_ot), each before any
    rank starts; `model_shards` (item 9c, ported: tests/
    test_torch_port_tp.py) starts its ranks as `n_shards` does, so on the
    CPU it needs gloo named; `graph_shards`
    / `node_shards` no longer raise but turn the CSR batch and the dense
    3D batch off, as the JAX CLI does; `bucket_ladder` with a contrastive
    collate runs on one static bucket (the JAX CLI builds no ladder
    there); a launch whose world size is not `n_shards` raises."""
    from infomax3d_tpu_torch.cli import train as cli
    from infomax3d_tpu_torch.train.trainer import (OptimalTransportTrainer,
                                                   PhilosophyTrainer)
    for cls in (PhilosophyTrainer, OptimalTransportTrainer):
        with pytest.raises(NotImplementedError, match="n_shards"):
            cls({}, {}, {}, "loss", str(tmp_path), device="cpu",
                group=object())
    with pytest.raises(NotImplementedError, match="philosophy"):
        cli.train(_cli_args(tmp_path, n_shards=2, dist_backend="gloo",
                            trainer="philosophy", critic_type="Critic"))
    with pytest.raises(NotImplementedError, match="optimal-transport"):
        cli.train(_cli_args(tmp_path, n_shards=2, dist_backend="gloo",
                            trainer="optimal_transport",
                            model3d_type=None))
    with pytest.raises(ValueError, match="gloo"):
        cli.train(_cli_args(tmp_path, model_shards=2))
    for knob in ("graph_shards", "node_shards"):
        args = {knob: 2, "collate_function": "contrastive_collate",
                "model3d_type": "Net3D"}
        cli.resolve_fast_paths(args)
        assert args["csr_buckets"] is False and args["dense_3d"] is False
        assert not args["_csr"] and not args["_dense_3d"]
    assert np.isfinite(cli.train(_cli_args(tmp_path / "ladder",
                                           bucket_ladder=True))["NTXent"])
    monkeypatch.setenv("WORLD_SIZE", "3")
    with pytest.raises(ValueError, match="must be equal"):
        cli.train(_cli_args(tmp_path, n_shards=2, dist_backend="gloo"))
    monkeypatch.delenv("WORLD_SIZE")
    with pytest.raises(ValueError, match="gloo"):
        cli.train(_cli_args(tmp_path, n_shards=2))


def test_jax_has_no_dp_step_for_philosophy_or_ot(tmp_path):
    """What the port's refusals stand on: under `n_shards: 2` the JAX
    package's OT loader cannot stack its shards' `ot_collate` arrays, and
    its philosophy step (a plain jit without the mesh) fails on the
    stacked shard batch."""
    from infomax3d_tpu.data.synthetic import SyntheticMolecules as JaxMols
    from infomax3d_tpu.train.trainer import PhilosophyTrainer as JaxPhil
    mols = JaxMols(8, seed=0, n_min=6, n_max=12, num_conformers=2)
    items = [{"graph2d": mols.graph2d(i),
              "conformers3d": [mols.graph3d(i, conformer=c)
                               for c in range(2)]} for i in range(8)]
    with pytest.raises(ValueError, match="same shape"):
        next(iter(JaxLoader(items, 8, "ot_collate", bucket=JaxBucket(
            8, 256, 512), shuffle=False, prefetch=0, n_shards=2,
            collate_kwargs={"n_true_confs": 2})))
    stacked = _jax_stacked("contrastive_collate")
    critic = dict(metric_dim=12, hidden_dim=12, layers=1, repeats=1)
    from infomax3d_tpu.models import get_model_class
    models = {"model": JaxPNA(**cases.PNA),
              "model3d": JaxNet3D(**cases.NET3D),
              "critic": get_model_class("Critic")(**critic)}
    tr = JaxPhil(models, dict(optimizer="Adam",
                              optimizer_params={"lr": 1e-3},
                              bf16_compute=False),
                 metrics={}, main_metric="loss",
                 run_dir=str(tmp_path / "dp_phil"),
                 loss_func=LOSS_REGISTRY["NTXent"](tau=0.1),
                 loss_name="NTXent", use_tensorboard=False,
                 critic_loss=LOSS_REGISTRY["CriticLoss"](),
                 mesh=make_mesh(2))
    tr.init_state(tr.single_shard(stacked))
    step, _ = tr._steps_for(stacked)
    with pytest.raises(ValueError, match="Incompatible shapes"):
        step(tr.state, stacked, tr._full_lr_vectors(), jax.random.key(0))
