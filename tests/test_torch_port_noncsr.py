"""The non-CSR batch and its bucket ladder (`csr_buckets: False`,
`bucket_ladder: true`): `graphs/batch.py` without the CSR arrays, the
segment path of `ops/aggregate.py` / `ops/segment.py`, the loader's ladder
and the CLI knobs, held against the JAX package.

* `batch_graphs` with a non-CSR bucket gives the JAX batcher's arrays for
  the same bucket, key for key (the JAX mailbox arrays aside: the port
  does not emit them), with and without the readout regroup.
* `make_bucket_ladder` / `pick_bucket` and the loader's per-batch picks
  equal the JAX package's.
* One float32 step of PNA + the flat Net3D under NT-Xent, and of the GIN
  under masked BCE, on the non-CSR batch against the JAX step on the same
  batch with the mailbox (``max_deg`` > 0: the JAX package aggregates
  through `ops/mailbox.py`) and without it (``max_deg`` 0: its segment
  ops), from the same weights: the tolerances of the port's other
  JAX-held steps (tests/test_torch_port_parallel.py: loss 1e-5 relative,
  gradient leaves 1e-3 of the larger of their scale and 1e-2 of the
  largest gradient, running statistics 1e-4; readings in the test), and
  against the port's own CSR step (the same bounds).
* The max / min aggregates on a batch with tied messages: forward and
  gradient bit-equal to JAX's segment path (XLA's segment max shares a
  tie's cotangent evenly among the tied edges, as `scatter_reduce`
  "amax" does); the mean and std within 1e-6.
* The CLI trains with `csr_buckets: False` and with `bucket_ladder` on
  `graph_collate`, each batch in its ladder bucket.

One torch thread; ~30 s on one worker.
"""
import dataclasses
import os
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from infomax3d_tpu.data.loader import GraphDataLoader as JaxLoader
from infomax3d_tpu.graphs.batch import BucketSpec as JaxBucket
from infomax3d_tpu.graphs.batch import batch_graphs as jax_batch_graphs
from infomax3d_tpu.graphs.batch import make_bucket_ladder as jax_ladder
from infomax3d_tpu.graphs.batch import pick_bucket as jax_pick
from infomax3d_tpu.losses import LOSS_REGISTRY
from infomax3d_tpu.models import PNA as JaxPNA
from infomax3d_tpu.models.gin import OGBGNN as JaxOGBGNN
from infomax3d_tpu.models.net3d import Net3D as JaxNet3D
from infomax3d_tpu.ops.segment import pna_multi_aggregate
from infomax3d_tpu.train.trainer import SelfSupervisedTrainer, Trainer
from infomax3d_tpu_torch.data.loader import GraphDataLoader, to_device
from infomax3d_tpu_torch.data.synthetic import SyntheticMolecules
from infomax3d_tpu_torch.graphs.batch import (BucketSpec, batch_graphs,
                                              make_bucket_ladder,
                                              pick_bucket)
from infomax3d_tpu_torch.interop import params_from_jax
from infomax3d_tpu_torch.ops.aggregate import pna_aggregate_parts
from infomax3d_tpu_torch.train.pretrain import PretrainStep
from infomax3d_tpu_torch.train.supervised import SupervisedStep

import torch_dp_cases as cases

ROOT = Path(__file__).resolve().parents[1]
LOSS_RTOL, GRAD_RTOL, STATS_RTOL = 1e-5, 1e-3, 1e-4


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# --- the batch and the ladder --------------------------------------------------

@pytest.mark.parametrize("view", ["graph2d", "graph3d"])
@pytest.mark.parametrize("max_deg", [0, 1])
@pytest.mark.parametrize("readout", [True, False])
def test_batch_arrays_match_jax(view, max_deg, readout):
    items = cases.Molecules().items
    mols = [it[view] for it in items]
    tight = cases.tight_buckets(items)[0 if view == "graph2d" else 1]
    K = tight.max_deg if max_deg else 0
    nmax = tight.nmax if readout else 0
    got = batch_graphs(mols, BucketSpec(tight.n_graphs, tight.n_nodes,
                                        tight.n_edges, K, False, nmax))
    ref = jax_batch_graphs(mols, JaxBucket(tight.n_graphs, tight.n_nodes,
                                           tight.n_edges, max_deg=K,
                                           nmax=nmax))
    assert not any(k.startswith(("csr_", "csc_")) for k in got)
    assert ("rd_node_idx" in got) == readout
    for k, v in got.items():
        np.testing.assert_array_equal(v, ref[k], err_msg=k)
    # what the port leaves out: the mailbox (max_deg > 0) and edge_graph
    assert set(ref) - set(got) <= {"edge_graph", "mb_in_edges", "mb_in_mask",
                                   "mb_edge_slot", "mb_out_edges",
                                   "mb_out_mask", "mb_out_slot"}


def test_ladder_and_picks_match_jax():
    ds = SyntheticMolecules(300, seed=4, n_min=5, n_max=40)
    nodes = np.array([ds.graph2d(i)["node_feat"].shape[0]
                      for i in range(300)])
    edges = np.array([ds.graph2d(i)["senders"].shape[0] for i in range(300)])
    for bs, n_buckets, nmax in ((16, 3, 0), (32, 4, 40), (7, 2, 0)):
        got = make_bucket_ladder(bs, nodes, edges, n_buckets, nmax=nmax)
        ref = jax_ladder(bs, nodes, edges, n_buckets, nmax=nmax)
        assert [(b.n_graphs, b.n_nodes, b.n_edges, b.max_deg, b.csr, b.nmax)
                for b in got] == [(b.n_graphs, b.n_nodes, b.n_edges,
                                   b.max_deg, b.csr, b.nmax) for b in ref]
        for n_tot in range(0, 2 * got[-1].n_nodes, 37):
            for e_tot in range(0, 2 * got[-1].n_edges, 97):
                a, b = pick_bucket(got, n_tot, e_tot), jax_pick(ref, n_tot,
                                                                 e_tot)
                assert (a.n_nodes, a.n_edges) == (b.n_nodes, b.n_edges)


def test_loader_ladder_picks_match_jax():
    """Every batch of a shuffled epoch (64 molecules of 4 to 40 atoms)
    lands in the JAX loader's bucket, and the picks vary."""
    mols = SyntheticMolecules(64, seed=2, n_min=4, n_max=40)
    ds = [{"graph2d": mols.graph2d(i), "targets": mols.targets[i]}
          for i in range(64)]
    nodes = [it["graph2d"]["node_feat"].shape[0] for it in ds]
    edges = [it["graph2d"]["senders"].shape[0] for it in ds]
    ladder = make_bucket_ladder(4, nodes, edges, 3, node_align=8,
                                edge_align=16)
    jl = jax_ladder(4, nodes, edges, 3, node_align=8, edge_align=16)
    assert len(ladder) > 1
    got = [b["graph"]["node_feat"].shape[0] for b in GraphDataLoader(
        ds, 4, "graph_collate", ladder=ladder, seed=3, prefetch=0)]
    ref = [b["graph"].node_feat.shape[0] for b in JaxLoader(
        ds, 4, "graph_collate", ladder=jl, seed=3, prefetch=0)]
    assert got == ref and len(set(got)) > 1


# --- one step against JAX ------------------------------------------------------

CASES = {
    "contrastive": ("contrastive_collate", {"model": ("PNA", cases.PNA),
                                            "model3d": ("Net3D",
                                                        cases.NET3D)}),
    "supervised": ("graph_collate", {"model": ("OGBGNN", cases.GIN)}),
}


def _views(collate, mailbox):
    """(the port's non-CSR view, the JAX loader's batch) of the cases'
    molecules in the tight buckets, the JAX ones with the mailbox
    (``max_deg``) or without it."""
    ds = cases.Molecules()
    b2, b3 = cases.tight_buckets(ds.items)
    port = [dataclasses.replace(b, csr=False, max_deg=0) for b in (b2, b3)]
    ref = [JaxBucket(b.n_graphs, b.n_nodes, b.n_edges,
                     max_deg=b.max_deg if mailbox else 0, nmax=b.nmax)
           for b in (b2, b3)]

    def first(loader_cls, buckets):
        kw = {} if collate == "graph_collate" else {"bucket3d": buckets[1]}
        return next(iter(loader_cls(ds, cases.B, collate, bucket=buckets[0],
                                    shuffle=False, prefetch=0,
                                    collate_kwargs=kw)))
    return first(GraphDataLoader, port), first(JaxLoader, ref)


def _jax_step(name, batch):
    """The JAX trainer's `loss_fn` under `jax.value_and_grad` (float32)
    from the cases' weights: loss, gradients, running statistics in the
    port's names."""
    models = CASES[name][1]
    var = cases.variables(models)
    if name == "contrastive":
        tr = SelfSupervisedTrainer.__new__(SelfSupervisedTrainer)
        tr.models = {"model": JaxPNA(**cases.PNA),
                     "model3d": JaxNet3D(**cases.NET3D)}
        tr.loss_func = LOSS_REGISTRY["NTXent"](tau=0.1)
    else:
        tr = Trainer.__new__(Trainer)
        tr.models = {"model": JaxOGBGNN(**{k: v for k, v in cases.GIN.items()
                                          if k != "emb_dim"})}
        tr.loss_name = "BCEWithLogitsLoss"
    tr.compute_dtype, tr.args, tr.mesh, tr._loss_fn_extra = None, {}, None, \
        None
    keys = tuple(models)
    params = {k: jax.tree_util.tree_map(jnp.asarray, var[k]["params"])
              for k in keys}
    stats = {k: jax.tree_util.tree_map(jnp.asarray, var[k]["batch_stats"])
             for k in keys}

    def lf(p):
        loss, _, new_stats = tr.loss_fn(p, stats, batch, 0,
                                        jax.random.key(0), True)
        return loss, new_stats
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


def _port_step(name, view):
    """The port's float32 step on a collated view."""
    var = cases.variables(CASES[name][1])
    if name == "contrastive":
        step = PretrainStep(cases.PNA, cases.NET3D, var, "cpu", None,
                            {"tau": 0.1}, {"lr": 1e-3}, "NTXent", "Net3D",
                            "PNA")
        batches = step.prepare(to_device(view["graph2d"], "cpu"),
                               to_device(view["graph3d"], "cpu"))
        named = list(step.named_parameters())
        modules = {"model": step.model, "model3d": step.model3d}
    else:
        step = SupervisedStep("OGBGNN", cases.GIN, var["model"], "cpu", None,
                              "BCEWithLogitsLoss", {"lr": 1e-3})
        batches = (step.prepare(to_device(view["graph"], "cpu")),)
        named = [("model." + n, p) for n, p in step.model.named_parameters()]
        modules = {"model": step.model}
    return cases._record(step.loss_and_grads(*batches), named, modules)


def _errors(got, ref):
    """(loss, worst gradient leaf, worst running statistic), relative."""
    grad_keys = [k for k in ref if k != "loss" and "running" not in k]
    gmax = max(np.abs(ref[k]).max() for k in grad_keys)
    grad = max(np.abs(got[k] - ref[k]).max()
               / max(np.abs(ref[k]).max(), 1e-2 * gmax) for k in grad_keys)
    stats = max((np.abs(got[k] - ref[k]).max() / np.abs(ref[k]).max()
                 for k in ref if "running" in k), default=0.0)
    return abs(got["loss"] - ref["loss"]) / abs(ref["loss"]), grad, stats


@pytest.mark.parametrize("mailbox", [True, False])
@pytest.mark.parametrize("name", list(CASES))
def test_noncsr_step_matches_jax(name, mailbox):
    """The port's non-CSR step against the JAX non-CSR step, with and
    without the JAX mailbox.  Readings (loss, gradient, statistics), with
    / without the mailbox: contrastive 4.1e-7 / 2.1e-4 / 3.1e-6 and
    1.3e-6 / 1.7e-4 / 4.1e-6 (the PNA std's knife edge, see
    tests/test_torch_port_remat.py), supervised 0 / 4.5e-5 / 1.9e-7 and
    9.9e-8 / 3.6e-5 / 1.9e-7."""
    view, batch = _views(CASES[name][0], mailbox)
    assert view.get("graph", view.get("graph2d")).get("csr_row_ptr") is None
    if mailbox:
        assert "mb_in_edges" in batch.get("graph", batch.get(
            "graph2d")).extras
    loss, grad, stats = _errors(_port_step(name, view),
                                _jax_step(name, batch))
    assert loss <= LOSS_RTOL and grad <= GRAD_RTOL and stats <= STATS_RTOL, \
        (loss, grad, stats)


@pytest.mark.parametrize("name", list(CASES))
def test_noncsr_step_matches_csr_step(name):
    """The segment path against the kernels' path (their twins here) on
    the same molecules and weights.  Readings: contrastive 8.2e-8 /
    1.1e-4 / 6.6e-7, supervised 0 / 2.9e-6 / 0."""
    collate = CASES[name][0]
    loss, grad, stats = _errors(
        _port_step(name, cases.loader(collate, 1, 0, csr=False, tight=True)),
        _port_step(name, cases.loader(collate, 1, 0, tight=True)))
    assert loss <= LOSS_RTOL and grad <= GRAD_RTOL and stats <= STATS_RTOL, \
        (loss, grad, stats)


def test_max_min_ties_match_jax():
    """Integer-valued messages (many ties), padding edges, an empty node:
    max / min forward and gradient bit-equal to the JAX segment path,
    mean and std within 1e-6."""
    rng = np.random.default_rng(0)
    N, D = 6, 4
    recv = np.array([0, 0, 0, 1, 1, 2, 2, 2, 2, 3, 3, 5, 6, 6], np.int32)
    msg = rng.integers(-2, 3, size=(recv.shape[0], D)).astype(np.float32)
    deg = np.bincount(recv.clip(0, N), minlength=N + 1)[:N].astype(
        np.float32)

    class Batch:
        csr, num_nodes = False, N
        receivers = torch.from_numpy(recv)
        in_degree = torch.from_numpy(deg)

    for aggs, exact in ((["max", "min"], True), (["mean", "std"], False)):
        ct = rng.normal(size=(N, len(aggs) * D)).astype(np.float32)
        out, vjp = jax.vjp(lambda m: pna_multi_aggregate(
            m, jnp.asarray(recv), N, aggs, ("identity",), 1.0,
            deg=jnp.asarray(deg)), jnp.asarray(msg))
        ref_grad = np.asarray(vjp(jnp.asarray(ct))[0])
        m = torch.from_numpy(msg).requires_grad_()
        got = torch.cat(pna_aggregate_parts(Batch, m, aggs, ("identity",)),
                        dim=-1)
        got.backward(torch.from_numpy(ct))
        if exact:
            np.testing.assert_array_equal(got.detach().numpy(),
                                          np.asarray(out))
            np.testing.assert_array_equal(m.grad.numpy(), ref_grad)
        else:
            np.testing.assert_allclose(got.detach().numpy(), np.asarray(out),
                                       rtol=1e-6, atol=1e-6)
            np.testing.assert_allclose(m.grad.numpy(), ref_grad, rtol=1e-6,
                                       atol=1e-6)


# --- the CLI -------------------------------------------------------------------

def _cli_args(tmp_path, config, **over):
    from infomax3d_tpu_torch.cli.config import load_config
    return load_config(str(ROOT / "configs_clean" / config), dict(dict(
        logdir=str(tmp_path), use_tensorboard=False, device="cpu",
        num_epochs=1, log_iterations=1,
        dataset_params={"num": 176, "n_max": 16}, num_train=32,
        batch_size=16, eval_on_test=False), **over))


def test_cli_runs_without_csr_and_with_the_ladder(tmp_path, monkeypatch,
                                                  capsys):
    """`csr_buckets: False` trains the flat collates on the non-CSR batch
    (first logged loss within 1e-5 of the CSR run's); `bucket_ladder` on
    `graph_collate` without CSR gives the loaders a ladder and each batch
    its pick; with CSR on it says once that the ladder is unused."""
    import json
    from infomax3d_tpu_torch.cli import train as cli
    small = dict(model_parameters=dict(cases.PNA, target_dim=8,
                                       readout_aggregators=["mean"]),
                 model3d_parameters=dict(cases.NET3D, target_dim=8),
                 dense_3d=False)

    def first_loss(d):
        run = os.path.join(d, os.listdir(d)[0])
        with open(os.path.join(run, "metrics.jsonl")) as f:
            return json.loads(f.readline())["NTXent"]
    cli.train(_cli_args(tmp_path / "csr", "pre-train_synthetic.yml", **small))
    cli.train(_cli_args(tmp_path / "plain", "pre-train_synthetic.yml",
                        csr_buckets=False, **small))
    assert first_loss(tmp_path / "plain") == pytest.approx(
        first_loss(tmp_path / "csr"), rel=1e-5)

    tune = dict(model_parameters=dict(cases.PNA, target_dim=1,
                                      readout_aggregators=["mean"]))
    args = _cli_args(tmp_path / "ladder", "tune_synthetic.yml",
                     csr_buckets=False, bucket_ladder=True, **tune)
    cli.resolve_collate(args)
    ds = cli.build_dataset(args)
    cli.resolve_fast_paths(args)
    train_loader = cli.make_loaders(args, ds)[0]
    assert train_loader.bucket is None and len(train_loader.ladder) >= 1
    for b in train_loader:
        assert "csr_row_ptr" not in b["graph"]
        assert b["graph"]["node_feat"].shape[0] in {
            s.n_nodes for s in train_loader.ladder}
    assert np.isfinite(cli.train(args)["mae"])
    capsys.readouterr()
    on = _cli_args(tmp_path / "on", "tune_synthetic.yml", bucket_ladder=True,
                   **tune)
    cli.resolve_collate(on)
    cli.resolve_fast_paths(on)
    assert cli.make_loaders(on, ds)[0].ladder is None
    assert "bucket_ladder: unused" in capsys.readouterr().out
