"""`remat: true` in the port (`infomax3d_tpu_torch/train/remat.py`): the
training forwards run under `torch.utils.checkpoint` and are recomputed
in the backward, as the JAX trainer wraps its training forward in
`jax.checkpoint` (tests/test_remat.py).

* The port's step with and without remat, float32 on the CPU, for PNA +
  the flat Net3D under NT-Xent and for the GIN with dropout: the loss,
  every gradient and every running statistic bit-equal,
  `num_batches_tracked` moved once, and the forward really run twice.
* The port's remat step against the JAX remat step on tests/test_remat.py's
  batch (its non-CSR buckets without the readout regroup, so the port
  runs its segment path and segment readout), from the same weights, in
  float64 and in float32 (tolerances and readings in the test's
  docstring).
* Planted faults must break the bit-equality: a recompute that draws
  fresh dropout masks, and one that moves the running statistics a
  second time.

One torch thread; ~25 s on one worker (the JAX steps' compiles, float32
and float64, most of it).
"""
import contextlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from infomax3d_tpu.data.loader import GraphDataLoader as JaxLoader
from infomax3d_tpu.graphs.batch import BucketSpec as JaxBucket
from infomax3d_tpu.losses import LOSS_REGISTRY
from infomax3d_tpu.models import PNA as JaxPNA
from infomax3d_tpu.models.net3d import Net3D as JaxNet3D
from infomax3d_tpu.train.trainer import SelfSupervisedTrainer
from infomax3d_tpu_torch.data.loader import GraphDataLoader, to_device
from infomax3d_tpu_torch.graphs.batch import BucketSpec
from infomax3d_tpu_torch.interop import params_from_jax
from infomax3d_tpu_torch.models import base
from infomax3d_tpu_torch.train import remat
from infomax3d_tpu_torch.train.pretrain import PretrainStep
from infomax3d_tpu_torch.train.precision import cast_batch
from infomax3d_tpu_torch.train.supervised import SupervisedStep, masks_source

import torch_dp_cases as cases
from test_parallel import DS, NET3D_SMALL, PNA_SMALL
from test_torch_port_conformers import _jax_float64, _to64

GIN_DROPOUT = dict(cases.GIN, dropout=0.3)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _count_forwards(model):
    calls = [0]

    def hook(*_):
        calls[0] += 1
    model.register_forward_hook(hook)
    return calls


def contrastive(use_remat):
    """One float32 step of PNA + the flat Net3D under NT-Xent on the CSR
    batch of the parallel cases; its record and forward counts."""
    var = cases.variables({"model": ("PNA", cases.PNA),
                           "model3d": ("Net3D", cases.NET3D)})
    step = PretrainStep(cases.PNA, cases.NET3D, var, "cpu", None,
                        {"tau": 0.1}, {"lr": 1e-3}, "NTXent", "Net3D", "PNA")
    step.remat = use_remat
    calls = _count_forwards(step.model)
    view = cases.loader("contrastive_collate", 1, 0)
    g2, g3 = step.prepare(to_device(view["graph2d"], "cpu"),
                          to_device(view["graph3d"], "cpu"))
    loss = step.loss_and_grads(g2, g3)
    return cases._record(loss, step.named_parameters(),
                         {"model": step.model, "model3d": step.model3d}), \
        calls[0], step


def gin(use_remat):
    """One float32 step of the GIN with dropout 0.3, its masks from a
    seeded generator."""
    var = cases.variables({"model": ("OGBGNN", GIN_DROPOUT)})["model"]
    step = SupervisedStep("OGBGNN", GIN_DROPOUT, var, "cpu", None,
                          "BCEWithLogitsLoss", {"lr": 1e-3})
    step.remat = use_remat
    calls = _count_forwards(step.model)
    g = step.prepare(to_device(cases.loader("graph_collate", 1, 0)["graph"],
                               "cpu"))
    loss = step.loss_and_grads(g, noise=masks_source(
        torch.Generator().manual_seed(3)))
    return cases._record(loss, (("model." + n, p) for n, p in
                                step.model.named_parameters()),
                         {"model": step.model}), calls[0], step


def _tracked(step):
    return {int(m.num_batches_tracked) for m in step.model.modules()
            if isinstance(m, base.MaskedBatchNorm)}


def _differs(a, b):
    return [k for k in a if not np.array_equal(np.asarray(a[k]),
                                               np.asarray(b[k]))]


@pytest.mark.parametrize("case", [contrastive, gin])
def test_remat_step_is_bit_equal(case):
    """Loss, gradients and running statistics with remat equal the step
    without it bit for bit; the forward ran twice (the recompute) and the
    running statistics moved once."""
    ref, calls_ref, _ = case(False)
    got, calls, step = case(True)
    assert _differs(got, ref) == []
    assert (calls_ref, calls) == (1, 2)
    assert _tracked(step) == {1}


@pytest.mark.parametrize("fault", ["fresh_masks", "stats_twice"])
def test_planted_remat_fault_fails(fault, monkeypatch):
    """A recompute that draws fresh masks (no replay), or one that moves
    the running statistics again, is caught by the bit-equality."""
    ref, _, _ = gin(False)
    if fault == "fresh_masks":
        monkeypatch.setattr(remat._Recording, "replay",
                            lambda self: self.source)
    else:
        monkeypatch.setattr(base, "recomputing", lambda: False)
    got, _, step = gin(True)
    bad = _differs(got, ref)
    if fault == "fresh_masks":
        assert any("running" not in k and k != "loss" for k in bad), bad
    else:
        assert any("running" in k for k in bad) and _tracked(step) == {2}


def test_remat_off_outside_a_step():
    """Without `using_remat` (eval, or a step with `remat` False) the
    forward runs once, and under no_grad remat does nothing."""
    calls = [0]

    def fn(x, noise=None):
        calls[0] += 1
        return x * 2
    x = torch.ones(3, requires_grad=True)
    remat.rematerialized(fn, x).sum().backward()
    with remat.using_remat(True), torch.no_grad():
        remat.rematerialized(fn, x)
    assert calls[0] == 2


def _jax_remat_batch():
    """tests/test_remat.py's batch: 8 molecules, non-CSR buckets without
    the readout regroup."""
    return next(iter(JaxLoader(DS(), 8, "contrastive_collate",
                               bucket=JaxBucket(8, 256, 1024), shuffle=False,
                               prefetch=0, collate_kwargs={
                                   "bucket3d": JaxBucket(8, 256, 8192)})))


MODELS = {"model": ("PNA", PNA_SMALL), "model3d": ("Net3D", NET3D_SMALL)}


def _jax_remat_step(float64):
    """The JAX remat step (`loss_fn` with ``remat: True`` under
    `jax.value_and_grad`) on tests/test_remat.py's batch and models from
    the cases' seeded weights, in float32 or float64 (`_jax_float64`):
    loss, gradients and running statistics in the port's names."""
    var = cases.variables(MODELS)
    tr = SelfSupervisedTrainer.__new__(SelfSupervisedTrainer)
    tr.models = {"model": JaxPNA(**PNA_SMALL),
                 "model3d": JaxNet3D(**NET3D_SMALL)}
    tr.loss_func = LOSS_REGISTRY["NTXent"](tau=0.1)
    tr.compute_dtype, tr.args, tr.mesh = None, {"remat": True}, None
    tr._loss_fn_extra = None
    keys = tuple(MODELS)
    params = {k: var[k]["params"] for k in keys}
    stats = {k: var[k]["batch_stats"] for k in keys}
    batch = _jax_remat_batch()
    ctx = _jax_float64() if float64 else contextlib.nullcontext()
    with ctx:
        cast = _to64 if float64 else (
            lambda t: jax.tree_util.tree_map(jnp.asarray, t))
        params, stats, batch = cast(params), cast(stats), cast(batch)

        def lf(p):
            loss, _, new_stats = tr.loss_fn(p, stats, batch, 0,
                                            jax.random.key(7), True)
            return loss, new_stats
        (loss, new_stats), grads = jax.value_and_grad(lf, has_aux=True)(
            params)
        ref = {"loss": float(loss)}
        for k in keys:
            sd = params_from_jax(
                jax.tree_util.tree_map(lambda v: np.asarray(v, np.float64),
                                       jax.device_get(grads[k])),
                jax.tree_util.tree_map(lambda v: np.asarray(v, np.float64),
                                       jax.device_get(new_stats[k])))
            ref.update({f"{k}.{n}": v.numpy() for n, v in sd.items()
                        if "num_batches" not in n})
    return ref


def _port_remat_step(float64):
    """The port's remat step on the same batch (the same non-CSR buckets,
    so the segment path and the segment readout) and weights, in float32
    or float64."""
    step = PretrainStep(PNA_SMALL, NET3D_SMALL, cases.variables(MODELS),
                        "cpu", None, {"tau": 0.1}, {"lr": 1e-3}, "NTXent",
                        "Net3D", "PNA")
    step.remat = True
    view = next(iter(GraphDataLoader(
        DS(), 8, "contrastive_collate", bucket=BucketSpec(8, 256, 1024),
        shuffle=False, prefetch=0,
        collate_kwargs={"bucket3d": BucketSpec(8, 256, 8192)})))
    g2, g3 = (to_device(view[k], "cpu") for k in ("graph2d", "graph3d"))
    assert g2.csr_row_ptr is None and g2.rd_node_idx is None
    if float64:
        step.model.double()
        step.model3d.double()
        g2, g3 = cast_batch(g2, torch.float64), cast_batch(g3, torch.float64)
    loss = step.loss_and_grads(g2, g3)
    return cases._record(loss, step.named_parameters(),
                         {"model": step.model, "model3d": step.model3d})


def _errors(got, ref):
    grad_keys = [k for k in ref if k != "loss" and "running" not in k]
    gmax = max(np.abs(ref[k]).max() for k in grad_keys)
    grads = {k: np.abs(got[k] - ref[k]).max()
             / max(np.abs(ref[k]).max(), 1e-2 * gmax) for k in grad_keys}
    stats = {k: np.abs(got[k] - ref[k]).max() / np.abs(ref[k]).max()
             for k in ref if "running" in k}
    return abs(got["loss"] - ref["loss"]) / abs(ref["loss"]), \
        max(grads.values()), max(stats.values())


def test_remat_step_matches_jax_remat_step():
    """The port's remat step against the JAX remat step on
    tests/test_remat.py's batch and models, from the same seeded weights.
    Both in float64 (the JAX package read in float64, `_jax_float64`):
    loss, every gradient leaf (over the larger of its own scale and 1e-2
    of the largest gradient) and the running statistics within 1e-5
    relative (readings 4.8e-9, 6.1e-7, 5.8e-8: a few float32 constants
    remain on either side).  In float32 the loss within 1e-5 relative
    (reading 7.5e-7); the gradients within 1e-3 (reading 2.0e-4: PNA's
    std at degree-1 nodes sits on the relu(s2 / deg - mean^2) + EPS knife
    edge, where float32 rounding in either summation order is multiplied
    by 1 / sqrt(EPS), as the JAX package's own
    tests/test_edge_partition_mode.py notes) and the running statistics
    within 1e-5 (reading 2.1e-6)."""
    loss, grad, stats = _errors(_port_remat_step(True), _jax_remat_step(True))
    assert max(loss, grad, stats) <= 1e-5, (loss, grad, stats)
    loss, grad, stats = _errors(_port_remat_step(False),
                                _jax_remat_step(False))
    assert loss <= 1e-5 and grad <= 1e-3 and stats <= 1e-5, (loss, grad,
                                                              stats)
