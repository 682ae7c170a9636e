"""The OGB GIN's options on the CPU against the JAX package: `OGBGNN` with
GCN convolutions, a virtual node, dropout, residual connections, "sum"
jumping knowledge, attention and Set2Set pooling; `OGBGNNRandom` under the
supervised trainer's source of masks; `segment_softmax`.  Small sizes: 2
layers of width 16 over 8 molecule-like graphs of 6 to 20 atoms (a CSR
bucket with padding nodes and edges, two targets, some labels NaN); every
input from numpy seeds and `init_jax_variables`.

The JAX dropout masks are the ones flax draws, recorded through
`test_torch_port_ot_trainer._Draws` (a patch of `jax.random.bernoulli` while
the JAX pass runs) and replayed to the port's step in the same order
(`ReplayNoise` inside `MasksOnly`, the trainer's source).  The JAX step is
`Trainer.loss_fn` under `value_and_grad`, on a bare `Trainer` (its rngs:
``dropout`` alone, as the JAX trainer passes them).

Tolerances, float32 on both sides (the worst reading over the options
on this data in brackets; `OGBGNNRandom`'s where it is worse):

* eval forward: 1e-5 of the output's max [3.8e-7];
* the training step: the loss 1e-5 relative [2.7e-7], the real graphs'
  predictions 1e-5 of their max [7.7e-7], each gradient leaf 1e-4 of its
  own max [6.0e-6], the running statistics 1e-5 of the larger of their
  max and 1 [8.3e-7]; a leaf whose JAX gradient is below 1e-5 of the
  largest gradient (a bias feeding a BatchNorm, which removes it, or the
  attention gate's last bias, which the softmax removes: rounding noise
  on both sides) is held below 1e-5 of the largest gradient on both
  sides instead [3.9e-7];
* `segment_softmax`: 1e-6 [0].
"""
import numpy as np
import pytest
import torch
from flax import traverse_util

import jax
import jax.numpy as jnp

from infomax3d_tpu.graphs.batch import BucketSpec as JaxBucket
from infomax3d_tpu.graphs.batch import batch_graphs as jax_batch_graphs
from infomax3d_tpu.graphs.batch import to_graph_batch as jax_graph_batch
from infomax3d_tpu.models.gin import OGBGNN as JaxOGBGNN
from infomax3d_tpu.models.random_variants import \
    OGBGNNRandom as JaxOGBGNNRandom
from infomax3d_tpu.ops import segment as jax_segment
from infomax3d_tpu.train.torch_interop import convert_state_dict
from infomax3d_tpu.train.trainer import Trainer
from infomax3d_tpu_torch.data.synthetic import SyntheticMolecules
from infomax3d_tpu_torch.graphs.batch import (batch_graphs, bucket_for,
                                              to_graph_batch)
from infomax3d_tpu_torch.interop import (init_jax_variables, load_variables,
                                         params_from_jax)
from infomax3d_tpu_torch.models.noise import (MasksOnly, ReplayNoise,
                                              noise_columns)
from infomax3d_tpu_torch.models.registry import build_model
from infomax3d_tpu_torch.ops.segment import segment_softmax
from infomax3d_tpu_torch.train.supervised import SupervisedStep
from test_torch_port_ot import _jax_tree, _rel
from test_torch_port_ot_trainer import _Draws, _torch_draws

B, T = 8, 2
DATA = dict(seed=0, n_min=6, n_max=20)
BASE = dict(target_dim=T, num_layers=2, hidden_dim=16, dropout=0.0,
            virtual_node=False)
OPTIONS = {"gcn": {"gnn_type": "gcn"}, "virtual_node": {"virtual_node": True},
           "dropout": {"dropout": 0.5}, "residual": {"residual": True},
           "jk_sum": {"JK": "sum"}, "attention": {"graph_pooling": "attention"},
           "set2set": {"graph_pooling": "set2set"}}
# configs/gin_random.yml's model at a small size
RANDOM = dict(target_dim=T, num_layers=2, hidden_dim=16, dropout=0.5,
              random_vec_dim=4, random_vec_std=1.0, virtual_node=True)
LOSS = "BCEWithLogitsLoss"
FWD_TOL, LOSS_TOL, LEAF_TOL, ZERO_TOL, STATS_TOL = 1e-5, 1e-5, 1e-4, 1e-5, \
    1e-5


def labelled_graphs(num=B, num_targets=T, seed=0, n_min=6, n_max=20):
    """Molecule dicts with 0/1 labels, two of them NaN."""
    ds = SyntheticMolecules(num, seed=seed, n_min=n_min, n_max=n_max,
                            num_targets=num_targets)
    labels = (ds.targets > 0).astype(np.float32)
    labels[1, 0] = labels[4, -1] = np.nan
    return [dict(ds.graph2d(i), targets=labels[i]) for i in range(num)]


@pytest.fixture(scope="module")
def batch():
    """(port GraphBatch, JAX GraphBatch) of the same labelled molecules."""
    mols = labelled_graphs(**DATA)
    b = bucket_for(mols, B)
    jarr = jax_batch_graphs(mols, JaxBucket(
        b.n_graphs, b.n_nodes, b.n_edges, max_deg=b.max_deg, csr=True,
        nmax=b.nmax), extras_keys=("targets",))
    g = to_graph_batch(batch_graphs(mols, b), b, "cpu")
    assert not bool(g.node_mask.all()) and not bool(g.edge_mask.all())
    return g, jax_graph_batch(jarr, extras_keys=("targets",))


def jax_step(module, variables, jb, loss_name, seed=0, dtype=None,
             masks=None):
    """The JAX supervised step as its `Trainer` runs it (float32, or its
    bf16 recipe with `dtype`): returns (loss, predictions, gradients and
    updated running statistics named as the port's state_dict, the dropout
    masks flax drew, in order); `masks` replays a recorded set."""
    tr = Trainer.__new__(Trainer)
    tr.models = {"model": module}
    tr.loss_name, tr.compute_dtype, tr.args = loss_name, dtype, {}
    params = {"model": _jax_tree(variables["params"])}
    stats = {"model": _jax_tree(variables["batch_stats"])}

    def lf(p):
        loss, aux, new_stats = tr.loss_fn(p, stats, {"graph": jb}, 0,
                                          jax.random.key(0), True)
        return loss, (aux.predictions, new_stats)

    with _Draws(seed, replay=None if masks is None else {"dropout": masks}
                ) as d:
        (loss, (pred, new_stats)), grads = jax.jit(jax.value_and_grad(
            lf, has_aux=True))(params)
    to_np = lambda t: jax.tree_util.tree_map(  # noqa: E731
        lambda v: np.asarray(v, np.float32), t)
    sd = params_from_jax(to_np(grads["model"]), to_np(new_stats["model"]))
    assert not d.rec["random"]
    return (float(loss), np.asarray(pred),
            {n: v.numpy() for n, v in sd.items() if "num_batches" not in n},
            d.rec["dropout"])


def port_step(model_type, mp, variables, g, loss_name, masks, opt=None,
              dtype=None):
    """The port's `SupervisedStep` on `g` (float32, or the bf16 recipe with
    `dtype`) with `masks` replayed through the trainer's kind of source:
    (loss, predictions, gradients and running statistics, the step)."""
    step = SupervisedStep(model_type, mp, variables, "cpu", dtype, loss_name,
                          opt or {"lr": 1e-3})
    replay = ReplayNoise(_torch_draws(masks))
    loss, pred = step.loss_and_grads(step.prepare(g), noise=MasksOnly(replay),
                                     return_outputs=True)
    assert replay.used == len(replay.draws)
    out = {n: p.grad for n, p in step.model.named_parameters()}
    assert all(v is not None and bool(torch.isfinite(v).all())
               for v in out.values())
    out = {n: v.numpy().copy() for n, v in out.items()}
    out.update({n: v.numpy().copy() for n, v in step.model.named_buffers()
                if "running" in n})
    return float(loss), pred.numpy(), out, step


def step_errors(jax_out, port_out, real=None) -> dict:
    """The step check's readings (module docstring), worst of each kind;
    the predictions of the real graphs (`real`, a [G] mask) alone."""
    jl, jp, jg, _ = jax_out
    pl, pp, pg, _ = port_out
    if real is not None:
        jp, pp = jp[real], pp[real]
    assert set(jg) == set(pg)
    grads = {n: v for n, v in jg.items() if "running" not in n}
    gmax = max(np.abs(v).max() for v in grads.values())
    zero = {n for n, v in grads.items() if np.abs(v).max() < ZERO_TOL * gmax}
    leaf = max(_rel(pg[n], v) for n, v in grads.items() if n not in zero)
    zeros = max((max(np.abs(pg[n]).max(), np.abs(grads[n]).max()) / gmax
                 for n in zero), default=0.0)
    stats = max((np.abs(pg[n] - v).max() / max(np.abs(v).max(), 1.0)
                 for n, v in jg.items() if "running" in n), default=0.0)
    return {"loss": abs(pl - jl) / abs(jl), "pred": _rel(pp, jp),
            "leaf": float(leaf), "zero": float(zeros), "stats": float(stats)}


def check_step(errs: dict, leaf_tol: float = LEAF_TOL):
    tol = {"loss": LOSS_TOL, "pred": FWD_TOL, "leaf": leaf_tol,
           "zero": ZERO_TOL, "stats": STATS_TOL}
    assert all(errs[k] <= tol[k] for k in tol), errs


def _ogbgnn(option):
    mp = dict(BASE, **OPTIONS[option])
    params, stats = init_jax_variables(mp, 3, "OGBGNN")
    return mp, {"params": params, "batch_stats": stats}


def ogbgnn_eval_error(option, g, jb) -> float:
    """The eval forward of OGBGNN with `option` against the JAX module's,
    relative to the output's max."""
    mp, var = _ogbgnn(option)
    model = load_variables(build_model("OGBGNN", mp), var).eval()
    with torch.no_grad():
        got = model(g).numpy()
    want = JaxOGBGNN(**mp).apply({k: _jax_tree(v) for k, v in var.items()},
                                 jb, deterministic=True)
    return _rel(got, want)


@pytest.mark.parametrize("option", sorted(OPTIONS))
def test_ogbgnn_option_forward_and_state_dict(batch, option):
    """Eval forward against the JAX OGBGNN from the same weights, and the
    port's state_dict through the JAX package's `convert_state_dict` back
    onto the flax tree, leaf for leaf.  That converter has no Set2Set: it
    leaves the flax ``set2set/lstm_{i}`` leaves unmatched and the port's
    ``set2set.lstm_{i}.*`` unused (`params_from_jax` maps them directly)."""
    g, jb = batch
    assert ogbgnn_eval_error(option, g, jb) <= FWD_TOL
    mp, var = _ogbgnn(option)
    model = load_variables(build_model("OGBGNN", mp), var)
    flat_p = traverse_util.flatten_dict(var["params"])
    flat_s = traverse_util.flatten_dict(var["batch_stats"])
    sd = {n: v.numpy() for n, v in model.state_dict().items()}
    out_p, out_s, report = convert_state_dict(sd, flat_p, flat_s)
    s2s = option == "set2set"
    missing = {p[1:] for p in report["missing"]}
    assert missing == ({p for p in flat_p if p[0] == "set2set"} if s2s
                       else set())
    assert all(k.startswith("set2set.lstm_") for k in report["unused"])
    assert bool(report["unused"]) == s2s
    for path, v in {**out_p, **out_s}.items():
        want = flat_p.get(path, flat_s.get(path))
        np.testing.assert_array_equal(v, want)


@pytest.mark.parametrize("option", sorted(OPTIONS))
def test_ogbgnn_option_step(batch, option):
    """One supervised training step (BCEWithLogits over the real graphs'
    finite labels) against the JAX `Trainer.loss_fn`: the training-mode
    predictions, the loss, every gradient and the running statistics, the
    dropout masks replayed."""
    g, jb = batch
    mp, var = _ogbgnn(option)
    jout = jax_step(JaxOGBGNN(**mp), var, jb, LOSS)
    assert bool(jout[3]) == (option == "dropout")
    check_step(step_errors(jout, port_step("OGBGNN", mp, var, g, LOSS,
                                           jout[3])))


def test_ogbgnn_random_under_the_trainer(batch):
    """`OGBGNNRandom` (configs/gin_random.yml at width 16) under the
    supervised trainer: the JAX trainer passes its model the ``dropout``
    rng alone, so the noise columns are zeros and the masks are drawn; the
    port's `MasksOnly` source gives the same.  Eval forward and one step
    against the JAX model."""
    g, jb = batch
    params, stats = init_jax_variables(RANDOM, 5, "OGBGNNRandom")
    var = {"params": params, "batch_stats": stats}
    src = MasksOnly(ReplayNoise([]))
    cols = noise_columns(src, 5, 4, 1.0, torch.empty(0))
    assert cols.shape == (5, 4) and not bool(cols.any())
    model = load_variables(build_model("OGBGNNRandom", RANDOM), var).eval()
    with torch.no_grad():
        got = model(g).numpy()
    jm = JaxOGBGNNRandom(**RANDOM)
    want = jm.apply({k: _jax_tree(v) for k, v in var.items()}, jb,
                    deterministic=True)
    assert _rel(got, want) <= FWD_TOL
    jout = jax_step(jm, var, jb, LOSS)
    assert len(jout[3]) == 2 * RANDOM["num_layers"] - 1
    check_step(step_errors(jout, port_step("OGBGNNRandom", RANDOM, var, g,
                                           LOSS, jout[3])))


def test_segment_softmax_matches_jax():
    """Within each segment, with masked rows, padding rows (id G) and an
    empty segment (id 2), 1-d and 2-d logits."""
    rng = np.random.default_rng(0)
    ids = np.array([0, 0, 0, 1, 1, 3, 3, 3, 4, 4], np.int32)     # G = 4
    mask = np.array([1, 1, 0, 1, 1, 1, 0, 1, 0, 0], bool)
    for shape in ((10,), (10, 3)):
        x = (rng.normal(size=shape) * 3).astype(np.float32)
        got = segment_softmax(torch.from_numpy(x), torch.from_numpy(ids), 4,
                              torch.from_numpy(mask)).numpy()
        want = np.asarray(jax_segment.segment_softmax(
            jnp.asarray(x), jnp.asarray(ids), 4, mask=jnp.asarray(mask)))
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
        assert (got[~mask] == 0).all()
        for s in (0, 1, 3):
            sel = (ids == s) & mask
            np.testing.assert_allclose(got[sel].sum(0), 1.0, atol=1e-6)
