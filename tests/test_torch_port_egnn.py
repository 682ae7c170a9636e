"""EGNN on the CPU against the JAX package: the flat `EGNN` on the CSR
complete graphs (its eval forward from the same weights, its E(3)
invariance and its independence of padding, as `tests/test_models_more.py`
holds the JAX module, and one NT-Xent step of `configs/0.yml`'s pair, PNA
beside EGNN, through the port's contrastive trainer against the JAX
trainer's `loss_fn`), the dense `EGNNTorch` (forward and one supervised
step) and the padded collates (`egnn_padded_collate`, its aliases and
`molhiv_padded_collate`).  Small sizes: EGNN 12 x 2, PNA 10 x 2,
EGNNTorch 12 x 2 with attention, 8 synthetic molecules of 6 to 14 atoms
(QM9-like 10 to 26 for the step); every input from numpy seeds and
`init_jax_variables`.

Tolerances, float32 on both sides (the worst reading on this data in
brackets):

* the forwards: 1e-5 of the output's max over the real graphs (EGNN
  6.0e-7, EGNNTorch 2.6e-7);
* EGNN under a rotation and a translation of every molecule, and with
  more padding: 1e-4 of the output's max, as the JAX test [6.0e-7, 0];
* the NT-Xent step, held to the JAX step in float64 as
  `test_torch_port_pretrain_baselines.py` holds its steps (each kind of
  reading within twice the JAX float32 step's own worst distance to
  float64, at least 1e-5; zero leaves within 1e-5 of the model's largest
  gradient) [port / JAX float32: loss 1.3e-7 / 9.6e-7, PNA leaves 1.3e-4
  / 1.1e-4, EGNN leaves 1.5e-5 / 2.6e-5, statistics 3.2e-7 / 4.9e-7];
* the EGNNTorch step as `test_torch_port_gin_options.check_step` (loss
  1e-5, predictions 1e-5, each leaf 1e-4 of its max) [leaf 7.0e-7];
* the collates: equal arrays.

No parameter is left without a gradient after either step.  A planted
fault (the squared distance from the receiver's coordinates alone) fails
the forward check.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from infomax3d_tpu.data.loader import get_collate as jax_get_collate
from infomax3d_tpu.graphs.batch import BucketSpec as JaxBucket
from infomax3d_tpu.graphs.batch import batch_graphs as jax_batch_graphs
from infomax3d_tpu.graphs.batch import to_graph_batch as jax_graph_batch
from infomax3d_tpu.losses import get_loss as jax_get_loss
from infomax3d_tpu.models import get_model_class as jax_model_class
from infomax3d_tpu.train import trainer as jax_trainer
from infomax3d_tpu.train.torch_interop import convert_state_dict
from infomax3d_tpu_torch.data.loader import get_collate
from infomax3d_tpu_torch.data.synthetic import SyntheticMolecules
from infomax3d_tpu_torch.graphs.batch import (batch_graphs, bucket_for,
                                              to_graph_batch)
from infomax3d_tpu_torch.graphs.dense import to_dense_batch
from infomax3d_tpu_torch.interop import (init_jax_variables, load_variables,
                                         params_from_jax)
from infomax3d_tpu_torch.losses import get_loss
from infomax3d_tpu_torch.models import egnn
from infomax3d_tpu_torch.models.registry import build_model
from infomax3d_tpu_torch.train import trainer as port_trainer
from test_torch_port_conformers import _jax_float64, _to64
from test_torch_port_gin_options import (check_step, jax_step,
                                         labelled_graphs, port_step,
                                         step_errors)
from test_torch_port_ot import _jax_tree, _rel
from test_torch_port_pretrain_baselines import _items, _views

B = 8
FWD_TOL, MOVE_TOL, STEP_FLOOR = 1e-5, 1e-4, 1e-5
LR = 1e-3
# configs/0.yml's EGNN at a small size
EGNN = dict(node_dim=9, hidden_dim=12, target_dim=8, propagation_depth=2,
            batch_norm=True, readout_batchnorm=True, readout_hidden_dim=10,
            readout_layers=2, readout_aggregators=["min", "max", "mean"],
            dropout=0.0)
# configs/0.yml's PNA at a small size
PNA = dict(target_dim=8, hidden_dim=10, mid_batch_norm=True,
           last_batch_norm=True, readout_batchnorm=True,
           readout_hidden_dim=10, readout_layers=2, dropout=0.0,
           propagation_depth=2, aggregators=["mean", "max", "min", "std"],
           scalers=["identity", "amplification", "attenuation"],
           readout_aggregators=["min", "max", "mean"], pretrans_layers=2,
           posttrans_layers=1, residual=True)
DENSE = dict(in_node_nf=9, hidden_dim=12, target_dim=2, n_layers=2,
             attention=True)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _var(model_type, mp, seed=3):
    return dict(zip(("params", "batch_stats"),
                    init_jax_variables(mp, seed, model_type)))


def _complete_graphs(extra=0):
    """(port CSR batch, JAX CSR batch) of 8 molecules' complete graphs
    with coordinates; `extra` more padding graphs."""
    ds = SyntheticMolecules(B, seed=0, n_min=6, n_max=14)
    g3s = [ds.graph3d(i) for i in range(B)]
    b = bucket_for(g3s, B + 1 + extra)
    jb = jax_graph_batch(jax_batch_graphs(g3s, JaxBucket(
        b.n_graphs, b.n_nodes, b.n_edges, max_deg=b.max_deg, csr=True,
        nmax=b.nmax)))
    return to_graph_batch(batch_graphs(g3s, b), b, "cpu"), jb


@pytest.fixture(scope="module")
def complete():
    return _complete_graphs()


def _egnn(var=None):
    var = var or _var("EGNN", EGNN)
    return load_variables(build_model("EGNN", EGNN), var).eval()


def test_egnn_forward_matches_jax(complete):
    """The eval forward against the JAX EGNN from the same weights (the
    flax init's shapes); the state_dict through the JAX converter."""
    g, jb = complete
    var = _var("EGNN", EGNN)
    jm = jax_model_class("EGNN")(**EGNN)
    shapes = jax.eval_shape(jm.init, jax.random.key(0), jb)
    for k in ("params", "batch_stats"):
        assert jax.tree_util.tree_map(np.shape, shapes[k]) == \
            jax.tree_util.tree_map(np.shape, var[k])
    model = _egnn(var)
    _round_trip(model, var)
    with torch.no_grad():
        got = model(g).numpy()
    want = np.asarray(jm.apply({k: _jax_tree(v) for k, v in var.items()},
                               jb))
    real = g.graph_mask.numpy()
    assert _rel(got[real], want[real]) <= FWD_TOL


def _round_trip(model, var):
    """The port's state_dict through the JAX `convert_state_dict`: every
    flax leaf matched and equal, no port tensor left over."""
    from flax import traverse_util
    flat_p = traverse_util.flatten_dict(var["params"])
    flat_s = traverse_util.flatten_dict(var["batch_stats"])
    out_p, out_s, report = convert_state_dict(
        {n: v.numpy() for n, v in model.state_dict().items()}, flat_p, flat_s)
    assert report["missing"] == [] and report["unused"] == []
    for out, flat in ((out_p, flat_p), (out_s, flat_s)):
        for path, v in out.items():
            np.testing.assert_array_equal(v, flat[path])


def test_egnn_is_invariant_and_ignores_padding(complete):
    """A rotation and translation of every molecule, and more padding
    graphs, leave the eval forward as it is."""
    g, _ = complete
    model = _egnn()
    theta = 0.7
    rot = torch.tensor([[np.cos(theta), -np.sin(theta), 0],
                        [np.sin(theta), np.cos(theta), 0], [0, 0, 1.0]],
                       dtype=torch.float32)
    moved = dataclasses.replace(g, coords=g.coords @ rot.T
                                + torch.tensor([1.0, -2.0, 0.5]))
    padded, _ = _complete_graphs(extra=3)
    with torch.no_grad():
        a, b, c = model(g), model(moved), model(padded)
    real = g.graph_mask.numpy()
    assert _rel(b.numpy()[real], a.numpy()[real]) <= MOVE_TOL
    assert _rel(c.numpy()[:B], a.numpy()[:B]) <= MOVE_TOL


def test_receiver_only_distance_fails_the_forward(complete, monkeypatch):
    """The check's own test: the squared distance from the receiver's
    coordinates alone (the sender's dropped) moves the output past the
    tolerance."""
    g, jb = complete
    var = _var("EGNN", EGNN)
    want = np.asarray(jax_model_class("EGNN")(**EGNN).apply(
        {k: _jax_tree(v) for k, v in var.items()}, jb))

    def receiver_only(g):
        N = g.coords.shape[0]
        xd = g.coords[g.receivers.long().clamp(0, N - 1)]
        return (xd ** 2).sum(dim=-1, keepdim=True)
    monkeypatch.setattr(egnn, "squared_distances", receiver_only)
    with torch.no_grad():
        got = _egnn(var)(g).numpy()
    real = g.graph_mask.numpy()
    assert _rel(got[real], want[real]) > FWD_TOL


# ------------------------------------------------- the NT-Xent step

MODELS = {"model": ("PNA", PNA), "model3d": ("EGNN", EGNN)}


def _step_variables():
    return {k: _var(t, mp, 7 + i) for i, (k, (t, mp)) in
            enumerate(MODELS.items())}


def _jax_ntxent_step(jview, variables):
    """The JAX contrastive trainer's loss_fn under value_and_grad: (loss,
    gradients and running statistics named as the port's)."""
    tr = jax_trainer.SelfSupervisedTrainer.__new__(
        jax_trainer.SelfSupervisedTrainer)
    tr.models = {k: jax_model_class(t)(**mp) for k, (t, mp) in MODELS.items()}
    tr.compute_dtype, tr.args, tr.mesh = None, {}, None
    tr.loss_func = jax_get_loss("NTXent", tau=0.1)
    tree = lambda t: jax.tree_util.tree_map(jnp.asarray, t)  # noqa: E731
    params = {k: tree(v["params"]) for k, v in variables.items()}
    stats = {k: tree(v["batch_stats"]) for k, v in variables.items()}

    def lf(p):
        loss, _, new_stats = tr.loss_fn(p, stats, jview, 0,
                                        jax.random.key(0), True)
        return loss, new_stats
    (loss, new_stats), grads = jax.jit(jax.value_and_grad(
        lf, has_aux=True))(params)
    np_ = lambda t: jax.tree_util.tree_map(  # noqa: E731
        lambda v: np.asarray(v, np.float32), t)
    out = {"loss": float(loss)}
    for k in MODELS:
        sd = params_from_jax(np_(grads[k]), np_(new_stats[k]))
        out.update({f"{k}.{n}": v.numpy() for n, v in sd.items()
                    if "num_batches" not in n})
    return out


def _rel64(got, ref):
    return float(np.abs(np.asarray(got, np.float64) - ref).max()
                 / max(np.abs(ref).max(), 1e-30))


def test_ntxent_step_matches_jax(tmp_path):
    """One NT-Xent step (tau 0.1) of PNA beside EGNN through the port's
    contrastive trainer on the CSR batches of `contrastive_collate` (the
    flat 3D side) against the JAX trainer's, held to float64 JAX (module
    docstring); every parameter gets a gradient."""
    view, _, jview = _views("contrastive_collate", _items())
    variables = _step_variables()
    want = _jax_ntxent_step(jview, variables)
    with _jax_float64():
        want64 = _jax_ntxent_step(_to64(jview), jax.tree_util.tree_map(
            lambda x: np.asarray(x, np.float64), variables))
    models = {k: build_model(t, mp) for k, (t, mp) in MODELS.items()}
    tr = port_trainer.get_trainer_class("contrastive")(
        models, {"optimizer": "Adam", "optimizer_params": {"lr": LR},
                 "bf16_compute": False}, metrics={}, main_metric="loss",
        run_dir=str(tmp_path), loss_func=get_loss("NTXent", tau=0.1),
        loss_name="NTXent", device="cpu", use_tensorboard=False,
        init_variables=variables)
    tr.init_state()
    tr._write_lrs()
    loss, _ = tr._train_step(tr._prepare(view))
    tr.logger.close()
    got = {"loss": float(loss)}
    for k, m in models.items():
        assert all(p.grad is not None for p in m.parameters())
        got.update({f"{k}.{n}": p.grad.numpy() for n, p in
                    m.named_parameters()})
        got.update({f"{k}.{n}": b.numpy() for n, b in m.named_buffers()
                    if "running" in n})
    assert got.keys() == want.keys()

    def held(keys):
        tol = max(2.0 * max(_rel64(want[k], want64[k]) for k in keys),
                  STEP_FLOOR)
        for k in keys:
            assert _rel64(got[k], want64[k]) <= tol, (k, tol)
    held(["loss"])
    for side in MODELS:
        own = [k for k in want if k.startswith(side + ".")]
        grads = [k for k in own if "running" not in k]
        gmax = max(np.abs(want64[k]).max() for k in grads)
        zero = {k for k in grads if np.abs(want64[k]).max() < 1e-6 * gmax}
        for k in zero:
            assert np.abs(got[k]).max() <= STEP_FLOOR * gmax, k
        held([k for k in grads if k not in zero])
        held([k for k in own if "running" in k])


# ------------------------------------------------- the dense EGNN

def _dense_items(mols, with_3d=False):
    """Items of the labelled molecules; with `with_3d` the coordinates
    travel in a ``graph3d`` view instead of the 2D graph."""
    items = []
    for m in mols:
        g2 = {k: v for k, v in m.items() if k != "targets"}
        it = {"graph2d": g2, "targets": m["targets"]}
        if with_3d:
            it["graph3d"] = {"coords": g2.pop("coords")}
        items.append(it)
    return items


@pytest.mark.parametrize("name", ["egnn_padded_collate", "padded_collate",
                                  "egnn_padded_collate3d",
                                  "molhiv_padded_collate"])
@pytest.mark.parametrize("with_3d", [False, True], ids=["2d", "3d"])
def test_padded_collate_matches_jax(name, with_3d):
    """The port's padded collate against the JAX one: equal node codes,
    masks, coordinates (from the 3D view where the 2D graph has none),
    NaN-padded targets and graph mask; no bond codes."""
    mols = labelled_graphs(B, 1, seed=1, n_min=6, n_max=14)
    items = _dense_items(mols, with_3d)
    got = get_collate(name)(items, bucket_for(mols, B + 1),
                            max_nodes=16)["graph"]
    want = jax_get_collate(name)(items, JaxBucket(B + 1, 256, 512),
                                 max_nodes=16)["graph"]
    assert want.edge_codes is None and "edge_codes" not in got
    for k in ("node_feat", "node_mask", "coords"):
        np.testing.assert_array_equal(got[k], np.asarray(getattr(want, k)))
    for k in ("targets", "graph_mask"):
        np.testing.assert_array_equal(got[k], np.asarray(want.extras[k]))


@pytest.fixture(scope="module")
def dense():
    mols = labelled_graphs(B, 2, seed=1, n_min=6, n_max=14)
    items = _dense_items(mols)
    got = get_collate("egnn_padded_collate")(items, bucket_for(mols, B + 1),
                                             max_nodes=16)["graph"]
    want = jax_get_collate("egnn_padded_collate")(
        items, JaxBucket(B + 1, 256, 512), max_nodes=16)["graph"]
    return to_dense_batch(got, "cpu"), want


def test_dense_egnn_forward_and_step(dense):
    """EGNNTorch's eval forward and one supervised L1 step against the
    JAX module and `Trainer.loss_fn` from the same weights; the
    state_dict through the JAX converter."""
    g, jb = dense
    var = _var("EGNNTorch", DENSE)
    jm = jax_model_class("EGNNTorch")(**DENSE)
    shapes = jax.eval_shape(jm.init, jax.random.key(0), jb)
    assert jax.tree_util.tree_map(np.shape, shapes["params"]) == \
        jax.tree_util.tree_map(np.shape, var["params"])
    model = load_variables(build_model("EGNNTorch", DENSE), var).eval()
    _round_trip(model, var)
    with torch.no_grad():
        got = model(g).numpy()
    want = np.asarray(jm.apply({"params": _jax_tree(var["params"])}, jb))
    real = g.graph_mask.numpy()
    assert _rel(got[real], want[real]) <= FWD_TOL
    jout = jax_step(jm, var, jb, "L1Loss")
    pout = port_step("EGNNTorch", DENSE, var, g, "L1Loss", jout[3])
    check_step(step_errors(jout, pout, real))


def test_scalar_warmup_steps_of_0yml():
    """`configs/0.yml` gives `warmup_steps: 700`, one number where every
    other config gives a list: the JAX controller (as the reference's
    `sum`) fails on it; the port reads it as one warmup phase, the same
    schedule as `[700]`."""
    from infomax3d_tpu.train.schedulers import LRController as JaxLR
    from infomax3d_tpu_torch.cli.config import load_config
    from infomax3d_tpu_torch.train.schedulers import LRController
    args = load_config("configs/0.yml", {})
    params = args["lr_scheduler_params"]
    assert params["warmup_steps"] == 700
    with pytest.raises(TypeError):
        JaxLR([8e-5], args["lr_scheduler"], params)
    got = LRController([8e-5], args["lr_scheduler"], params)
    want = LRController([8e-5], args["lr_scheduler"],
                        dict(params, warmup_steps=[700]))
    for _ in range(3):
        got.after_optim_step()
        want.after_optim_step()
        assert got.lrs == want.lrs and 0 < got.lrs[0] < 8e-5
