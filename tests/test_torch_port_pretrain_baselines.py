"""The distance-supervised and GraphCL pre-training baselines against the
JAX package, on the CPU, at small widths (PNA 16x2 with the configs'
options, nhead 2, feed-forward 32, Net3DAE hidden 8) on 8 synthetic
QM9-like molecules (seed 3, 10 to 26 atoms; one test adds a molecule of
48 atoms), weights from `init_jax_variables`.  The JAX models read the JAX
package's own batches (its collates, no CSR: the XLA segment path, the
arithmetic of the port's CSR twins); the port's read its CSR batches.

* `node_pos` and `pairwise_distance_collate` (with and without
  `graph_3d`): array-equal where the layouts agree; the pair view holds
  the same (sender, receiver) pairs with the same distances, in receiver
  order where JAX keeps molecule order.
* `flat_to_dense`, `dense_to_flat` and `dense_node_mask`: equal to the
  JAX functions, also on a batch whose molecule of 48 atoms spills past
  `max_nodes` = 40 into the next graph's slots.
* The forwards of `DistancePredictor` (transformer layer and distance net
  each on and off, `projection_dim` 0 and 4), `PNADistancePredictor`,
  `Net3DDistancePredictor` (with and without a pair view) and `Net3DAE`
  (decoder depth 0 and 2, Fourier encodings 0 and 4), in eval and
  training mode, float32, the pair predictions matched by (sender,
  receiver): within 1e-5 of max|JAX| over the real rows (readings 1.2e-6
  to 1.7e-6 on `DistancePredictor`).  The Net3D family's training
  forwards are held to the JAX package evaluated in float64
  (`_jax_float64`) within twice the JAX float32 forward's own distance to
  it, at least 1e-5, as `tests/test_torch_port_conformers.py` holds the
  flat Net3D: the BatchNorm statistics over the edge rows lose float32
  digits on both sides (the port's latent reads 5.1e-5 from the JAX
  float32 one in a training forward).
* `NTXentAE`: both parts within 1e-6 relative.
* One step of each trainer (`DistancePredictorTrainer`,
  `SelfSupervisedAETrainer`, `GraphCLTrainer`, through the port's
  trainer classes) against the JAX trainer's `loss_fn` under
  `value_and_grad` and `GroupedOptimizer`'s Adam update, float32, held to
  the same JAX step evaluated in float64: each kind of reading (the loss,
  the extra losses, each model's live gradient leaves, each model's
  running statistics) within twice the JAX float32 step's own worst
  distance to float64 over that kind, at least 1e-5.  Readings, port /
  JAX float32 against float64: the autoencoder's loss 2.3e-6 / 1.4e-6,
  PNA leaves 8.5e-5 / 1.1e-4, Net3DAE leaves 4.0e-4 / 1.2e-3, statistics
  3.6e-5 / 4.1e-5; the distance predictor's leaves 3.6e-5 / 1.3e-4;
  GraphCL's 4.7e-5 / 4.8e-5.  The leaves whose gradient is zero up to
  rounding (below 1e-6 of the model's largest: a bias or BatchNorm shift
  feeding a BatchNorm) stay within 1e-5 of the model's largest gradient.
  The updated weights: within 2 lr of the JAX step's everywhere (Adam's
  first step moves a weight by lr times its gradient's sign, which
  rounding may flip where the gradient is at rounding level), and within
  1e-6 of max(|w|, 1) where the float64 gradient exceeds 1e-2 of its
  leaf's max.
* The transfer into a PNA fine-tune (`tune_QM9_homo.yml`) from a
  `DistancePredictor` and from a `Net3DAE` run's checkpoint, the port's
  `.pt` and the JAX msgpack: the same count and the same tensors as the
  JAX CLI's transfer.
"""
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from infomax3d_tpu.data.loader import get_collate as jax_get_collate
from infomax3d_tpu.graphs.batch import BucketSpec as JaxBucket
from infomax3d_tpu.graphs.batch import batch_graphs as jax_batch_graphs
from infomax3d_tpu.losses import get_loss as jax_get_loss
from infomax3d_tpu.models import get_model_class as jax_model_class
from infomax3d_tpu.models import transformer as jax_transformer
from infomax3d_tpu.train import trainer as jax_trainer
from infomax3d_tpu.train.optim import GroupedOptimizer
from infomax3d_tpu.train.optim import label_params as jax_label_params
from infomax3d_tpu_torch.data.loader import get_collate, to_device
from infomax3d_tpu_torch.data.synthetic import SyntheticMolecules
from infomax3d_tpu_torch.graphs.batch import (BucketSpec, batch_graphs,
                                              bucket_for)
from infomax3d_tpu_torch.interop import (init_jax_variables, load_variables,
                                         params_from_jax)
from infomax3d_tpu_torch.losses import get_loss
from infomax3d_tpu_torch.models import transformer
from infomax3d_tpu_torch.models.registry import build_model
from infomax3d_tpu_torch.train import trainer as port_trainer
from test_torch_port_conformers import _jax_float64, _to64
from test_torch_port_trainer import _same_arrays

FWD_TOL = 1e-5
LR = 1e-3
STEP_FLOOR = 1e-5
# an updated weight is held where its float64 gradient exceeds this share
# of its leaf's max: below it the two float32 steps may disagree in sign
FIRM = 1e-2

PNA_ARGS = dict(hidden_dim=16, mid_batch_norm=True, last_batch_norm=True,
                batch_norm_momentum=0.1, dropout=0.0, propagation_depth=2,
                aggregators=["mean", "max", "min", "std"],
                scalers=["identity", "amplification", "attenuation"],
                readout_aggregators=["min", "max", "mean", "sum"],
                pretrans_layers=2, posttrans_layers=1, residual=True)
# configs_clean/pre-train_distance_predictor_baseline.yml at small width
DP = dict(target_dim=1, projection_dim=0, distance_net=True,
          projection_layers=1, transformer_layer=True, nhead=2,
          dim_feedforward=32, pna_args=PNA_ARGS)
PNA_2D = dict({k: v for k, v in PNA_ARGS.items()}, target_dim=24,
              readout_batchnorm=True, readout_hidden_dim=16,
              readout_layers=2, batch_norm_momentum=0.93,
              readout_aggregators=["min", "max", "mean"])
# configs/contrastive_training_Net3DAE.yml at small width
AE = dict(projection_dim=8, projection_layers=2, distance_net=True,
          hidden_dim=8, node_wise_encoder_layers=0,
          node_wise_output_layers=0, message_net_layers=2,
          update_net_layers=2, reduce_func="mean", fourier_encodings=4,
          encoder_depth=2, decoder_depth=0, dropout=0.0, batch_norm=True,
          batch_norm_momentum=0.93, readout_aggregators=["min", "max",
                                                         "mean"])


# ------------------------------------------------------------- batches

def _items(n=8, seed=3, big=False):
    ds = SyntheticMolecules(n, seed=seed, n_min=10, n_max=26)
    items = [{"graph2d": ds.graph2d(i), "graph3d": ds.graph3d(i)}
             for i in range(n)]
    if big:
        # a molecule above max_nodes = 40, not last in the batch
        b = SyntheticMolecules(1, seed=9, n_min=48, n_max=48)
        items.insert(2, {"graph2d": b.graph2d(0), "graph3d": b.graph3d(0)})
    return items


def _buckets(items):
    """The port's 2D and 3D CSR buckets (the 3D one on the 2D node count)
    and the JAX package's non-CSR buckets of the same sizes."""
    b2 = bucket_for([it["graph2d"] for it in items], len(items))
    b3 = bucket_for([it["graph3d"] for it in items], len(items))
    b3 = BucketSpec(b3.n_graphs, b2.n_nodes, b3.n_edges, b3.max_deg, True,
                    b3.nmax)
    return (b2, b3, JaxBucket(b2.n_graphs, b2.n_nodes, b2.n_edges),
            JaxBucket(b3.n_graphs, b3.n_nodes, b3.n_edges))


def _views(collate, items, **kw):
    """(the port's batches on the CPU, the JAX collate's views)."""
    b2, b3, jb2, jb3 = _buckets(items)
    k3 = dict(kw)
    if collate != "graphcl_collate":
        k3["bucket3d"] = b3
    view = get_collate(collate)(items, b2, **k3)
    if collate != "graphcl_collate":
        k3["bucket3d"] = jb3
    jview = jax_get_collate(collate)(items, jb2, **k3)
    port = {k: to_device(v, "cpu") for k, v in view.items()}
    return view, port, jview


def _pairs(senders, receivers, mask, values=None):
    """{(sender, receiver): value} over the real pairs."""
    s, r, m = (np.asarray(x) for x in (senders, receivers, mask))
    vals = np.zeros(len(s)) if values is None else np.asarray(values)
    return {(int(a), int(b)): v for a, b, v, keep in zip(s, r, vals, m)
            if keep}


def _same_pair_values(port_pairs, port_vals, jax_pairs, jax_vals):
    """The two pair sets are equal; the largest difference of the values
    matched by (sender, receiver), over max |JAX value|."""
    got = _pairs(port_pairs.senders, port_pairs.receivers,
                 port_pairs.edge_mask, port_vals)
    want = _pairs(jax_pairs.senders, jax_pairs.receivers,
                  jax_pairs.edge_mask, jax_vals)
    assert got.keys() == want.keys()
    keys = sorted(got)
    a = np.array([got[k] for k in keys], np.float64)
    b = np.array([want[k] for k in keys], np.float64)
    return float(np.abs(a - b).max() / np.abs(b).max())


def test_node_pos_matches_jax():
    items = _items(big=True)
    b2, _, jb2, _ = _buckets(items)
    graphs = [it["graph2d"] for it in items]
    got = batch_graphs(graphs, b2)["node_pos"]
    want = jax_batch_graphs(graphs, JaxBucket(
        b2.n_graphs, b2.n_nodes, b2.n_edges, max_deg=b2.max_deg, csr=True,
        nmax=b2.nmax))["node_pos"]
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    n = sum(g["node_feat"].shape[0] for g in graphs)
    assert got[n:].max() == 0 and got[:n].max() == 47


@pytest.mark.parametrize("graph_3d", [False, True])
def test_pairwise_distance_collate(graph_3d):
    items = _items()
    view, port, jview = _views("pairwise_distance_collate", items,
                               graph_3d=graph_3d)
    assert view.keys() == jview.keys() == {"graph", "pairs"}
    pairs, jpairs = port["pairs"], jview["pairs"]
    assert pairs.num_nodes == jpairs.num_nodes == view["graph"][
        "node_feat"].shape[0]
    assert _same_pair_values(pairs, pairs.edge_dist.numpy(), jpairs,
                             jpairs.edge_dist) == 0.0
    r = pairs.receivers.numpy()[pairs.edge_mask.numpy()]
    assert (np.diff(r) >= 0).all()
    if graph_3d:
        assert view["graph"] is view["pairs"]
    else:
        _same_arrays({k: view["graph"][k] for k in (
            "node_feat", "node_graph", "node_pos", "node_mask",
            "graph_mask", "n_nodes")}, jview["graph"])
    assert get_collate("egnn_padded_collate").__name__ == \
        "egnn_padded_collate"
    assert get_collate("san_collate").__name__ == "san_collate"
    assert get_collate("padded_distances_collate") is \
        get_collate("pairwise_distance_collate")


@pytest.mark.parametrize("big", [False, True], ids=["small", "spill"])
def test_dense_exchange_matches_jax(big):
    items = _items(big=big)
    _, port, jview = _views("pairwise_distance_collate", items)
    g, jg = port["graph"], jview["graph"]
    rng = np.random.default_rng(0)
    h = rng.normal(size=(g.num_nodes, 5)).astype(np.float32)
    dense = transformer.flat_to_dense(torch.from_numpy(h), g, 40)
    want = np.asarray(jax_transformer.flat_to_dense(jnp.asarray(h), jg, 40))
    np.testing.assert_array_equal(dense.numpy(), want)
    np.testing.assert_array_equal(
        transformer.dense_node_mask(g, 40).numpy(),
        np.asarray(jax_transformer.dense_node_mask(jg, 40)))
    d = rng.normal(size=want.shape).astype(np.float32)
    np.testing.assert_array_equal(
        transformer.dense_to_flat(torch.from_numpy(d), g).numpy(),
        np.asarray(jax_transformer.dense_to_flat(jnp.asarray(d), jg)))
    if big:
        # atoms 40-47 of graph 2 land on graph 3's slots 0-7, which graph
        # 3's own atoms take back; graph 2's slots are full
        assert transformer.dense_node_mask(g, 40).numpy()[2].all()


# ------------------------------------------------------------- forwards

def _forward(model_type, mp, args, jargs, train, seed=1):
    """The port's forward and the JAX model's on the same weights; in
    training mode also the JAX model evaluated in float64 (`_jax_float64`):
    (port, JAX float32, JAX float64 or None)."""
    params, stats = init_jax_variables(mp, seed, model_type)
    model = load_variables(build_model(model_type, mp),
                           {"params": params, "batch_stats": stats})
    model.train(train)
    with torch.no_grad():
        out = model(*args)
    jm = jax_model_class(model_type)(**mp)

    def apply(variables, batches):
        if train:
            return jm.apply(variables, *batches, deterministic=False,
                            mutable=["batch_stats"])[0]
        return jm.apply(variables, *batches, deterministic=True)
    variables = {"params": params, "batch_stats": stats}
    ref = apply(variables, jargs)
    ref64 = None
    if train:
        with _jax_float64():
            ref64 = jax.tree_util.tree_map(
                lambda x: np.asarray(x, np.float64),
                apply(_to64(variables), _to64(jargs)))
    return out, ref, ref64


def _rel(got, want, mask):
    got, want = np.asarray(got), np.asarray(want)
    return float(np.abs(got - want)[mask].max() / np.abs(want[mask]).max())


DP_CASES = {
    "config": {},
    "no transformer": dict(transformer_layer=False),
    "projection": dict(distance_net=False, projection_dim=4,
                       projection_layers=2),
    "norm only": dict(distance_net=False, projection_dim=0,
                      transformer_layer=False),
    "two-layer net": dict(projection_dim=4, projection_layers=2),
}


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("case", sorted(DP_CASES))
def test_distance_predictor_forward(case, train):
    mp = dict(DP, **DP_CASES[case])
    _, port, jv = _views("pairwise_distance_collate", _items(big=True))
    out, ref, _ = _forward("DistancePredictor", mp,
                           (port["graph"], port["pairs"]),
                           (jv["graph"], jv["pairs"]), train)
    assert out.shape == (port["pairs"].senders.shape[0], 1)
    assert _same_pair_values(port["pairs"], out[:, 0].numpy(), jv["pairs"],
                             np.asarray(ref)[:, 0]) <= FWD_TOL


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_pna_distance_predictor_forward(train):
    mp = dict({k: v for k, v in PNA_ARGS.items() if k != "dropout"},
              target_dim=1, projection_dim=4, projection_layers=2)
    _, port, jv = _views("pairwise_distance_collate", _items())
    out, ref, _ = _forward("PNADistancePredictor", mp,
                           (port["graph"], port["pairs"]),
                           (jv["graph"], jv["pairs"]), train)
    assert _same_pair_values(port["pairs"], out[:, 0].numpy(), jv["pairs"],
                             np.asarray(ref)[:, 0]) <= FWD_TOL


def _hold_net3d(g, jg, out, ref, ref64):
    """A Net3D-family forward, part by part (`out`, `ref`, `ref64`: tuples
    of the latent [G, D] or None and the distances [E] or [E, 1]): the
    latent over the real graphs, the distances matched by pair.  In eval
    mode within FWD_TOL of the JAX float32 forward.  In training mode
    against the JAX float64 one, within twice the JAX float32 forward's
    own distance to it, at least FWD_TOL (the method and the reason of
    tests/test_torch_port_conformers.py: the BatchNorm statistics over the
    edge rows lose float32 digits on both sides)."""
    mask = np.asarray(jg.graph_mask)
    for i, kind in enumerate(("latent", "distances")):
        if out[i] is None:
            continue
        got = out[i].numpy().reshape(out[i].shape[0], -1)
        want = np.asarray(ref[i]).reshape(got.shape)
        if kind == "latent":
            dist = lambda a, b, _: _rel(a, b, mask)  # noqa: E731
        else:
            dist = lambda a, b, batch: _same_pair_values(  # noqa: E731
                batch, a[:, 0], jg, b[:, 0])
        if ref64 is None:
            assert dist(got, want, g) <= FWD_TOL, kind
            continue
        want64 = ref64[i].reshape(got.shape)
        reading, witness = dist(got, want64, g), dist(want, want64, jg)
        assert reading <= max(2.0 * witness, FWD_TOL), (kind, reading,
                                                        witness)


NET3D_DP = dict(hidden_dim=8, readout_aggregators=["mean", "max"],
                batch_norm=True, propagation_depth=2, projection_dim=4,
                projection_layers=2, fourier_encodings=4, reduce_func="mean")


@pytest.mark.parametrize("with_pairs", [False, True],
                         ids=["own edges", "pairs"])
@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_net3d_distance_predictor_forward(with_pairs, train):
    _, port, jv = _views("pairwise_distance_collate", _items(),
                         graph_3d=True)
    g, jg = port["graph"], jv["graph"]
    args, jargs = ((g, port["pairs"]), (jg, jv["pairs"])) if with_pairs \
        else ((g,), (jg,))
    out, ref, ref64 = _forward("Net3DDistancePredictor", NET3D_DP, args,
                               jargs, train)
    if with_pairs:
        assert out.shape == (g.senders.shape[0], 1)
        out, ref = (None, out), (None, ref)
        ref64 = None if ref64 is None else (None, ref64)
    _hold_net3d(g, jg, out, ref, ref64)


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("decoder_depth,fourier", [(0, 4), (2, 0), (2, 4)])
def test_net3d_ae_forward(decoder_depth, fourier, train):
    mp = dict(AE, decoder_depth=decoder_depth, fourier_encodings=fourier,
              node_wise_encoder_layers=1 if decoder_depth else 0)
    _, port, jv = _views("contrastive_collate_ae", _items())
    g, jg = port["graph3d"], jv["graph3d"]
    out, ref, ref64 = _forward("Net3DAE", mp, (g,), (jg,), train)
    assert out[0].shape == (g.graph_mask.shape[0], 24)
    _hold_net3d(g, jg, out, ref, ref64)


@pytest.mark.parametrize("model_type,mp", [
    ("DistancePredictor", DP),
    ("DistancePredictor", dict(DP, **DP_CASES["projection"])),
    ("PNADistancePredictor", dict(
        {k: v for k, v in PNA_ARGS.items() if k != "dropout"},
        projection_dim=4)),
    ("Net3DAE", dict(AE, decoder_depth=1, node_wise_encoder_layers=1)),
    ("Net3DDistancePredictor", NET3D_DP)])
def test_flax_paths_cover_the_jax_tree(model_type, mp):
    """`flax_paths` names every parameter and running statistic of the new
    models by its path in the JAX model's tree (what the optimizer's group
    labels and the transfer from JAX checkpoints read), and the JAX model
    takes that tree."""
    from infomax3d_tpu_torch.interop import _flatten, flax_paths
    params, stats = init_jax_variables(mp, 3, model_type)
    model = load_variables(build_model(model_type, mp),
                           {"params": params, "batch_stats": stats})
    want = {"/".join(p) for p, _ in _flatten(params)} | {
        "/".join(p) for p, _ in _flatten(stats)}
    assert set(flax_paths(model, running_stats=True).values()) == want
    jm = jax_model_class(model_type)(**mp)
    _, port, jv = _views("pairwise_distance_collate", _items(),
                         graph_3d=model_type.startswith("Net3D"))
    got = jax.eval_shape(lambda: jm.init(
        jax.random.key(0), jv["graph"], jv["pairs"]))
    shapes = {"/".join(p): tuple(v.shape) for c in ("params", "batch_stats")
              for p, v in _flatten(jax.tree_util.tree_map(
                  lambda x: x, dict(got[c])))}
    mine = {"/".join(p): np.shape(v) for p, v in _flatten(params)}
    mine.update({"/".join(p): np.shape(v) for p, v in _flatten(stats)})
    assert shapes == mine


def test_net3d_vae_alias_builds_net3d_ae():
    assert type(build_model("Net3DVAE", AE)).__name__ == "Net3DAE"


def test_ntxent_ae_pair_matches_jax():
    rng = np.random.default_rng(4)
    z1, z2 = (rng.normal(size=(6, 5)).astype(np.float32) for _ in range(2))
    d, p = (rng.uniform(1, 3, 40).astype(np.float32) for _ in range(2))
    mask = rng.uniform(size=40) < 0.8
    for m in (mask, None):
        got = get_loss("NTXentAE", tau=0.1, reconstruction_reg=0.7)(
            *map(torch.from_numpy, (z1, z2)), distances=torch.from_numpy(d),
            distance_pred=torch.from_numpy(p),
            mask=None if m is None else torch.from_numpy(m))
        want = jax_get_loss("NTXentAE", tau=0.1, reconstruction_reg=0.7)(
            jnp.asarray(z1), jnp.asarray(z2), distances=jnp.asarray(d),
            distance_pred=jnp.asarray(p),
            mask=None if m is None else jnp.asarray(m))
        assert len(got) == 2
        for a, b in zip(got, want):
            assert abs(float(a) - float(b)) <= 1e-6 * abs(float(b))


# ---------------------------------------------------------- one step

STEP_CASES = {
    "distance_predictor": dict(
        collate="pairwise_distance_collate", loss="L1Loss",
        models={"model": ("DistancePredictor", DP)},
        names=("graph", "pairs")),
    "autoencoder": dict(
        collate="contrastive_collate_ae", loss="NTXentAE",
        loss_params=dict(tau=0.1, reconstruction_reg=1.0),
        models={"model": ("PNA", PNA_2D), "model3d": ("Net3DAE", AE)},
        names=("graph2d", "graph3d")),
    "graphcl_trainer": dict(
        collate="graphcl_collate", loss="NTXent", loss_params=dict(tau=0.1),
        collate_params=dict(drop_ratio=0.2),
        models={"model": ("PNA", dict(PNA_2D, target_dim=16))},
        names=("view1", "view2")),
}


def _variables(models):
    return {k: dict(zip(("params", "batch_stats"), init_jax_variables(
        mp, 7 + i, t))) for i, (k, (t, mp)) in enumerate(models.items())}


def _jax_step(name, case, jview, variables):
    """The JAX trainer's loss_fn under value_and_grad and one
    GroupedOptimizer Adam step: (loss, extra losses, gradients, running
    statistics, updated parameters), named as the port's state_dicts."""
    cls = {"distance_predictor": jax_trainer.DistancePredictorTrainer,
           "autoencoder": jax_trainer.SelfSupervisedAETrainer,
           "graphcl_trainer": jax_trainer.GraphCLTrainer}[name]
    tr = cls.__new__(cls)
    tr.models = {k: jax_model_class(t)(**mp)
                 for k, (t, mp) in case["models"].items()}
    tr.loss_name, tr.compute_dtype, tr.args, tr.mesh = \
        case["loss"], None, {}, None
    tr.loss_func = None if name == "distance_predictor" else \
        jax_get_loss(case["loss"], **case["loss_params"])
    tree = lambda t: jax.tree_util.tree_map(jnp.asarray, t)  # noqa: E731
    params = {k: tree(v["params"]) for k, v in variables.items()}
    stats = {k: tree(v["batch_stats"]) for k, v in variables.items()}

    def lf(p):
        loss, aux, new_stats = tr.loss_fn(p, stats, jview, 0,
                                          jax.random.key(0), True)
        return loss, (aux.extra_losses, new_stats)
    (loss, (extra, new_stats)), grads = jax.value_and_grad(
        lf, has_aux=True)(params)
    labels, active = jax_label_params(params)
    opt = GroupedOptimizer(labels, name="Adam", lr=LR)
    upd, _ = opt.update(grads, opt.init(params), params,
                        np.array([LR, LR, LR, 0.0], np.float32))
    new = jax.tree_util.tree_map(lambda a, b: a + b, params, upd)
    np_ = lambda t: jax.tree_util.tree_map(  # noqa: E731
        lambda v: np.asarray(v, np.float32), t)
    out = {"loss": float(loss),
           "extra": {k: float(v) for k, v in extra.items()}}
    for key in variables:
        sd = params_from_jax(np_(grads[key]), np_(new_stats.get(key, {})))
        out.update({f"{key}.{n}": v.numpy() for n, v in sd.items()
                    if "num_batches" not in n})
        out.update({f"{key}.{n}.new": v.numpy() for n, v in params_from_jax(
            np_(new[key]), {}).items()})
    return out


def _port_step(name, case, view, variables, tmp_path):
    """One step through the port's trainer class: (loss, extra losses,
    gradients, running statistics, updated parameters)."""
    cls = port_trainer.get_trainer_class(name)
    models = {k: build_model(t, mp) for k, (t, mp) in case["models"].items()}
    loss_func = None if name == "distance_predictor" else \
        get_loss(case["loss"], **case["loss_params"])
    tr = cls(models, {"optimizer": "Adam", "optimizer_params": {"lr": LR},
                      "bf16_compute": False}, metrics={},
             main_metric="loss", run_dir=str(tmp_path), loss_func=loss_func,
             loss_name=case["loss"], device="cpu", use_tensorboard=False,
             init_variables=variables)
    tr.init_state()
    tr._write_lrs()
    loss, outs = tr._train_step(tr._prepare(view))
    out = {"loss": float(loss), "extra": tr._extra_losses(outs)}
    for key, m in models.items():
        out.update({f"{key}.{n}": p.grad.numpy().copy()
                    for n, p in m.named_parameters()})
        out.update({f"{key}.{n}": b.numpy().copy()
                    for n, b in m.named_buffers() if "running" in n})
        out.update({f"{key}.{n}.new": p.detach().numpy().copy()
                    for n, p in m.named_parameters()})
    tr.logger.close()
    return out, tr


def _rel64(got, ref):
    return float(np.abs(np.asarray(got, np.float64) - ref).max()
                 / np.abs(ref).max())


@pytest.mark.parametrize("name", sorted(STEP_CASES))
def test_one_step_matches_jax_trainer(name, tmp_path):
    """One step of the port's trainer against the JAX trainer's, held to
    the JAX step in float64 within twice the JAX float32 step's own
    distance to it per kind of reading (module docstring)."""
    case = STEP_CASES[name]
    view, _, jview = _views(case["collate"], _items(),
                            **case.get("collate_params", {}))
    variables = _variables(case["models"])
    want = _jax_step(name, case, jview, variables)
    with _jax_float64():
        want64 = _jax_step(name, case, _to64(jview), jax.tree_util.tree_map(
            lambda x: np.asarray(x, np.float64), variables))
    got, _ = _port_step(name, case, view, variables, tmp_path)
    assert got.keys() == want.keys() == want64.keys()
    assert got["extra"].keys() == want["extra"].keys()

    def held(keys, value):
        """Each of `keys` (readings `value(d)[k]`) within twice the JAX
        float32 step's worst distance to float64 over them, at least
        STEP_FLOOR."""
        tol = max(2.0 * max(_rel64(value(want)[k], value(want64)[k])
                            for k in keys), STEP_FLOOR)
        for k in keys:
            assert _rel64(value(got)[k], value(want64)[k]) <= tol, (k, tol)
    held(["loss"], lambda d: d)
    if want["extra"]:
        held(sorted(want["extra"]), lambda d: d["extra"])
    for side in case["models"]:
        grads = [k for k in want if k.startswith(side + ".")
                 and not k.endswith(".new") and "running" not in k]
        gmax = max(np.abs(want64[k]).max() for k in grads)
        # a bias or BatchNorm shift feeding a BatchNorm with nothing
        # nonlinear between: its exact gradient is 0
        zero = {k for k in grads if np.abs(want64[k]).max() < 1e-6 * gmax}
        for k in zero:
            assert np.abs(got[k]).max() <= STEP_FLOOR * gmax, k
        held([k for k in grads if k not in zero], lambda d: d)
        held([k for k in want if k.startswith(side + ".")
              and "running" in k], lambda d: d)
        for k in grads:
            new, ref = got[k + ".new"], want[k + ".new"]
            assert np.abs(new - ref).max() <= 2 * LR * (1 + 1e-3), k
            firm = np.abs(want64[k]) > FIRM * np.abs(want64[k]).max()
            if k in zero or not firm.any():
                continue
            assert np.abs(new - ref)[firm].max() <= \
                1e-6 * max(np.abs(ref).max(), 1.0), k


# ---------------------------------------------------------- transfer

# configs_clean/tune_QM9_homo.yml's PNA at the small width of PNA_ARGS
TUNE = "configs_clean/tune_QM9_homo.yml"
TUNE_PNA = dict(PNA_ARGS, target_dim=1, readout_batchnorm=True,
                readout_hidden_dim=16, readout_layers=2)
SOURCES = {
    "DistancePredictor": {"model": ("DistancePredictor", DP)},
    "Net3DAE run": {"model": ("PNA", PNA_2D), "model3d": ("Net3DAE", AE)},
}


def _source_checkpoint(source, fmt, tmp_path):
    """A checkpoint of `source`'s models from seeded weights: the port's
    `.pt` payload or the JAX package's flax msgpack TrainState."""
    from flax import serialization
    from infomax3d_tpu_torch.train import checkpoint
    variables = _variables(SOURCES[source])
    path = tmp_path / f"{fmt}.pt"
    if fmt == "pt":
        models = {k: load_variables(build_model(t, mp), variables[k])
                  for k, (t, mp) in SOURCES[source].items()}
        checkpoint.save_checkpoint(str(path), checkpoint.state_dicts(models))
    else:
        path.write_bytes(serialization.msgpack_serialize({
            "params": {k: v["params"] for k, v in variables.items()},
            "batch_stats": {k: v["batch_stats"]
                            for k, v in variables.items()},
            "opt_state": {}, "step": 0, "extra": {}}))
    return str(path)


@pytest.mark.parametrize("fmt", ["pt", "msgpack"])
@pytest.mark.parametrize("source", sorted(SOURCES))
def test_transfer_into_pna_finetune_matches_jax(source, fmt, tmp_path,
                                                capsys):
    """`transfer_pretrained` under `tune_QM9_homo.yml`'s transfer_layers
    (`gnn`) and exclude_from_transfer (`batch_norm`) copies from a
    distance-predictor or autoencoder-run checkpoint the same tensors as
    the JAX CLI's, into a PNA with other weights."""
    from infomax3d_tpu.cli.train import transfer_pretrained as jax_transfer
    from infomax3d_tpu.train.state import TrainState
    from infomax3d_tpu_torch.cli.config import load_config
    from infomax3d_tpu_torch.cli.train import transfer_pretrained
    from infomax3d_tpu_torch.models import PNA
    tune = load_config(TUNE, {})
    args = {"pretrain_checkpoint": _source_checkpoint(source, fmt,
                                                      tmp_path),
            "transfer_layers": tune["transfer_layers"],
            "exclude_from_transfer": tune["exclude_from_transfer"]}
    params, stats = init_jax_variables(TUNE_PNA, seed=11)
    state = jax_transfer(TrainState(
        params={"model": params}, batch_stats={"model": stats},
        opt_state=None, step=0), args)
    jax_count = int(capsys.readouterr().out.split("transferred ")[1]
                    .split()[0])
    model = load_variables(PNA(**{k: v for k, v in TUNE_PNA.items()
                                  if k != "dropout"}),
                           {"params": params, "batch_stats": stats})
    count = transfer_pretrained(types.SimpleNamespace(
        models={"model": model}), args)
    # every node_gnn parameter but the BatchNorms': the encoders' 12
    # tables and 2 layers x (2 pretrans + 1 posttrans) Linears' 2 tensors
    assert count == jax_count == 12 + 2 * 3 * 2
    want = params_from_jax(jax.device_get(state.params["model"]),
                           jax.device_get(state.batch_stats["model"]))
    got = model.state_dict()
    before = params_from_jax(params, stats)
    moved = [k for k in want if not torch.equal(want[k], before[k])]
    assert moved and all(k.startswith("node_gnn.") for k in moved)
    for k, v in want.items():
        assert torch.equal(got[k], v), k


def test_chip_smoke_phase21_follows_the_configs():
    """Phase 21's launch expectations and batches read the configs: PNA
    depth 7 in all three, Net3DAE's encoder depth, the check batches of
    (a) and (b) at the configs' own, the distance head's first width."""
    import importlib.util
    from pathlib import Path
    from infomax3d_tpu_torch.cli.config import load_config
    root = Path(__file__).resolve().parents[1]
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  root / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    cfg = {k: load_config(str(root / p), {})
           for k, p in cs.BASE_CONFIGS.items()}
    pna = {"a": cfg["a"]["model_parameters"]["pna_args"],
           "b": cfg["b"]["model_parameters"],
           "c": cfg["c"]["model_parameters"]}
    assert {k: v["propagation_depth"] for k, v in pna.items()} == \
        dict.fromkeys("abc", cs.DEPTH)
    m3 = cfg["b"]["model3d_parameters"]
    assert m3["encoder_depth"] == cs.BASE_AE_DEPTH
    assert m3["decoder_depth"] == 0 and m3["projection_layers"] == 2
    assert cfg["a"]["model_parameters"]["projection_layers"] == 1
    for k in "ab":
        assert cs.BASE_CHECK_BATCH[k] == cfg[k]["batch_size"]
    assert cfg["c"]["batch_size"] == 500
    assert cs.BASE_TRANSFER == 12 + cs.DEPTH * (
        load_config(str(root / cs.TRAINER_TUNE), {})["model_parameters"][
            "pretrans_layers"] + 1) * 2
