"""The last model names and options on the CPU against the JAX package:
`PNAGNN`, `PNARandom`, `PNARandomEdgeUpdate`, `PNAGNNRandomEdgeUpdate`,
`GeomolGNNWrapper`, `GeomolGNNWrapperOGBFeatRandom` and
`GeomolGNNWrapperOGBFeatRandomNonShared` (eval forward without noise, the
JAX init's tree shapes, and a forward drawing noise, the JAX draws
replayed through `ReplayNoise`); PNA's `pairwise_distances` (float32
forward, the bf16 dtype flow and values, one supervised step with
dropout); `PNARandom`'s supervised step as the trainers run it (masks,
no noise); the training forwards with dropout of the flat `Net3D`,
`Net3DDense` (with `use_node_features`), `Net3DAE` and
`DistancePredictor`, the flax masks replayed; and the CLI's
`node_dim` / `edge_dim` inference.  Small sizes: width 8 to 12, 2
layers, 8 molecules of 6 to 16 atoms (CSR buckets with padding, the JAX
batches built in the same CSR order, so edge masks line up).

Tolerances:

* eval forwards, float32: 1e-5 of the output's max; where the
  two float32 forwards sum in another order (the pairwise-distance
  column), the port within the JAX float32 forward's own distance from
  the JAX float64 forward plus 1e-5;
* the pairwise-distance model under bf16: every module bf16 in both
  packages, the output within 2e-2 of the JAX bf16 output's max (bf16
  rounds at 4e-3 per operation);
* supervised steps: `test_torch_port_gin_options.check_step`;
* training forwards with dropout: the output and each running statistic,
  relative to its max, within twice the JAX float32 forward's own
  distance from the JAX float64 forward, at least 1e-5 (XLA's float32
  BatchNorm sums over the edge rows lose digits).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from infomax3d_tpu.cli import train as jax_cli
from infomax3d_tpu.graphs.batch import BucketSpec as JaxBucket
from infomax3d_tpu.graphs.batch import batch_graphs as jax_batch_graphs
from infomax3d_tpu.graphs.batch import to_graph_batch as jax_graph_batch
from infomax3d_tpu.graphs.dense import dense_batch as jax_dense_batch
from infomax3d_tpu.graphs.dense import to_dense_batch as jax_dense
from infomax3d_tpu.models.registry import get_model_class as jax_model_class
from infomax3d_tpu.train.precision import cast_floats
from infomax3d_tpu_torch.cli import train as port_cli
from infomax3d_tpu_torch.data.synthetic import SyntheticMolecules
from infomax3d_tpu_torch.graphs.batch import (batch_graphs, bucket_for,
                                              to_graph_batch)
from infomax3d_tpu_torch.graphs.dense import dense_batch, to_dense_batch
from infomax3d_tpu_torch.interop import (init_jax_variables, load_variables,
                                         params_from_jax)
from infomax3d_tpu_torch.models.noise import MasksOnly, ReplayNoise
from infomax3d_tpu_torch.models.registry import build_model
from infomax3d_tpu_torch.train.precision import cast_batch, compute_params
from test_torch_port_conformers import _jax_float64, _to64
from test_torch_port_gin_options import (check_step, jax_step,
                                         labelled_graphs, port_step,
                                         step_errors)
from test_torch_port_ot import _jax_tree, _rel
from test_torch_port_ot_trainer import _Draws, _torch_draws

B, T = 8, 2
DATA = dict(seed=0, n_min=6, n_max=16)
FWD_TOL, BF16_TOL, FLOOR = 1e-5, 2e-2, 1e-5
LOSS = "L1Loss"
PNA = dict(hidden_dim=12, target_dim=T,
           aggregators=["mean", "max", "min", "std"],
           scalers=["identity", "amplification", "attenuation"],
           readout_aggregators=["mean", "max", "min"], propagation_depth=2,
           mid_batch_norm=True, last_batch_norm=True, readout_batchnorm=True,
           pretrans_layers=2, posttrans_layers=1, residual=True)
GNN_KEYS = ("hidden_dim", "aggregators", "scalers", "propagation_depth",
            "mid_batch_norm", "last_batch_norm", "pretrans_layers",
            "posttrans_layers", "residual")
GEOMOL = dict(hidden_dim=10, depth=2, n_layers=2, readout_layers=2,
              readout_batchnorm=True, target_dim=T, random_vec_dim=3)
NODE_DIM, EDGE_DIM = 7, 3
MODELS = {
    "PNAGNN": {k: PNA[k] for k in GNN_KEYS},
    "PNARandom": dict(PNA, random_vec_dim=4, random_vec_std=0.7),
    "PNARandomEdgeUpdate": dict(PNA, random_vec_dim=4, random_vec_std=0.7),
    "PNAGNNRandomEdgeUpdate": dict({k: PNA[k] for k in GNN_KEYS},
                                   random_vec_dim=4),
    "GeomolGNNWrapper": dict(GEOMOL, node_dim=NODE_DIM, edge_dim=EDGE_DIM),
    "GeomolGNNWrapperOGBFeatRandom": dict(GEOMOL, readout_hidden_dim=6),
    "GeomolGNNWrapperOGBFeatRandomNonShared": dict(GEOMOL),
    "PNA_pairwise": dict(PNA, pairwise_distances=True),
}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _csr_pair(mols, extras=("targets",)):
    """(port CSR GraphBatch, JAX CSR GraphBatch) of the same molecules."""
    b = bucket_for(mols, len(mols) + 1)
    jarr = jax_batch_graphs(mols, JaxBucket(
        b.n_graphs, b.n_nodes, b.n_edges, max_deg=b.max_deg, csr=True,
        nmax=b.nmax), extras_keys=extras)
    return (to_graph_batch(batch_graphs(mols, b), b, "cpu"),
            jax_graph_batch(jarr, extras_keys=extras))


@pytest.fixture(scope="module")
def batches():
    """The labelled 2D batch (codes), and the same molecules with float
    node / edge features (GeomolGNNWrapper's)."""
    mols = labelled_graphs(B, T, **DATA)
    rng = np.random.default_rng(5)
    floats = [dict(m, node_feat=rng.random(
        (m["node_feat"].shape[0], NODE_DIM)).astype(np.float32),
        edge_feat=rng.random((m["senders"].shape[0], EDGE_DIM)).astype(
            np.float32)) for m in mols]
    return {"codes": _csr_pair(mols), "floats": _csr_pair(floats)}


def _name(case):
    return case.split("_")[0]


def _setup(case, seed=3):
    name, mp = _name(case), MODELS[case]
    params, stats = init_jax_variables(mp, seed, name)
    var = {"params": params, "batch_stats": stats}
    return name, mp, var, load_variables(build_model(name, mp), var)


def _view(batches, case):
    return batches["floats" if case == "GeomolGNNWrapper" else "codes"]


def _real(out, g):
    """A node-level output's real rows, or the graph-level output."""
    out = np.asarray(out)
    if out.shape[0] == g.node_mask.shape[0]:
        return out[g.node_mask.numpy()]
    return out


@pytest.mark.parametrize("case", sorted(MODELS))
def test_model_forward_matches_jax(batches, case):
    """The eval forward without noise (zero noise columns) against the
    JAX module from the same weights, whose init has the port's tree
    shapes."""
    g, jb = _view(batches, case)
    name, mp, var, model = _setup(case)
    jm = jax_model_class(name)(**mp)
    shapes = jax.eval_shape(jm.init, jax.random.key(0), jb)
    assert jax.tree_util.tree_map(np.shape, shapes["params"]) == \
        jax.tree_util.tree_map(np.shape, var["params"])
    assert jax.tree_util.tree_map(np.shape, shapes.get("batch_stats", {})) \
        == jax.tree_util.tree_map(np.shape, var["batch_stats"])
    with torch.no_grad():
        got = model.eval()(g).numpy()
    want = jax.jit(functools.partial(jm.apply, deterministic=True))(
        {k: _jax_tree(v) for k, v in var.items()}, jb)
    err = _rel(_real(got, g), _real(want, g))
    if err > FWD_TOL:
        # the float32 sums round differently (JAX sums the message input's
        # parts one by one where the port's kernel adds them at once):
        # both held to the JAX forward in float64
        with _jax_float64():
            want64 = jm.apply(_to64({k: _jax_tree(v)
                                     for k, v in var.items()}), _to64(jb),
                              deterministic=True)
        want64 = _real(np.asarray(want64, np.float64), g)
        err = _rel(_real(got, g), want64) - max(
            _rel(_real(want, g), want64), FWD_TOL)
    assert err <= FWD_TOL


NOISY = ("PNARandom", "PNARandomEdgeUpdate", "GeomolGNNWrapper",
         "GeomolGNNWrapperOGBFeatRandomNonShared")


@pytest.mark.parametrize("case", NOISY)
def test_noise_drawing_forward_matches_jax(batches, case):
    """An eval forward that draws its noise columns (the JAX model with
    its 'random' rng) against the port given the same draws."""
    g, jb = _view(batches, case)
    name, mp, var, model = _setup(case)
    jm = jax_model_class(name)(**mp)
    v = {k: _jax_tree(t) for k, t in var.items()}
    with _Draws(4) as d:
        want = jax.jit(lambda: jm.apply(
            v, jb, deterministic=True,
            rngs={"random": jax.random.key(0)}))()
    assert len(d.rec["random"]) == 2 and not d.rec["dropout"]
    noise = ReplayNoise(_torch_draws(d.rec["random"]))
    with torch.no_grad():
        got = model.eval()(g, noise=noise).numpy()
    assert noise.used == 2
    assert _rel(got, np.asarray(want)) <= FWD_TOL
    with torch.no_grad():
        quiet = model(g).numpy()
    assert _rel(quiet, np.asarray(want)) > 1e-3


def test_pairwise_distances_bf16_matches_jax(batches):
    """Under the bf16 recipe (parameters and the batch's float fields,
    coordinates included, cast as the JAX trainer casts them) every
    module of the pairwise-distance PNA is bf16 in both packages: JAX
    fuses the message input's parts (all bf16), the port's edge-combine
    input is bf16; the outputs agree within bf16 rounding."""
    g, jb = batches["codes"]
    name, mp, var, model = _setup("PNA_pairwise")
    jm = jax_model_class(name)(**mp)
    want, inter = jax.jit(functools.partial(
        jm.apply, deterministic=True, capture_intermediates=True,
        mutable=["intermediates"]))(
        {"params": cast_floats(_jax_tree(var["params"]), jnp.bfloat16),
         "batch_stats": _jax_tree(var["batch_stats"])},
        cast_floats(jb, jnp.bfloat16))
    names = ("node_gnn/mp_0/pretrans/FCLayer_0/Dense_0",
             "node_gnn/mp_1/pretrans/FCLayer_1/Dense_0",
             "node_gnn/mp_1/posttrans", "output")
    jdt = {n: str(functools.reduce(lambda t, k: t[k], n.split("/"),
                                   inter["intermediates"])["__call__"][0]
                  .dtype) for n in names}
    mods = dict(model.named_modules())
    port_names = {names[0]: "node_gnn.mp_layers.0.pretrans.fully_connected."
                            "0.linear",
                  names[1]: "node_gnn.mp_layers.1.pretrans.fully_connected."
                            "1.linear",
                  names[2]: "node_gnn.mp_layers.1.posttrans",
                  names[3]: "output"}
    seen = {}

    def hook(n):
        return lambda m, i, o: seen.setdefault(n, str(o.dtype)) and None
    hooks = [mods[port_names[n]].register_forward_hook(hook(n))
             for n in names[2:]]
    model.eval()
    with torch.no_grad():
        got = torch.func.functional_call(
            model, compute_params(model, torch.bfloat16),
            (cast_batch(g, torch.bfloat16),))
    for h in hooks:
        h.remove()
    assert set(jdt.values()) == {"bfloat16"}
    assert {n: seen[n].replace("torch.", "") for n in names[2:]} == \
        {n: jdt[n] for n in names[2:]}
    assert got.dtype == torch.bfloat16
    assert _rel(got.float().numpy(), np.asarray(want, np.float32)) <= \
        BF16_TOL


STEPS = {"PNA_pairwise": dict(MODELS["PNA_pairwise"], dropout=0.3),
         "PNARandom": dict(MODELS["PNARandom"], dropout=0.2)}


@pytest.mark.parametrize("case", sorted(STEPS))
def test_supervised_step_matches_jax(batches, case):
    """One float32 supervised step (L1, the flax dropout masks replayed,
    no noise: the trainers' source of masks alone) against the JAX
    trainer's step: loss, predictions, gradients, running statistics."""
    g, jb = batches["codes"]
    name, mp = _name(case), STEPS[case]
    params, stats = init_jax_variables(mp, 3, name)
    var = {"params": params, "batch_stats": stats}
    want = jax_step(jax_model_class(name)(**mp), var, jb, LOSS, seed=1)
    assert want[3]
    got = port_step(name, mp, var, g, LOSS, want[3])
    check_step(step_errors(want, got, g.graph_mask.numpy()))


# --- the 3D models' dropout ---------------------------------------------------

NET3D = dict(target_dim=6, hidden_dim=8, node_wise_output_layers=1,
             message_net_layers=2, update_net_layers=1, reduce_func="mean",
             fourier_encodings=3, propagation_depth=2, batch_norm=True,
             readout_batchnorm=True, batch_norm_momentum=0.9,
             readout_hidden_dim=8, readout_layers=2, dropout=0.25,
             readout_aggregators=["min", "max", "mean"])
AE = dict(projection_dim=6, projection_layers=2, distance_net=True,
          hidden_dim=8, node_wise_encoder_layers=1, message_net_layers=2,
          update_net_layers=1, reduce_func="sum", fourier_encodings=2,
          encoder_depth=1, decoder_depth=1, dropout=0.25, batch_norm=True,
          batch_norm_momentum=0.9, readout_aggregators=["min", "mean"])
DP = dict(target_dim=1, projection_dim=4, distance_net=True,
          projection_layers=2, transformer_layer=True, nhead=2,
          dim_feedforward=16, max_nodes=20,
          pna_args={k: PNA[k] for k in GNN_KEYS} | {"dropout": 0.25})
DROPOUT = {
    "Net3D": ("Net3D", NET3D),
    "Net3D_node_features": ("Net3D", dict(NET3D, use_node_features=True)),
    "Net3DDense_node_features": ("Net3DDense",
                                 dict(NET3D, use_node_features=True)),
    "Net3DAE": ("Net3DAE", AE),
    "DistancePredictor": ("DistancePredictor", DP),
}


@pytest.fixture(scope="module")
def graphs3d():
    """The molecules' complete graphs: CSR (port, JAX in the same order),
    dense (port, JAX), and the 2D batch with its complete-graph pairs."""
    ds = SyntheticMolecules(B, **DATA)
    mols = [ds.graph3d(i) for i in range(B)]
    nmax = max(m["node_feat"].shape[0] for m in mols)
    pairs2d = [dict(ds.graph2d(i)) for i in range(B)]
    return {"csr": _csr_pair(mols, ()),
            "dense": (to_dense_batch(dense_batch(mols, B, nmax), "cpu"),
                      jax_dense(jax_dense_batch(mols, B, nmax,
                                                with_edges=False))),
            "graph": _csr_pair(pairs2d, ())}


def _inputs(graphs3d, case):
    kind = DROPOUT[case][0]
    if kind == "Net3DDense":
        return (graphs3d["dense"][0],), (graphs3d["dense"][1],)
    if kind == "DistancePredictor":
        (g, jg), (p, jp) = graphs3d["graph"], graphs3d["csr"]
        return (g, p), (jg, jp)
    return (graphs3d["csr"][0],), (graphs3d["csr"][1],)


def _jax_train_forward(jm, var, jargs, masks=None):
    """The JAX training forward (batch statistics mutable, the dropout
    masks drawn or `masks` replayed): (output leaves, new statistics,
    masks)."""
    v = {k: _jax_tree(t) for k, t in var.items()}
    with _Draws(2, None if masks is None else {"dropout": masks}) as d:
        out, mut = jax.jit(lambda v, a: jm.apply(
            v, *a, deterministic=False, mutable=["batch_stats"],
            rngs={"dropout": jax.random.key(1)}))(v, jargs)
    leaves = [np.asarray(x, np.float64)
              for x in jax.tree_util.tree_leaves(out)]
    stats = jax.tree_util.tree_map(lambda x: np.asarray(x, np.float32),
                                   mut["batch_stats"])
    return leaves, params_from_jax({}, stats), d.rec["dropout"]


@pytest.mark.parametrize("case", sorted(DROPOUT))
def test_training_forward_with_dropout_matches_jax(graphs3d, case):
    """The training forward with dropout (masks replayed from flax) and
    its running statistics against the JAX model's, held to the JAX
    forward in float64 (module docstring)."""
    name, mp = DROPOUT[case]
    params, stats = init_jax_variables(mp, 4, name)
    var = {"params": params, "batch_stats": stats}
    args, jargs = _inputs(graphs3d, case)
    jm = jax_model_class(name)(**mp)
    want, wstats, masks = _jax_train_forward(jm, var, jargs)
    assert masks
    with _jax_float64():
        want64, wstats64, _ = _jax_train_forward(
            jm, jax.tree_util.tree_map(lambda x: np.asarray(x, np.float64),
                                       var), _to64(jargs), masks)
    model = load_variables(build_model(name, mp), var).train()
    replay = ReplayNoise(_torch_draws(masks))
    with torch.no_grad():
        out = model(*args, noise=MasksOnly(replay))
    assert replay.used == len(masks)
    got = [t.numpy() for t in (out if isinstance(out, tuple) else (out,))]
    sd = model.state_dict()
    pairs = list(zip(got, want, want64)) + [
        (sd[n].numpy(), wstats[n].numpy(), wstats64[n].numpy())
        for n in wstats64 if "num_batches" not in n]
    edge_mask = graphs3d["csr"][0].edge_mask.numpy()
    for g_, w, w64 in pairs:
        if g_.shape[0] == edge_mask.shape[0]:
            # per-pair outputs: the real pairs (padding pairs hold junk)
            g_, w, w64 = g_[edge_mask], w[edge_mask], w64[edge_mask]
        tol = max(2 * _rel(w, w64), FLOOR)
        assert _rel(g_, w64) <= tol, (_rel(g_, w64), tol)


def test_feature_dims_inferred_from_the_dataset():
    """`node_dim` / `edge_dim` of a model that has them, where the config
    leaves them out, come from the dataset's first 2D graph, as the JAX
    CLI's `_adapt_model_params` infers them; a config's own value
    stays."""
    rng = np.random.default_rng(0)
    dataset = [{"graph2d": {"node_feat": rng.random((5, NODE_DIM)),
                            "edge_feat": rng.random((8, EDGE_DIM))}}]
    mp = {k: v for k, v in GEOMOL.items()}
    want = jax_cli._adapt_model_params(jax_model_class("GeomolGNNWrapper"),
                                       mp, dataset)
    got = port_cli._with_input_width("GeomolGNNWrapper", mp, dataset,
                                     "graph2d")
    assert (got["node_dim"], got["edge_dim"]) == \
        (want["node_dim"], want["edge_dim"]) == (NODE_DIM, EDGE_DIM)
    got = port_cli._with_input_width("GeomolGNNWrapper",
                                     dict(mp, node_dim=11), dataset,
                                     "graph2d")
    assert got["node_dim"] == 11
    assert port_cli._with_input_width("PNA", PNA, dataset, "graph2d") == PNA
