"""The OT generator's parts on the CPU, each against the JAX package:
the noise sources and dropout, the backbones (the virtual-node GIN with
noise columns, `PNAGNNRandom`, the GeoMol MPNN with and without noise,
the edge-update PNA with BatchNorm and dropout) in eval and training mode,
the OT model's options (`use_two_gnns`, `use_transformer`,
`gnn_output_mlp`, `random_alpha`) and `ignore_neighbors`, the cost pass
in eval mode, and `GeomolGNNWrapperOGBFeat`.  The sizes, the weights and
the replay of the JAX draws are `tests/test_torch_port_ot_trainer.py`'s
(`_Draws`, `_port_noise`).

Tolerances: float32 on both sides, each reading relative to the max of
the reference (`_rel`): forwards, costs and running statistics 1e-5
(readings below 3e-7 for the costs, 2e-6 for the forwards and statistics);
the training-mode losses 1e-5 relative.
"""
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from infomax3d_tpu.data.loader import get_collate as jax_get_collate
from infomax3d_tpu.graphs.batch import BucketSpec as JaxBucket
from infomax3d_tpu.models import geomol_mpnn as jax_geomol
from infomax3d_tpu.models import optimal_transport as jax_ot
from infomax3d_tpu.models import pna_random as jax_pna_random
from infomax3d_tpu.models import random_variants as jax_rv
from infomax3d_tpu_torch.data.loader import get_collate, to_ot_batch
from infomax3d_tpu_torch.graphs.batch import bucket_for
from infomax3d_tpu_torch.interop import init_jax_variables, load_variables
from infomax3d_tpu_torch.models import noise as noise_mod
from infomax3d_tpu_torch.models.geomol_mpnn import GeomolGNNWrapperOGBFeat
from infomax3d_tpu_torch.models.noise import (GeneratorNoise, ReplayNoise,
                                              dropout)
from infomax3d_tpu_torch.models.optimal_transport import BACKBONES, BIG
from infomax3d_tpu_torch.train.ot import OTStep, ot_plans
from test_torch_port_ot import _items, _jax_tree, _rel, _t
from test_torch_port_ot_trainer import (B, BASELINE, GEOMOL, GIN, HP, RVD,
                                        C, H, T, _Draws, _jax_apply,
                                        _models, _port_noise, _stats_errors,
                                        _torch_draws)


@pytest.fixture(scope="module")
def data():
    """One OT batch by both collates: (port `OTBatch`, JAX `GraphBatch`);
    the bucket has one padding graph."""
    items = _items(confs=T)
    b = bucket_for([it["graph2d"] for it in items], B + 1)
    view = get_collate("ot_collate")(items, b, n_true_confs=T)["graph"]
    jb = jax_get_collate("ot_collate")(items, JaxBucket(
        b.n_graphs, b.n_nodes, b.n_edges, max_deg=b.max_deg, csr=True,
        nmax=b.nmax), n_true_confs=T)["graph"]
    return to_ot_batch(view, b, "cpu"), jb


# --- the noise sources -------------------------------------------------------

def test_replay_noise_refuses_other_draws_and_masks():
    """A replayed Bernoulli mask of the wrong kind or shape is refused, as
    normal and uniform draws are; with `fresh` the masks come from it and
    the given draws serve the random stream alone."""
    noise = ReplayNoise([("bernoulli", torch.ones(2, 3, dtype=torch.bool)),
                         ("normal", torch.zeros(4))])
    with pytest.raises(RuntimeError, match="asked for bernoulli"):
        ReplayNoise([("normal", torch.zeros(2, 3))]).bernoulli(0.5, (2, 3))
    with pytest.raises(RuntimeError, match="asked for bernoulli"):
        noise.bernoulli(0.5, (3, 2))
    assert noise.bernoulli(0.5, (2, 3)).all()
    with pytest.raises(RuntimeError, match="asked for uniform"):
        noise.uniform((4,))
    gen = GeneratorNoise(torch.Generator().manual_seed(3))
    both = ReplayNoise([("normal", torch.ones(4))], fresh=gen)
    mask = both.bernoulli(0.25, (1000,))
    assert mask.dtype == torch.bool and 150 < int(mask.sum()) < 350
    assert torch.equal(both.normal((4,)), torch.ones(4))
    assert [k for k, _ in gen.draws] == ["bernoulli"]
    with pytest.raises(RuntimeError, match="no draw left"):
        both.normal((4,))


def test_dropout_is_flax_dropout():
    """`dropout` against flax's `nn.Dropout` on the same mask: the kept
    entries scaled by 1 / keep_prob, identity in eval mode and at rate 0,
    zeros at rate 1; it refuses to train without a source."""
    from flax import linen as nn
    x = np.random.default_rng(0).normal(size=(7, 5)).astype(np.float32)
    for rate in (0.5, 0.1):
        with _Draws(1) as d:
            want = nn.Dropout(rate).apply({}, jnp.asarray(x), False,
                                          rngs={"dropout": jax.random.key(0)})
        got = dropout(_t(x), rate, _port_noise(d.rec), True)
        assert len(d.rec["dropout"]) == 1
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert dropout(_t(x), 0.5, None, False) is not None
    np.testing.assert_array_equal(dropout(_t(x), 0.5, None, False), x)
    assert (dropout(_t(x), 1.0, None, True) == 0).all()
    with pytest.raises(ValueError, match="noise source"):
        dropout(_t(x), 0.5, None, True)
    assert noise_mod.noise_columns(None, 3, 2, 5.0, _t(x)).abs().sum() == 0


# --- the backbones -----------------------------------------------------------

_JAX_BACKBONES = {
    "PNAGNNRandom": jax_pna_random.PNAGNNRandom,
    "PNAGNNRandomEdgeUpdate": jax_rv.PNAGNNRandomEdgeUpdate,
    "GeomolGNNOGBFeat": jax_geomol.GeomolGNNOGBFeat,
    "GeomolGNNOGBFeatRandom": jax_geomol.GeomolGNNOGBFeatRandom,
    "GeomolGNNOGBFeatRandomNonShared": jax_geomol.GeomolGNNOGBFeatRandom,
    "GNN_node_VirtualnodeRandom": jax_ot.GINVirtualRandomBackbone,
}
BACKBONE_CASES = {
    "gin": GIN,
    "pna_random": {"gnn_model": "PNAGNNRandom", "hyperparams": HP,
                   "gnn_params": {"hidden_dim": 16, "propagation_depth": 2,
                                  "aggregators": ["mean", "max", "sum"],
                                  "scalers": ["identity",
                                              "amplification"]}},
    "geomol": GEOMOL,
    "geomol_random_non_shared": dict(
        GEOMOL, gnn_model="GeomolGNNOGBFeatRandomNonShared"),
    "edge_update_bn_dropout": dict(BASELINE, gnn_params=dict(
        BASELINE["gnn_params"], mid_batch_norm=True, last_batch_norm=True,
        dropout=0.5)),
}


def _gnn_params(mp):
    """The backbone's arguments as the OT model completes them."""
    hp, gp = mp["hyperparams"], dict(mp["gnn_params"])
    gp.setdefault("random_vec_dim", hp["random_vec_dim"])
    gp.setdefault("random_vec_std", hp["random_vec_std"])
    if mp["gnn_model"].startswith("GeomolGNNOGBFeatRandom"):
        gp.setdefault("non_shared", mp["gnn_model"].endswith("NonShared"))
    return gp


def _backbones(mp, seed=0):
    """(JAX module, port module, the backbone's numpy variables)."""
    import dataclasses
    gp = _gnn_params(mp)
    cls = _JAX_BACKBONES[mp["gnn_model"]]
    fields = {f.name for f in dataclasses.fields(cls)}
    jm = cls(**{k: v for k, v in gp.items() if k in fields})
    params, stats = init_jax_variables(mp, seed, "OptimalTransportModel")
    var = {"params": params["gnn"], "batch_stats": stats.get("gnn", {})}
    tm = load_variables(BACKBONES[mp["gnn_model"]].from_config(gp), var)
    return jm, tm, var


def _nodes(out):
    return out[0] if isinstance(out, tuple) else out


@pytest.mark.parametrize("mode", ["eval", "train"])
@pytest.mark.parametrize("case", sorted(BACKBONE_CASES))
def test_backbone_forward_matches_jax(data, case, mode):
    """Each backbone from the same weights and draws, in eval mode
    (running statistics, no dropout) and in training mode (batch
    statistics, replayed dropout masks): the node embeddings within 1e-5
    of their max, and after a training forward each running statistic
    within 1e-5."""
    batch, jb = data
    jm, tm, var = _backbones(BACKBONE_CASES[case], seed=2)
    train = mode == "train"
    want, stats, rec = _jax_apply(jm, var, jb, train=train, seed=3)
    tm.train(train)
    with torch.no_grad():
        got = _nodes(tm(batch.graph, _port_noise(rec)))
    if case != "geomol":
        assert rec["random"], "the backbone drew no noise"
    assert bool(rec["dropout"]) == (train and "dropout" in case
                                    or train and case == "gin")
    assert _rel(got, _nodes(want)) <= 1e-5
    if train and stats:
        errs = _stats_errors(tm, stats)
        assert max(errs.values()) <= 1e-5, errs


@pytest.mark.parametrize("variant", ["residual", "jk_sum"])
def test_gin_node_stack_options_match_jax(data, variant):
    """`GNNNodeRandom` with a virtual node and dropout 0.5 in training
    mode, with the residual connections (of the nodes and of the virtual
    node) or with "sum" jumping knowledge: output and running statistics
    within 1e-5."""
    batch, jb = data
    var = _backbones(GIN, seed=4)[2]
    node = {k: v["node_gnn"] for k, v in var.items()}
    kw = {"residual": True} if variant == "residual" else {"jk": "sum"}
    gp = GIN["gnn_params"]
    jm = jax_rv.GNNNodeRandom(gp["num_layers"], gp["hidden_dim"], RVD,
                              dropout=0.5, virtual_node=True, **kw)
    from infomax3d_tpu_torch.models.random_variants import GNNNodeRandom
    tm = load_variables(GNNNodeRandom(gp["num_layers"], gp["hidden_dim"],
                                      RVD, dropout=0.5, virtual_node=True,
                                      **kw), node)
    rng = np.random.default_rng(5)
    rx = (5 * rng.normal(size=(jb.num_nodes, RVD))).astype(np.float32)
    re = (5 * rng.normal(size=(jb.num_edges, RVD))).astype(np.float32)
    want, stats, rec = _jax_apply(jm, node, jb, jnp.asarray(rx),
                                  jnp.asarray(re), train=True, seed=6)
    assert len(rec["dropout"]) == 2 * gp["num_layers"] - 1
    with torch.no_grad():
        got = tm(batch.graph, _t(rx), _t(re), _port_noise(rec))
    assert _rel(got, want) <= 1e-5
    assert max(_stats_errors(tm, stats).values()) <= 1e-5


# --- the OT model ------------------------------------------------------------

def _check_layout(jm, var, jb):
    """The seeded trees have the flax `init` tree's paths and shapes."""
    from flax import traverse_util
    tmpl = jax.eval_shape(lambda: jm.init(
        {"params": jax.random.key(0), "random": jax.random.key(1)}, jb))
    for col in ("params", "batch_stats"):
        flat_t = traverse_util.flatten_dict(tmpl.get(col, {}))
        flat_v = traverse_util.flatten_dict(var[col])
        assert {k: tuple(v.shape) for k, v in flat_t.items()} == \
            {k: v.shape for k, v in flat_v.items()}, col


@pytest.mark.parametrize("ignore", [False, True], ids=["full", "local"])
def test_cost_with_ignore_neighbors_matches_jax(data, ignore):
    """The masked cost of (a) with `ignore_neighbors` off and on, from the
    same weights and draws, within 1e-5 of its max (readings below 3e-7),
    the same entries at `BIG`; the local cost differs from the full one
    (the dihedral and three-hop terms are gone)."""
    batch, jb = data
    jm, tm, var = _models(BASELINE)
    want, _, rec = _jax_apply(jm, var, jb, ignore_neighbors=ignore,
                              return_cost_matrix=True)
    with torch.no_grad():
        got = tm(batch, _port_noise(rec), ignore_neighbors=ignore,
                 return_cost_matrix=True).numpy()
        other = tm(batch, _port_noise(rec), ignore_neighbors=not ignore,
                   return_cost_matrix=True).numpy()
    want = np.asarray(want)
    big = want >= BIG / 2
    np.testing.assert_array_equal(got >= BIG / 2, big)
    assert big[:, :, B].all() and not big[:, :, :B].any()
    assert _rel(got[~big], want[~big]) <= 1e-5
    assert _rel(other[~big], want[~big]) > 1e-2


OPTION_CASES = {
    "one_gnn": dict(GEOMOL, use_two_gnns=False),
    "no_transformer": dict(BASELINE, use_transformer=False),
    "gnn_output_mlp": GIN,
    "random_alpha": dict(BASELINE, hyperparams=dict(HP, random_alpha=True)),
}


@pytest.mark.parametrize("case", sorted(OPTION_CASES))
def test_ot_model_options_match_jax(data, case):
    """The OT model with one backbone for both embeddings, without the
    neighbourhood transformer, with a backbone wider than the model (the
    GIN of width 16 under hidden 8: `gnn_output_mlp`), and with
    `random_alpha`: the seeded trees have the flax layout; the eval-mode
    cost within 1e-5 of its max; the training-mode loss on the JAX cost's
    plans within 1e-5 relative, with its running statistics."""
    batch, jb = data
    mp = OPTION_CASES[case]
    jm, tm, var = _models(mp)
    _check_layout(jm, var, jb)
    cost, _, rec = _jax_apply(jm, var, jb, return_cost_matrix=True, seed=2)
    n_gnn = 1 if case == "one_gnn" else 2
    alpha = case == "random_alpha"
    assert [k for k, _ in rec["random"]].count("uniform") == 2
    assert len(rec["random"]) == 2 + alpha + (
        0 if mp["gnn_model"] == "GeomolGNNOGBFeat" else 2 * n_gnn * C)
    tm.eval()
    with torch.no_grad():
        got = tm(batch, _port_noise(rec), return_cost_matrix=True).numpy()
    cost = np.asarray(cost)
    real = cost < BIG / 2
    assert _rel(got[real], cost[real]) <= 1e-5
    plans = ot_plans(cost, np.asarray(jb.extras["pos_mask"]),
                     np.asarray(jb.graph_mask))
    loss, stats, rec = _jax_apply(jm, var, jb, train=True, seed=3,
                                  ot_plans=jnp.asarray(plans))
    tm.train()
    with torch.no_grad():
        got = tm(batch, _port_noise(rec), ot_plans=_t(plans))
    assert abs(float(got) - float(loss)) <= 1e-5 * abs(float(loss))
    if stats:
        assert max(_stats_errors(tm, stats).values()) <= 1e-5


def test_cost_pass_runs_in_eval_mode(data):
    """`OTStep.cost` with (b)'s GIN (BatchNorm in every layer, dropout
    0.5) is the JAX trainer's `_cost_fn` (``deterministic=True``: running
    statistics, no dropout): the same cost within 1e-5 of its max; no
    running statistic moves, no mask is drawn, and the model is back in
    training mode after.  A cost pass in training mode normalizes with the
    batch's statistics and asks for dropout masks."""
    from infomax3d_tpu.train.trainer import OptimalTransportTrainer as JT
    batch, jb = data
    jm, tm, var = _models(GIN)
    tr = JT.__new__(JT)
    tr.models, tr.args, tr._epoch = {"model": jm}, {}, 1
    tr.state = types.SimpleNamespace(
        params={"model": _jax_tree(var["params"])},
        batch_stats={"model": _jax_tree(var["batch_stats"])})
    with _Draws(7) as d:
        want = np.asarray(tr._cost_fn({"graph": jb}, jax.random.key(0)))
    assert not d.rec["dropout"]
    step = OTStep.from_modules(tm.train(), "cpu", None)
    before = {k: v.clone() for k, v in tm.state_dict().items()}
    got = step.cost(batch, _port_noise(d.rec)).numpy()
    real = want < BIG / 2
    assert _rel(got[real], want[real]) <= 1e-5
    assert tm.training
    for k, v in tm.state_dict().items():
        assert torch.equal(v, before[k]), k
    with pytest.raises(RuntimeError, match="asked for bernoulli"):
        with torch.no_grad():
            tm(batch, ReplayNoise(_torch_draws(d.rec["random"])),
               return_cost_matrix=True)


@pytest.mark.parametrize("mode", ["eval", "train"])
def test_geomol_wrapper_forward_matches_jax(data, mode):
    """`GeomolGNNWrapperOGBFeat` (hidden 8, depth 2, readout 2 layers with
    BatchNorm): the seeded trees have the flax layout; the output within
    1e-5 of its max, in training mode with its running statistics."""
    batch, jb = data
    mp = {"hidden_dim": H, "depth": 2, "n_layers": 2, "target_dim": 3}
    params, stats = init_jax_variables(mp, 3, "GeomolGNNWrapperOGBFeat")
    var = {"params": params, "batch_stats": stats}
    jm = jax_geomol.GeomolGNNWrapperOGBFeat(**mp)
    _check_layout(jm, var, jb)
    tm = load_variables(GeomolGNNWrapperOGBFeat(**mp), var)
    train = mode == "train"
    want, jstats, _ = _jax_apply(jm, var, jb, train=train)
    with torch.no_grad():
        got = tm.train(train)(batch.graph)
    assert got.shape == (B + 1, 3)
    assert _rel(got[:B], np.asarray(want)[:B]) <= 1e-5
    if train:
        assert max(_stats_errors(tm, jstats).values()) <= 1e-5

