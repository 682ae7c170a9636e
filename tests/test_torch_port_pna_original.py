"""PNAOriginal, its random variants and PNAOriginalSimple on the CPU
against the JAX package: the always-scaled aggregation, the moment
rejection, every option's eval forward (towers with `divide_input_first`
/ `_last`, the GRU, graph norm, `use_3d`, no edge features,
`edge_hidden_dim`, residual), the bf16 dtype flow, one supervised step
per family with dropout, and one NT-Xent pre-training step with
PNAOriginal beside the flat Net3D.  Small sizes: width 10 to 12, 2 or 3
layers, 8 molecules of 6 to 16 atoms (a CSR bucket with padding); every
input from numpy seeds and `init_jax_variables`.

The supervised steps use `test_torch_port_gin_options`' JAX step (the
JAX `Trainer.loss_fn` under `value_and_grad`, rngs ``dropout`` alone; the
flax masks recorded and replayed to the port through `MasksOnly`).

Tolerances, float32 on both sides (the worst reading on this data in
brackets):

* the always-scaled aggregates: 1e-5 of each block's max [2.4e-7]; under
  bf16 messages the identity blocks are bf16 and the scaled ones float32
  in both packages, within 1e-2 of each block's max [3.9e-3];
* eval forward: 1e-5 of the output's max [1.1e-6];
* the supervised steps: as `test_torch_port_gin_options.check_step` (the
  loss 1e-5, predictions 1e-5, each gradient leaf 1e-4 of its own max,
  running statistics 1e-5; leaves the loss does not reach held below
  1e-5 of the largest gradient) [loss 1.7e-7]; but the leaves, whose
  float32 values are ill-conditioned where a node's messages are
  near-constant in a column (the std's ``E[x^2] - mean^2``; dropout's
  zeros make such columns: JAX's own float32 step strays up to 1.8e-4
  from its float64 step), each against the JAX float64 step within twice
  the JAX float32 step's distance, at least 1e-4 [port 1.8e-4, JAX
  float32 1.8e-4];
* the NT-Xent step (the flat Net3D with atom features, where float32 is
  clean): the loss 1e-5 relative, each gradient leaf 1e-4 of its own max,
  running statistics 1e-5 [loss 9.6e-8, leaf 1.2e-5].
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from infomax3d_tpu.graphs.batch import BucketSpec as JaxBucket
from infomax3d_tpu.graphs.batch import batch_graphs as jax_batch_graphs
from infomax3d_tpu.graphs.batch import to_graph_batch as jax_graph_batch
from infomax3d_tpu.losses import LOSS_REGISTRY as JAX_LOSSES
from infomax3d_tpu.models.net3d import Net3D as JaxNet3D
from infomax3d_tpu.models.registry import get_model_class as jax_model_class
from infomax3d_tpu.ops.segment import pna_multi_aggregate_always_scaled
from infomax3d_tpu.train.precision import cast_floats
from infomax3d_tpu_torch.data.synthetic import SyntheticMolecules
from infomax3d_tpu_torch.graphs.batch import (batch_graphs, bucket_for,
                                              to_graph_batch)
from infomax3d_tpu_torch.interop import (init_jax_variables, load_variables,
                                         params_from_jax)
from infomax3d_tpu_torch.models.registry import build_model
from infomax3d_tpu_torch.ops.aggregate import \
    pna_aggregate_parts_always_scaled
from infomax3d_tpu_torch.train.precision import cast_batch, compute_params
from infomax3d_tpu_torch.train.pretrain import PretrainStep, conformer_batches
from test_torch_port_conformers import _jax_float64, _to64
from test_torch_port_gin_options import (check_step, jax_step,
                                         labelled_graphs, port_step,
                                         step_errors)
from test_torch_port_ot import _jax_tree, _rel

B, T = 8, 2
DATA = dict(seed=0, n_min=6, n_max=16)
AGG_TOL, AGG_BF16_TOL, FWD_TOL = 1e-5, 1e-2, 1e-5
LOSS = "L1Loss"

BASE = dict(hidden_dim=10, last_layer_dim=10, target_dim=T,
            readout_aggregators=["mean", "max", "min", "sum"],
            propagation_depth=2, mid_batch_norm=True, last_batch_norm=True,
            residual=True, edge_hidden_dim=6)
# pna_original.yml's options at a small size, and each further option
OPTIONS = {
    "towers": dict(towers=2, divide_input_first=False,
                   divide_input_last=True, graph_norm=True),
    "divided_towers": dict(towers=2, hidden_dim=12, last_layer_dim=8),
    "gru": dict(gru_enable=True),
    "use_3d": dict(use_3d=True),
    "no_edge_feat": dict(edge_feat=False, graph_norm=True),
    "one_scaler": dict(scalers=["amplification"], avg_d=1.7),
    "pretrans_2": dict(pretrans_layers=2, posttrans_layers=2),
}
SIMPLE = dict(hidden_dim=10, last_layer_dim=10, target_dim=T,
              readout_aggregators=["mean"], propagation_depth=2,
              mid_batch_norm=True, last_batch_norm=True, residual=True,
              readout_hidden_dim=8)
FAMILIES = {
    "PNAOriginal": ("PNAOriginal", dict(BASE, **OPTIONS["towers"])),
    "PNAOriginalRandom": ("PNAOriginalRandom", dict(BASE, gru_enable=True)),
    "PNAOriginalSimple": ("PNAOriginalSimple", SIMPLE),
    "PNAOriginalSimpleRandom": ("PNAOriginalSimpleRandom",
                                dict(SIMPLE, random_vec_dim=3)),
}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The port on one CPU thread while this file runs (at these sizes
    more threads cost CPU time and gain nothing; the test workers share
    the machine's cores)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def batch():
    """(port GraphBatch, JAX GraphBatch) of the same labelled molecules,
    with coordinates and `snorm`."""
    mols = labelled_graphs(B, T, **DATA)
    b = bucket_for(mols, B + 1)
    jarr = jax_batch_graphs(mols, JaxBucket(
        b.n_graphs, b.n_nodes, b.n_edges, max_deg=b.max_deg, csr=True,
        nmax=b.nmax), extras_keys=("targets",))
    g = to_graph_batch(batch_graphs(mols, b), b, "cpu")
    assert not bool(g.node_mask.all()) and not bool(g.edge_mask.all())
    assert g.coords is not None and g.snorm is not None
    return g, jax_graph_batch(jarr, extras_keys=("targets",))


def _variables(name, mp, seed=3):
    params, stats = init_jax_variables(mp, seed, name)
    return {"params": params, "batch_stats": stats}


def test_batch_snorm_and_coords_match_jax(batch):
    """`snorm` (1 / sqrt(n) per real node, 0 on padding) and `coords`
    equal the JAX batcher's."""
    g, jb = batch
    np.testing.assert_array_equal(g.snorm.numpy(), np.asarray(jb.snorm))
    np.testing.assert_array_equal(g.coords.numpy(), np.asarray(jb.coords))


AGG_CASES = {
    "pna": (["mean", "max", "min", "std"],
            ["identity", "amplification", "attenuation"]),
    "single_scaler": (["sum", "var"], ["attenuation"]),
    "identity_only": (["mean", "min"], ["identity"]),
}


@pytest.mark.parametrize("case", sorted(AGG_CASES))
def test_always_scaled_aggregate(batch, case):
    """The port's always-scaled aggregates (each scaler applied, even a
    single one) against the JAX `pna_multi_aggregate_always_scaled`
    (`ops/segment.py:344`), float32 through the multi-reduce twin and bf16
    through the stats twin: equal dtypes, close values."""
    g, _ = batch
    aggs, scalers = AGG_CASES[case]
    rng = np.random.default_rng(4)
    msg = rng.normal(size=(g.senders.shape[0], 5)).astype(np.float32)
    E = int(g.csr_row_ptr[-1])
    for dtype, jdt, tol in ((torch.float32, jnp.float32, AGG_TOL),
                            (torch.bfloat16, jnp.bfloat16, AGG_BF16_TOL)):
        m = torch.from_numpy(msg).to(dtype)
        got = pna_aggregate_parts_always_scaled(g, m, aggs, scalers, 1.7)
        want = pna_multi_aggregate_always_scaled(
            jnp.asarray(msg[:E]).astype(jdt), jnp.asarray(g.receivers[:E].numpy()),
            g.num_nodes, aggs, scalers, 1.7)
        blocks = np.split(np.asarray(want, np.float32), len(got), axis=-1)
        for k, (a, w) in enumerate(zip(got, blocks)):
            ident = scalers[k // len(aggs)] == "identity"
            assert a.dtype == (dtype if ident else torch.float32)
            assert _rel(a.float().numpy(), w) <= tol, (dtype, k)
        want_dtype = jnp.float32 if set(scalers) != {"identity"} else jdt
        assert want.dtype == want_dtype


def test_moment_aggregators_are_refused(batch):
    g, _ = batch
    msg = torch.zeros(g.senders.shape[0], 3)
    with pytest.raises(ValueError, match="moment"):
        pna_aggregate_parts_always_scaled(g, msg, ["mean", "moment3"],
                                          ["identity"])
    with pytest.raises(ValueError, match="moment"):
        pna_multi_aggregate_always_scaled(
            jnp.zeros((4, 3)), jnp.zeros(4, jnp.int32), 2,
            ["mean", "moment3"], ["identity"])


def _eval_error(name, mp, g, jb) -> float:
    var = _variables(name, mp)
    model = load_variables(build_model(name, mp), var).eval()
    with torch.no_grad():
        got = model(g).numpy()
    want = jax.jit(functools.partial(jax_model_class(name)(**mp).apply,
                                     deterministic=True))(
        {k: _jax_tree(v) for k, v in var.items()}, jb)
    return _rel(got, np.asarray(want))


@pytest.mark.parametrize("option", sorted(OPTIONS))
def test_pna_original_option_forward(batch, option):
    """The eval forward of PNAOriginal with each option against the JAX
    module from the same weights (the flax tree's shapes first)."""
    g, jb = batch
    mp = dict(BASE, **OPTIONS[option])
    params, stats = init_jax_variables(mp, 3, "PNAOriginal")
    shapes = jax.tree_util.tree_map(np.shape, jax.eval_shape(
        jax_model_class("PNAOriginal")(**mp).init, jax.random.key(0), jb))
    assert shapes["params"] == jax.tree_util.tree_map(np.shape, params)
    assert shapes.get("batch_stats", {}) == jax.tree_util.tree_map(
        np.shape, stats)
    assert _eval_error("PNAOriginal", mp, g, jb) <= FWD_TOL


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_family_forward(batch, family):
    """Each registered name's eval forward against the JAX module (the
    random variants without a noise source: zero noise columns)."""
    g, jb = batch
    name, mp = FAMILIES[family]
    assert _eval_error(name, mp, g, jb) <= FWD_TOL


# one step per family: PNAOriginal with every option on at once (towers
# reading all of h, then a slice; graph norm; the GRU; use_3d; dropout and
# input-feature dropout), PNAOriginalSimple with the config's dropout
STEP_CASES = {
    "PNAOriginal": ("PNAOriginal", dict(BASE, **OPTIONS["towers"],
                                        gru_enable=True, use_3d=True,
                                        dropout=0.3, in_feat_dropout=0.2)),
    "PNAOriginalSimple": ("PNAOriginalSimple", dict(SIMPLE, dropout=0.3)),
}


def _jax_float64_step(name, mp, var, jb, masks):
    """`jax_step` evaluated in float64 (`test_torch_port_conformers.
    _jax_float64`), the recorded masks replayed."""
    import test_torch_port_gin_options as go
    real = go._jax_tree
    go._jax_tree = lambda t: _to64(real(t))
    try:
        with _jax_float64():
            return jax_step(jax_model_class(name)(**mp), var, _to64(jb),
                            LOSS, masks=masks)
    finally:
        go._jax_tree = real


@pytest.mark.parametrize("case", sorted(STEP_CASES))
def test_supervised_step_matches_jax(batch, case):
    """One float32 supervised step (L1, dropout masks replayed from flax)
    against the JAX trainer's: loss, predictions, every gradient leaf and
    the running statistics; no parameter is left without a gradient.
    The float32 step's leaves are ill-conditioned where a node's messages
    are near-constant in a column (the std's ``E[x^2] - mean^2``), so each
    live leaf is held to the JAX step in float64, within twice the JAX
    float32 step's own worst leaf distance to it, at least 1e-4."""
    g, jb = batch
    name, mp = STEP_CASES[case]
    var = _variables(name, mp)
    want = jax_step(jax_model_class(name)(**mp), var, jb, LOSS, seed=1)
    got = port_step(name, mp, var, g, LOSS, want[3])
    assert len(want[3]) > 0
    errs = step_errors(want, got, g.graph_mask.numpy())
    w64 = _jax_float64_step(name, mp, var, jb, want[3])
    grads = {k: v for k, v in w64[2].items() if "running" not in k}
    gmax = max(np.abs(v).max() for v in grads.values())
    live = [k for k, v in grads.items() if np.abs(v).max() >= 1e-5 * gmax]
    tol = max(1e-4, 2 * max(_rel(want[2][k], grads[k]) for k in live))
    worst = max(_rel(got[2][k], grads[k]) for k in live)
    assert worst <= tol, (worst, tol)
    check_step(dict(errs, leaf=0.0))


def _jax_call_dtypes(tree, prefix=()) -> dict:
    """Each module's output dtype in a flax `capture_intermediates` tree,
    by its '/'-joined path."""
    out = {}
    for k, v in tree.items():
        if k == "__call__":
            out["/".join(prefix)] = str(v[0].dtype)
        elif isinstance(v, dict):
            out.update(_jax_call_dtypes(v, prefix + (k,)))
    return out


def test_bf16_dtype_flow_matches_jax(batch):
    """Under the bf16 recipe the JAX model promotes the scaled aggregates
    to float32, so the first tower's posttrans output, every layer after
    the first and the second layer's messages are float32 while the
    embeddings and the first layer's messages are bf16: the port's
    modules return the same dtypes (JAX `capture_intermediates`, the
    batch and parameters cast as the JAX trainer casts them)."""
    g, jb = batch
    mp = dict(BASE, **OPTIONS["towers"])
    var = _variables("PNAOriginal", mp)
    jm = jax_model_class("PNAOriginal")(**mp)
    _, inter = jax.jit(functools.partial(
        jm.apply, deterministic=True, capture_intermediates=True,
        mutable=["intermediates"]))(
        {"params": cast_floats(_jax_tree(var["params"]), jnp.bfloat16),
         "batch_stats": _jax_tree(var["batch_stats"])},
        cast_floats(jb, jnp.bfloat16))
    want = _jax_call_dtypes(inter["intermediates"])
    names = ("embedding_h", "embedding_e", "layer_0/tower_0/pretrans",
             "layer_0/tower_0/posttrans", "layer_0/mixing_network",
             "layer_1/tower_1/pretrans", "layer_1/tower_0/posttrans")
    model = load_variables(build_model("PNAOriginal", mp), var).eval()
    mods = dict(model.named_modules())
    seen = {}
    hooks = [mods[n.replace("/", ".")].register_forward_hook(
        lambda m, i, o, n=n: seen.setdefault(n, str(o.dtype)) and None)
        for n in names]
    with torch.no_grad():
        torch.func.functional_call(
            model, compute_params(model, torch.bfloat16),
            (cast_batch(g, torch.bfloat16),))
    for h in hooks:
        h.remove()
    assert {n: seen[n].replace("torch.", "") for n in names} == \
        {n: want[n] for n in names}
    assert want["layer_0/tower_0/pretrans"] == "bfloat16"
    assert want["layer_0/tower_0/posttrans"] == "float32"
    assert want["layer_1/tower_1/pretrans"] == "float32"


# --- one NT-Xent pre-training step: PNAOriginal beside the flat Net3D --------

NET3D = dict(target_dim=8, hidden_dim=8, node_wise_output_layers=0,
             message_net_layers=1, update_net_layers=1, reduce_func="mean",
             fourier_encodings=4, propagation_depth=1, batch_norm=True,
             readout_batchnorm=True, batch_norm_momentum=0.93,
             readout_hidden_dim=8, readout_layers=1,
             readout_aggregators=["min", "max", "mean"],
             use_node_features=True)
PRE = dict(BASE, **OPTIONS["towers"], target_dim=8)


def _pretrain_variables():
    p2, s2 = init_jax_variables(PRE, 1, "PNAOriginal")
    p3, s3 = init_jax_variables(NET3D, 2, "Net3D")
    return {"model": {"params": p2, "batch_stats": s2},
            "model3d": {"params": p3, "batch_stats": s3}}


def _jax_pretrain_step(variables):
    """The JAX contrastive step on the CPU, float32: PNAOriginal on the 2D
    batch and Net3D on the complete graphs, NT-Xent tau 0.1, batch
    statistics mutable."""
    mols = SyntheticMolecules(B, **DATA)
    g2s = [mols.graph2d(i) for i in range(B)]
    g3s = [mols.graph3d(i) for i in range(B)]
    b2, b3 = bucket_for(g2s, B), bucket_for(g3s, B)
    g2 = jax_graph_batch(jax_batch_graphs(g2s, JaxBucket(B, b2.n_nodes,
                                                         b2.n_edges,
                                                         nmax=b2.nmax)))
    g3 = jax_graph_batch(jax_batch_graphs(g3s, JaxBucket(B, b3.n_nodes,
                                                         b3.n_edges)))
    m2, m3 = jax_model_class("PNAOriginal")(**PRE), JaxNet3D(**NET3D)
    loss_obj = JAX_LOSSES["NTXent"](tau=0.1)
    params = {k: _jax_tree(v["params"]) for k, v in variables.items()}
    stats = {k: _jax_tree(v["batch_stats"]) for k, v in variables.items()}

    def lf(p):
        z1, s2 = m2.apply({"params": p["model"],
                           "batch_stats": stats["model"]}, g2,
                          deterministic=False, mutable=["batch_stats"])
        z2, s3 = m3.apply({"params": p["model3d"],
                           "batch_stats": stats["model3d"]}, g3,
                          deterministic=False, mutable=["batch_stats"])
        return loss_obj(z1, z2), (s2, s3)

    (loss, (s2, s3)), grads = jax.jit(jax.value_and_grad(
        lf, has_aux=True))(params)
    to_np = lambda t: jax.tree_util.tree_map(  # noqa: E731
        lambda v: np.asarray(v, np.float32), t)
    out = {}
    for k, st in (("model", s2), ("model3d", s3)):
        sd = params_from_jax(to_np(grads[k]), to_np(st["batch_stats"]))
        out.update({f"{k}.{n}": v.numpy() for n, v in sd.items()
                    if "num_batches" not in n})
    return float(loss), out


def test_ntxent_step_matches_jax():
    """One float32 NT-Xent step of PNAOriginal (towers, graph norm) beside
    the flat Net3D on the port's CSR batches (`PretrainStep` with
    `model_type` PNAOriginal, `conformer_batches` with one conformer)
    against the JAX step: the loss, every gradient leaf and running
    statistic; every parameter gets a gradient."""
    variables = _pretrain_variables()
    jl, want = _jax_pretrain_step(variables)
    port = PretrainStep(PRE, NET3D, variables, "cpu", None, {"tau": 0.1},
                        {"lr": 8e-5}, "NTXent", "Net3D", "PNAOriginal")
    g2, g3, _ = conformer_batches(B, 1, **DATA)
    loss = float(port.loss_and_grads(*port.prepare(g2, g3)))
    got = {n: p.grad.numpy() for n, p in port.named_parameters()}
    for pre, m in (("model", port.model), ("model3d", port.model3d)):
        got.update({f"{pre}.{n}": v.numpy() for n, v in m.named_buffers()
                    if "running" in n})
    assert set(got) == set(want)
    assert abs(loss - jl) <= 1e-5 * abs(jl)
    gmax = max(np.abs(v).max() for k, v in want.items() if "running" not in k)
    for k, v in want.items():
        if "running" in k:
            assert np.abs(got[k] - v).max() <= 1e-5 * max(np.abs(v).max(),
                                                          1.0), k
        elif np.abs(v).max() < 1e-5 * gmax:
            assert np.abs(got[k]).max() < 1e-5 * gmax, k
        else:
            assert _rel(got[k], v) <= 1e-4, (k, _rel(got[k], v))
