"""The transformers on the CPU against the JAX package: `PNALayer` with
dropout on the CSR twins of its kernels, `MultiHeadSelfAttention` and
`TransformerEncoderBlock` with dropout, `PNATransformer` (16 x 2, 4 heads,
mid and last BatchNorm, 2 pretrans layers, on the CSR batch with
molecules above `max_nodes`, so the dense exchange spills) and
`TransformerPlain` (24 x 2, 4 heads, Laplacian PE, on the dense batch):
forward and one supervised step each against the JAX `Trainer.loss_fn`
and Adam (`GroupedOptimizer`); the bf16 recipe's move of each step's
gradient against the JAX bf16 recipe's; the dense collate against the JAX
`san_collate`; the state_dicts through the JAX `convert_state_dict`; and
both packages refusing `configs/pnatransformersimple_ogbg.yml`'s width 80
with 32 heads.  Every input from numpy seeds and `init_jax_variables`; the
JAX dropout masks are replayed to the port in flax's order (`_Draws`, as
`test_torch_port_gin_options.py` does).

Tolerances, float32 on both sides: the forwards (the real graphs'
rows; a padding graph's row is never read), the layer outputs and the
running statistics within 1e-5 of their max (readings: PNATransformer
7.7e-7, TransformerPlain 1.8e-7, the layer and the blocks below 1e-6);
the steps as `test_torch_port_gin_options.py` holds them (loss 1e-5
relative, each gradient leaf 1e-4, the zero-gradient leaves 1e-5 of the
largest gradient; readings: loss 5.8e-7 / 9.4e-7, leaf 2.8e-5 for
TransformerPlain), but PNATransformer's leaves within 3e-4 (reading
9.2e-5, in the first PNA layer's pretrans MLP, whose folded BatchNorm
takes float32 statistics over the edge rows, summed in another order on
each side); one Adam update from the port's gradients against
`GroupedOptimizer`'s from the same gradients within 1e-6 of each
parameter's max, at least 1 (readings 8.3e-8 / 3.0e-8).  The collate:
equal arrays.
"""
import numpy as np
import pytest
import torch
from flax import traverse_util

import jax
import jax.numpy as jnp

from infomax3d_tpu.data.loader import san_collate as jax_san_collate
from infomax3d_tpu.graphs.batch import BucketSpec as JaxBucket
from infomax3d_tpu.graphs.batch import batch_graphs as jax_batch_graphs
from infomax3d_tpu.graphs.batch import to_graph_batch as jax_graph_batch
from infomax3d_tpu.models import attention as jax_attention
from infomax3d_tpu.models import transformer as jax_transformer
from infomax3d_tpu.models.pna import PNALayer as JaxPNALayer
from infomax3d_tpu.train.optim import GroupedOptimizer, label_params
from infomax3d_tpu.train.torch_interop import convert_state_dict
from infomax3d_tpu_torch.cli.config import load_config
from infomax3d_tpu_torch.data.loader import get_collate
from infomax3d_tpu_torch.graphs.batch import (batch_graphs, bucket_for,
                                              to_graph_batch)
from infomax3d_tpu_torch.graphs.dense import to_dense_batch
from infomax3d_tpu_torch.interop import (_pna_layer_tree,
                                         _transformer_block_tree,
                                         init_jax_variables, load_variables,
                                         params_from_jax)
from infomax3d_tpu_torch.models.attention import (MultiHeadSelfAttention,
                                                  TransformerEncoderBlock)
from infomax3d_tpu_torch.models.noise import ReplayNoise
from infomax3d_tpu_torch.models.pna import PNALayer
from infomax3d_tpu_torch.models.registry import build_model
from test_torch_port_gin_options import (LEAF_TOL, check_step, jax_step,
                                         labelled_graphs, port_step,
                                         step_errors)
from test_torch_port_ot import _jax_tree, _rel
from test_torch_port_ot_trainer import _Draws, _torch_draws

B = 8
DATA = dict(seed=1, n_min=6, n_max=20)
PNA_FIELDS = dict(aggregators=["mean", "max", "min", "std"],
                  scalers=["identity", "amplification", "attenuation"],
                  mid_batch_norm=True, last_batch_norm=True,
                  pretrans_layers=2, posttrans_layers=1, residual=True)
# configs/pnatransformer_ogbg.yml's model at a small size, `max_nodes` cut
# below the largest molecule so the dense exchange spills, as molhiv's
# molecules above 40 atoms do at the config's 40
PNA_TRANSFORMER = dict(target_dim=1, hidden_dim=16, nhead=4,
                       dim_feedforward=16, dropout=0.1, propagation_depth=2,
                       readout_batchnorm=True, readout_hidden_dim=8,
                       readout_layers=2, max_nodes=14, **PNA_FIELDS)
# configs/transformer.yml's model at a small size
TRANSFORMER = dict(target_dim=1, hidden_dim=24, nhead=4, dim_feedforward=16,
                   dropout=0.1, propagation_depth=2, pos_enc_dim=8)
LOSS = "L1Loss"
TOL = 1e-5
PNA_LEAF_TOL = 3e-4
BF16_FACTOR = 2.0


@pytest.fixture(scope="module")
def graphs():
    """(port GraphBatch, JAX GraphBatch, molecules) of labelled graphs."""
    mols = labelled_graphs(B, 1, **DATA)
    b = bucket_for(mols, B)
    assert b.nmax > PNA_TRANSFORMER["max_nodes"]
    jarr = jax_batch_graphs(mols, JaxBucket(
        b.n_graphs, b.n_nodes, b.n_edges, max_deg=b.max_deg, csr=True,
        nmax=b.nmax), extras_keys=("targets",))
    return (to_graph_batch(batch_graphs(mols, b), b, "cpu"),
            jax_graph_batch(jarr, extras_keys=("targets",)), mols)


def _dense_items(mols):
    return [{"graph2d": {k: v for k, v in m.items() if k != "targets"},
             "targets": m["targets"]} for m in mols]


@pytest.fixture(scope="module")
def dense(graphs):
    """(port DenseBatch, JAX DenseGraphBatch) of the same molecules, one
    padding graph slot, 24 atom slots."""
    items = _dense_items(graphs[2])
    arrays = get_collate("padded_collate_positional_encoding")(
        items, bucket_for(graphs[2], B + 1), max_nodes=24)["graph"]
    want = jax_san_collate(items, JaxBucket(B + 1, 256, 512),
                           max_nodes=24)["graph"]
    return to_dense_batch(arrays, "cpu"), want


def _var(tree):
    params, stats = tree
    return {"params": params, "batch_stats": stats}


def _jax_var(var):
    return {k: _jax_tree(v) for k, v in var.items() if v}


def test_dense_collate_matches_jax(graphs):
    """`san_collate` / `padded_collate_positional_encoding` against the
    JAX `san_collate`'s arrays: codes, masks, coordinates, the Laplacian
    PE (NaN where a molecule has fewer frequencies than k, its mask true
    there, as the JAX collate sets it) and the NaN-padded targets; also
    with the sign flip drawn from an rng."""
    items = _dense_items(graphs[2])
    for kw in ({}, {"sign_flip": True}):
        rng = {"rng": np.random.default_rng(5)} if kw else {}
        got = get_collate("san_collate")(items, bucket_for(graphs[2], B + 2),
                                         max_nodes=24, **kw, **rng)["graph"]
        rng = {"rng": np.random.default_rng(5)} if kw else {}
        want = jax_san_collate(items, JaxBucket(B + 2, 256, 512),
                               max_nodes=24, **kw, **rng)["graph"]
        fields = ("node_feat", "node_mask", "edge_codes", "real_edge_mask",
                  "coords", "lap_pe", "lap_pe_mask")
        assert set(got) == set(fields) | {"targets", "graph_mask"}
        for f in fields:
            np.testing.assert_array_equal(got[f], np.asarray(getattr(want, f)))
        for f in ("targets", "graph_mask"):
            np.testing.assert_array_equal(got[f], np.asarray(want.extras[f]))
        assert np.isnan(got["lap_pe"]).any() and np.isnan(
            got["targets"][B:]).all()


def test_pna_layer_dropout_matches_jax(graphs):
    """`PNALayer` in training mode with dropout 0.2 (masks after the
    pretrans MLP's two Linears and the posttrans Linear, [E, D] and [N, D]
    over the padding rows too): its output and running statistics against
    the JAX layer's, the port's kernels through their CPU twins."""
    g, jb, _ = graphs
    D = 16
    mp = dict(PNA_FIELDS, hidden_dim=D)
    params, stats = _pna_layer_tree(np.random.default_rng(2), mp)
    rng = np.random.default_rng(3)
    h = rng.normal(size=(g.num_nodes, D)).astype(np.float32)
    e = rng.normal(size=(g.senders.shape[0], D)).astype(np.float32)
    kw = {k: mp[k] for k in ("aggregators", "scalers", "mid_batch_norm",
                              "last_batch_norm", "pretrans_layers",
                              "posttrans_layers", "residual")}
    jl = JaxPNALayer(in_dim=D, out_dim=D, in_dim_edges=D, dropout=0.2, **kw)
    with _Draws(0) as d:
        want, mut = jl.apply(_jax_var({"params": params, "batch_stats": stats}),
                             jb, jnp.asarray(h), jnp.asarray(e),
                             deterministic=False, mutable=["batch_stats"],
                             rngs={"dropout": jax.random.key(1)})
    masks = d.rec["dropout"]
    assert [m.shape for _, m in masks] == [e.shape, e.shape, h.shape]
    layer = PNALayer(D, D, D, dropout=0.2, **kw)
    layer.load_state_dict(params_from_jax(params, stats))
    replay = ReplayNoise(_torch_draws(masks))
    got = layer.train()(g, torch.from_numpy(h), torch.from_numpy(e), replay)
    assert replay.used == 3
    assert _rel(got.detach().numpy()[:int(g.node_mask.sum())],
                np.asarray(want)[:int(g.node_mask.sum())]) <= TOL
    new = params_from_jax({}, jax.tree_util.tree_map(
        np.asarray, mut["batch_stats"]))
    sd = layer.state_dict()
    for n, v in new.items():
        if "running" in n:
            assert _rel(sd[n], v) <= TOL, n


@pytest.mark.parametrize("block", ["attention", "encoder_block"])
def test_attention_dropout_matches_jax(block):
    """`MultiHeadSelfAttention` (a mask on the attention weights) and
    `TransformerEncoderBlock` (then after the attention, the activation and
    `linear2`) in training mode with dropout 0.2, against the JAX modules;
    one graph has no valid key (its rows give zeros), others a few."""
    rng = np.random.default_rng(4)
    x = rng.normal(size=(3, 7, 16)).astype(np.float32)
    mask = np.ones((3, 7), bool)
    mask[1, 4:] = False
    mask[2] = False
    tree = _transformer_block_tree(np.random.default_rng(6), 16, 12)
    if block == "attention":
        jm = jax_attention.MultiHeadSelfAttention(16, 4, 0.2)
        tm = MultiHeadSelfAttention(16, 4, 0.2)
        tree = tree["self_attn"]
    else:
        jm = jax_attention.TransformerEncoderBlock(16, 4, 12, 0.2)
        tm = TransformerEncoderBlock(16, 4, 12, "relu", 0.2)
    with _Draws(0) as d:
        want = jm.apply({"params": _jax_tree(tree)}, jnp.asarray(x),
                        jnp.asarray(mask), deterministic=False,
                        rngs={"dropout": jax.random.key(1)})
    masks = d.rec["dropout"]
    assert len(masks) == (1 if block == "attention" else 4)
    tm.load_state_dict(params_from_jax(tree, {}))
    replay = ReplayNoise(_torch_draws(masks))
    got = tm.train()(torch.from_numpy(x), torch.from_numpy(mask), replay)
    assert replay.used == len(masks)
    assert _rel(got.detach().numpy(), want) <= TOL


def _adam_error(step, variables, port_grads, lr):
    """One Adam update of the port's step from its gradients against the
    JAX `GroupedOptimizer`'s from the same gradients (mapped onto the flax
    tree by the JAX `convert_state_dict`), worst over the parameters."""
    params = _jax_tree(variables["params"])
    flat = traverse_util.flatten_dict(variables["params"])
    out, _, report = convert_state_dict(
        {n: v for n, v in port_grads.items() if "running" not in n}, flat, {})
    assert report["missing"] == [] and report["unused"] == []
    grads = traverse_util.unflatten_dict(
        {k: jnp.asarray(v) for k, v in out.items()})
    labels, _ = label_params(params)
    opt = GroupedOptimizer(labels, name="Adam", lr=lr)
    lrs = np.zeros(4, np.float32)
    lrs[:2] = lr
    upd, _ = opt.update(grads, opt.init(params), params, lrs)
    want = params_from_jax(jax.tree_util.tree_map(
        lambda p, u: np.asarray(p + u), params, upd), {})
    step.optimizer.step()
    got = dict(step.model.named_parameters())
    return max(float((got[n].detach() - w).abs().max())
               / max(float(w.abs().max()), 1.0) for n, w in want.items())


def _state_dict_round_trip(model_type, mp, var):
    """The port's state_dict through the JAX `convert_state_dict`: every
    flax leaf matched, equal, and no port tensor left over."""
    model = load_variables(build_model(model_type, mp), var)
    flat_p = traverse_util.flatten_dict(var["params"])
    flat_s = traverse_util.flatten_dict(var["batch_stats"])
    out_p, out_s, report = convert_state_dict(
        {n: v.numpy() for n, v in model.state_dict().items()}, flat_p, flat_s)
    assert report["missing"] == [] and report["unused"] == []
    for path, v in out_p.items():
        np.testing.assert_array_equal(v, flat_p[path])
    for path, v in out_s.items():
        np.testing.assert_array_equal(v, flat_s[path])
    return model


def _model(model_type, graphs, dense):
    """(fields, JAX module class, port batch, JAX batch) of `model_type`."""
    if model_type == "PNATransformer":
        return (PNA_TRANSFORMER, jax_transformer.PNATransformer, graphs[0],
                graphs[1])
    return (TRANSFORMER, jax_transformer.TransformerPlain) + tuple(dense)


def _grad_l2(got: dict, want: dict) -> float:
    """The relative L2 distance of two gradient sets over every leaf."""
    names = sorted(n for n in want if "running" not in n)
    a, b = (np.concatenate([d[n].ravel() for n in names]) for d in (got, want))
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


@pytest.mark.parametrize("model_type", ["PNATransformer", "TransformerPlain"])
def test_transformer_forward_and_step(graphs, dense, model_type):
    """Eval forward from the same weights, then one supervised step (L1
    over the real graphs' finite labels, the dropout masks replayed) and
    one Adam update, against the JAX model, `Trainer.loss_fn` and
    `GroupedOptimizer`; the state_dict through the JAX converter."""
    mp, jm, g, jb = _model(model_type, graphs, dense)
    var = _var(init_jax_variables(mp, 7, model_type))
    model = _state_dict_round_trip(model_type, mp, var).eval()
    with torch.no_grad():
        got = model(g).numpy()
    want = jm(**mp).apply(_jax_var(var), jb, deterministic=True)
    real = g.graph_mask.numpy()
    assert _rel(got[real], np.asarray(want)[real]) <= TOL
    jout = jax_step(jm(**mp), var, jb, LOSS)
    depth = mp["propagation_depth"]
    assert len(jout[3]) == depth * (7 if model_type == "PNATransformer"
                                    else 4)
    pout = port_step(model_type, mp, var, g, LOSS, jout[3])
    check_step(step_errors(jout, pout, g.graph_mask.numpy()),
               PNA_LEAF_TOL if model_type == "PNATransformer" else LEAF_TOL)
    assert _adam_error(pout[3], var, pout[2], 1e-3) <= 1e-6


@pytest.mark.parametrize("model_type", ["PNATransformer", "TransformerPlain"])
def test_bf16_step_strays_as_far_as_jax(graphs, dense, model_type):
    """The bf16 recipe moves the step's gradient no farther from float32 in
    the port than in the JAX package (the same weights, batch and replayed
    masks; each side's bf16 step against its own float32 step), within
    BF16_FACTOR: a cast to bf16 that the JAX recipe does not make (a
    LayerNorm, softmax or mask computed in bf16) would move the port's
    further.  Readings: port / JAX 0.0406 / 0.0404 (PNATransformer), 0.211
    / 0.486 (TransformerPlain)."""
    mp, jm, g, jb = _model(model_type, graphs, dense)
    var = _var(init_jax_variables(mp, 7, model_type))
    j32 = jax_step(jm(**mp), var, jb, LOSS)
    j16 = jax_step(jm(**mp), var, jb, LOSS, dtype=jnp.bfloat16, masks=j32[3])
    p32 = port_step(model_type, mp, var, g, LOSS, j32[3])
    p16 = port_step(model_type, mp, var, g, LOSS, j32[3],
                    dtype=torch.bfloat16)
    jax_l2, port_l2 = _grad_l2(j16[2], j32[2]), _grad_l2(p16[2], p32[2])
    assert 0 < port_l2 <= BF16_FACTOR * jax_l2, (port_l2, jax_l2)


def test_width_not_a_multiple_of_the_heads():
    """`configs/pnatransformersimple_ogbg.yml` sets hidden 80 with 32
    heads: the JAX attention's reshape raises, and the port refuses the
    model with an error that names the width and the head count."""
    x = jnp.zeros((2, 5, 80))
    jm = jax_attention.MultiHeadSelfAttention(80, 32)
    with pytest.raises(TypeError, match="reshape"):
        jm.init(jax.random.key(0), x, jnp.ones((2, 5), bool))
    args = load_config("configs/pnatransformersimple_ogbg.yml")
    with pytest.raises(ValueError, match="width 80 .* nhead 32"):
        build_model(args["model_type"], args["model_parameters"])
    with pytest.raises(ValueError, match="width 80 .* nhead 32"):
        MultiHeadSelfAttention(80, 32)
