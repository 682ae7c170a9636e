"""Multi-conformer pre-training on the CPU against the JAX package: the
multi-positive loss family, `conformer_collate`, the flat `Net3D` on the
port's CSR complete-graph batch, the metrics on a [B * C, D] 3D side, one
pre-training step (PNA + flat Net3D, `NTXentMultiplePositives`, Adam) and
a short run of the CLI with a `pre-train_QMugs.yml`-shaped config.  Small
sizes: 8 molecules of 4 to 10 atoms with C = 3 conformers, PNA hidden 16 x
2, Net3D hidden 8 x 2; every input comes from numpy seeds.

The JAX side runs what the JAX trainer runs on the CPU: its non-CSR
batches (the conformer bucket has no CSR, `cli/train.py:537-547`), so its
Net3D gathers and reduces with XLA segment ops on sender-major edges, where
the port walks receiver-sorted CSR ranges.  Only the sums' order differs.

Tolerances, each with its reading on this data:
* losses, float32, value and the gradients in z1 and z2: 1e-5 of the
  value and of each gradient's max (readings at most 1.7e-7 and 1.7e-6).
* `conformer_collate`: equal arrays (the same molecules, conformers and
  distances; the port's edges are the JAX ones sorted by receiver).
* flat Net3D, eval forward: 1e-5 of max|ref| (readings at most 4.0e-7).
* flat Net3D, training forward, and the whole pre-training step: against
  the JAX package evaluated in float64 (`_jax_float64`).  Float32 itself
  is the larger error here: with a constant node embedding, the BatchNorm
  statistics over the edge rows (`E[x^2] - mean^2`) lose digits, and the
  JAX float32 forward is as far from float64 as the port.  So each kind of
  reading (the output, the live gradient leaves, the running statistics,
  the edges' distance gradients; in the step the loss and each side's
  leaves and statistics) is held within twice the JAX float32
  computation's own distance to float64 over the same kind, at least 1e-5
  (`_witness_tol`).  Readings, port / JAX float32, worst over the five
  Net3D cases: output 4.6e-5 / 5.7e-5, leaves 3.0e-3 / 3.9e-3, statistics
  3.5e-5 / 4.2e-5, distance gradients 1.2e-4 / 1.4e-4 (with atom features
  in place of the embedding every reading is under 1e-5); the step: loss
  1.0e-6 / 1.4e-6, PNA leaves 1.0e-4 / 1.2e-4, Net3D leaves 3.3e-4 /
  3.7e-4, statistics 2.0e-5 / 2.5e-5.  Zero-gradient leaves (a bias
  before a BatchNorm) stay below 1e-5 of the side's max (readings 4.0e-8
  and 4.0e-7).  A planted fault, the conformers packed graph-major, must
  fail the step check (loss and Net3D leaves).
* the CLI run: as `tests/test_torch_port_cli.py` holds the pre-training
  CLI (float32 runs are chaotic under Adam's early sign steps): the first
  logged loss within 1e-5, each validation metric within 4x the chaos
  scale (two witnesses, each side repeated from weights perturbed by
  2^-20) plus 1e-3.
"""
import contextlib
import dataclasses
import importlib.util
import sys
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml
from flax import traverse_util

from infomax3d_tpu.data.loader import conformer_collate as jax_collate
from infomax3d_tpu.graphs.batch import BucketSpec as JaxBucket
from infomax3d_tpu.graphs.batch import batch_graphs as jax_batch_graphs
from infomax3d_tpu.graphs.batch import to_graph_batch as jax_graph_batch
from infomax3d_tpu.losses import LOSS_REGISTRY as JAX_LOSSES
from infomax3d_tpu.models import PNA as JaxPNA
from infomax3d_tpu.models.net3d import Net3D as JaxNet3D
from infomax3d_tpu.train import metrics as jax_metrics
from infomax3d_tpu_torch.cli import train as port_cli
from infomax3d_tpu_torch.data.cached import SyntheticDataset
from infomax3d_tpu_torch.data.loader import get_collate, to_device
from infomax3d_tpu_torch.data.synthetic import SyntheticMolecules
from infomax3d_tpu_torch.graphs.batch import (batch_graphs, bucket_for,
                                              to_graph_batch)
from infomax3d_tpu_torch.interop import init_jax_variables, params_from_jax
from infomax3d_tpu_torch.losses import LOSS_REGISTRY, get_loss
from infomax3d_tpu_torch.losses.contrastive import MULTI_POSITIVE_LOSSES
from infomax3d_tpu_torch.models import Net3D
from infomax3d_tpu_torch.models.registry import build_model
from infomax3d_tpu_torch.train import metrics as port_metrics
from infomax3d_tpu_torch.train.precision import cast_batch, compute_params
from infomax3d_tpu_torch.train.pretrain import (PretrainStep,
                                                conformer_batches, pretrain)
from test_torch_port_cli import (_first_loss, _metric_violations, _run_jax,
                                 _run_port)

B, C = 8, 3
DATA = dict(seed=0, n_min=4, n_max=10)
# configs_clean/pre-train_QMugs.yml's model options at a small size
MODEL = dict(target_dim=16, hidden_dim=16, mid_batch_norm=True,
             last_batch_norm=True, readout_batchnorm=True,
             batch_norm_momentum=0.93, readout_hidden_dim=16,
             readout_layers=2, dropout=0.0, propagation_depth=2,
             aggregators=["mean", "max", "min", "std"],
             scalers=["identity", "amplification", "attenuation"],
             readout_aggregators=["min", "max", "mean"], pretrans_layers=2,
             posttrans_layers=1, residual=True)
MODEL3D = dict(target_dim=16, hidden_dim=8, node_wise_output_layers=0,
               message_net_layers=1, update_net_layers=1,
               reduce_func="mean", fourier_encodings=4, propagation_depth=2,
               dropout=0.0, batch_norm=True, readout_batchnorm=True,
               batch_norm_momentum=0.93, readout_hidden_dim=8,
               readout_layers=1, readout_aggregators=["min", "max", "mean"])


def _rel(got, ref):
    return float(np.abs(np.asarray(got, np.float64) - ref).max()
                 / np.abs(ref).max())


@contextlib.contextmanager
def _jax_float64():
    """The JAX package evaluated in float64: x64 on, and every one of its
    modules reads `jnp.float32` (the dtype its BatchNorm statistics and
    casts pin) as float64 while the block runs.  No file changes."""
    class _F64(types.ModuleType):
        def __getattr__(self, name):
            return jnp.float64 if name == "float32" else getattr(jnp, name)

    f64 = _F64("jax.numpy in float64")
    patched = [(m, a) for n, m in list(sys.modules.items())
               if n.startswith("infomax3d_tpu.") for a in ("jnp", "_jnp")
               if getattr(m, a, None) is jnp]
    for m, a in patched:
        setattr(m, a, f64)
    try:
        with jax.enable_x64(True):
            yield
    finally:
        for m, a in patched:
            setattr(m, a, jnp)


def _to64(tree):
    return jax.tree_util.tree_map(
        lambda x: jnp.asarray(x, jnp.float64)
        if np.asarray(x).dtype == np.float32 else jnp.asarray(x), tree)


# --- the multi-positive losses -----------------------------------------------

# per loss: its parameters and the 2D head's width in units of D (1, C for
# the Separate2D reading, 2 for the probabilistic head)
LOSS_CASES = {
    "NTXentMultiplePositives": ({"tau": 0.1, "conformer_variance_reg": 0.5,
                                 "variance_reg": 0.3, "covariance_reg": 0.2,
                                 "uniformity_reg": 0.1}, 1),
    "NTXentMultiplePositivesV2": ({"tau": 0.1}, 1),
    "NTXentMultiplePositivesV3": ({"tau": 0.1}, 1),
    "NTXentMultiplePositivesSeparate2D": ({"tau": 0.1}, C),
    "NTXentMinimumMatching": ({"tau": 0.1}, C),
    "MaximumSimilarityMSE": ({"variance_reg": 0.3}, C),
    "NTXentMaximumSimilarity": ({"tau": 0.1}, C),
    "KLDivergenceMultiplePositives": ({}, 2),
    "KLDivergenceMultiplePositivesV2": ({"tau": 100.0}, 2),
    "JSDMultiplePositivesLoss": ({}, 2),
    "NTXentLikelihoodLoss": ({"tau": 0.5, "conformer_variance_reg": 0.5}, 2),
    "NTXentMMDSeparate2D": ({"tau": 0.1}, C),
}


def test_every_multi_positive_loss_is_registered_by_its_jax_name():
    assert {c.__name__ for c in MULTI_POSITIVE_LOSSES} == set(LOSS_CASES)
    for name in LOSS_CASES:
        assert LOSS_REGISTRY[name] is get_loss(name).__class__
        assert name in JAX_LOSSES


def _loss_inputs(seed: int, head: int, D: int = 6):
    """z1 [B, head * D] and z2 [B * C, D].  For the probabilistic head
    (head 2) each molecule's conformers scatter by 0.5 around a mean that
    the head's mean follows, and the head's variance is near 0.25, so that
    the KL and likelihood similarities stay finite in float32."""
    rng = np.random.default_rng(seed)
    if head != 2:
        return ((rng.normal(size=(B, head * D)) * 0.7).astype(np.float32),
                (rng.normal(size=(B * C, D)) * 0.7).astype(np.float32))
    mu = rng.normal(size=(B, 1, D))
    z2 = (mu + 0.5 * rng.normal(size=(B, C, D))).reshape(B * C, D)
    z1 = np.concatenate([mu[:, 0] + 0.3 * rng.normal(size=(B, D)),
                         np.log(0.25) + 0.3 * rng.normal(size=(B, D))], 1)
    return z1.astype(np.float32), z2.astype(np.float32)


@pytest.mark.parametrize("name", sorted(LOSS_CASES))
def test_loss_and_gradients_match_jax(name):
    params, head = LOSS_CASES[name]
    z1, z2 = _loss_inputs(sorted(LOSS_CASES).index(name), head)
    jloss = JAX_LOSSES[name](**params)
    jv, (jg1, jg2) = jax.value_and_grad(
        lambda a, b: jloss(a, b), argnums=(0, 1))(jnp.asarray(z1),
                                                  jnp.asarray(z2))
    t1, t2 = (torch.from_numpy(z).requires_grad_() for z in (z1, z2))
    pv = get_loss(name, **params)(t1, t2)
    pv.backward()
    pv = float(pv.detach())
    assert np.isfinite(float(jv)) and float(jv) != 0.0
    assert abs(pv - float(jv)) <= 1e-5 * abs(float(jv)), (pv, float(jv))
    for got, want in ((t1.grad, jg1), (t2.grad, jg2)):
        want = np.asarray(want)
        assert np.abs(want).max() > 0
        assert _rel(got.numpy(), want) <= 1e-5


def test_mmd_bandwidth_carries_no_gradient():
    """The MMD kernels' bandwidth is detached, as the JAX loss's
    `stop_gradient`: the gradient equals the one with the bandwidth fixed
    at its value."""
    rng = np.random.default_rng(11)
    z1 = torch.from_numpy(rng.normal(size=(4, C * 5)).astype(np.float32))
    z2 = torch.from_numpy(rng.normal(size=(4 * C, 5)).astype(np.float32))
    loss = get_loss("NTXentMMDSeparate2D", tau=0.1)
    a = z2.clone().requires_grad_()
    loss(z1, a).backward()
    real = torch.Tensor.detach
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(torch.Tensor, "detach", lambda t: t)
        b = z2.clone().requires_grad_()
        loss(z1, b).backward()
    assert not torch.allclose(a.grad, b.grad, rtol=1e-3, atol=0)
    assert torch.Tensor.detach is real


# --- conformer_collate -------------------------------------------------------

@pytest.fixture(scope="module")
def dataset():
    return SyntheticDataset(num=B, num_conformers=C, **DATA)


def _jax_2d_bucket(items):
    graphs = [it["graph2d"] for it in items]
    b = bucket_for(graphs, len(items))
    return JaxBucket(len(items), b.n_nodes, b.n_edges)


def _edge_table(senders, receivers, dist, mask):
    """Real edges as rows (receiver, sender, distance), sorted."""
    m = np.asarray(mask)
    t = np.stack([np.asarray(receivers)[m], np.asarray(senders)[m],
                  np.asarray(dist)[m]], axis=1).astype(np.float64)
    return t[np.lexsort((t[:, 1], t[:, 0]))]


@pytest.mark.parametrize("cap", [None, 2])
def test_conformer_collate_matches_jax(dataset, cap):
    """The same molecules and conformers as the JAX collate, packed
    molecule-major (graph k is molecule k // C's conformer k % C), with
    the same distances; `num_conformers` caps C; the port's 3D batch is a
    CSR bucket with max_deg = n_max - 1 and nmax = n_max."""
    items = [dataset[i] for i in range(B)]
    n_conf = cap or C
    bucket = bucket_for([it["graph2d"] for it in items], B)
    got = get_collate("ConformerCollate")(items, bucket, None, cap)
    want = jax_collate(items, _jax_2d_bucket(items), None, cap)
    g3, j3 = got["graph3d"], want["graph3d"]
    sizes = [it["graph2d"]["node_feat"].shape[0] for it in items]
    G = B * n_conf
    assert g3["graph_mask"].sum() == G
    np.testing.assert_array_equal(g3["n_nodes"][:G], np.repeat(sizes,
                                                               n_conf))
    np.testing.assert_array_equal(g3["n_nodes"][:G],
                                  np.asarray(j3.n_nodes)[:G])
    n_tot = sum(sizes) * n_conf
    np.testing.assert_array_equal(g3["node_feat"][:n_tot],
                                  np.asarray(j3.node_feat)[:n_tot])
    assert int(g3["max_deg"]) == max(sizes) - 1
    assert int(g3["nmax"]) == max(sizes)
    np.testing.assert_array_equal(
        _edge_table(g3["senders"], g3["receivers"], g3["edge_dist"],
                    g3["edge_mask"]),
        _edge_table(j3.senders, j3.receivers, j3.edge_dist, j3.edge_mask))
    # molecule-major: graph k holds conformer k % C of molecule k // C
    off = np.concatenate([[0], np.cumsum(g3["n_nodes"][:G])])
    for k in (0, 1, n_conf, G - 1):
        mol, conf = divmod(k, n_conf)
        coords = dataset.ds.mols[mol]["conformers"][conf]
        sel = (g3["receivers"] >= off[k]) & (g3["receivers"] < off[k + 1])
        s, r = g3["senders"][sel] - off[k], g3["receivers"][sel] - off[k]
        np.testing.assert_allclose(
            g3["edge_dist"][sel],
            np.linalg.norm(coords[s] - coords[r], axis=-1), rtol=1e-6)
    # the 2D side is the CSR bond batch of the molecules
    np.testing.assert_array_equal(
        got["graph2d"]["n_nodes"][:B], np.asarray(want["graph2d"].n_nodes)[:B])
    batch = to_device(g3, "cpu")
    assert batch.edge_dist.dtype == torch.float32 and batch.edge_feat is None


def test_flat_contrastive_collate_builds_the_complete_graph(dataset):
    """`contrastive_collate` without `dense_3d` gives the flat Net3D's CSR
    complete graph of each molecule (in place of raising)."""
    items = [dataset[i] for i in range(B)]
    bucket = bucket_for([it["graph2d"] for it in items], B)
    g3 = get_collate("contrastive_collate")(items, bucket)["graph3d"]
    want = jax_graph_batch(jax_batch_graphs(
        [it["graph3d"] for it in items], JaxBucket(B, 256, 1024)))
    np.testing.assert_array_equal(
        _edge_table(g3["senders"], g3["receivers"], g3["edge_dist"],
                    g3["edge_mask"]),
        _edge_table(want.senders, want.receivers, want.edge_dist,
                    want.edge_mask))
    assert np.all(np.diff(g3["receivers"]) >= 0)


# --- the flat Net3D ----------------------------------------------------------

def _net3d_case(**over):
    mp = dict(MODEL3D, **over)
    mols = SyntheticMolecules(B, num_conformers=C, **DATA)
    confs = [mols.graph3d(i, conformer=c) for i in range(B)
             for c in range(C)]
    b = bucket_for(confs, B * C)
    g = to_graph_batch(batch_graphs(confs, b), b, "cpu")
    jg = jax_graph_batch(jax_batch_graphs(confs, JaxBucket(
        B * C, b.n_nodes, b.n_edges)))
    params, stats = init_jax_variables(mp, seed=2, model_type="Net3D")
    w = np.random.default_rng(3).normal(size=(B * C, mp["target_dim"]))
    return dict(mp=mp, g=g, jg=jg, params=params, stats=stats,
                w=w.astype(np.float32))


NET3D_CASES = {
    "mean, no node-wise output": {},
    "sum, no node-wise output": {"reduce_func": "sum"},
    "mean, node-wise output 1": {"node_wise_output_layers": 1},
    "sum, node-wise output 1, 2-layer MLPs": {
        "reduce_func": "sum", "node_wise_output_layers": 1,
        "message_net_layers": 2, "update_net_layers": 2},
    "node features": {"use_node_features": True},
}


@pytest.fixture(scope="module", params=sorted(NET3D_CASES))
def net3d(request):
    return _net3d_case(**NET3D_CASES[request.param])


def _load(case, train):
    m = Net3D.from_config(case["mp"])
    m.load_state_dict(params_from_jax(case["params"], case["stats"]),
                      strict=True)
    return m.train(train)


def test_init_tree_matches_jax_net3d_init(net3d):
    """The numpy init has the flax layout of the JAX `Net3D.init`, and the
    port's module loads it strictly under the reference's names."""
    v = JaxNet3D(**net3d["mp"]).init(jax.random.key(0), net3d["jg"])
    for ref, mine in ((v["params"], net3d["params"]),
                      (v["batch_stats"], net3d["stats"])):
        ref_f = traverse_util.flatten_dict(ref)
        mine_f = traverse_util.flatten_dict(mine)
        assert mine_f.keys() == ref_f.keys()
        for path in ref_f:
            assert mine_f[path].shape == ref_f[path].shape, path
    m = _load(net3d, True)
    assert isinstance(build_model("Net3D", dict(net3d["mp"],
                                                hidden_edge_dim=8)), Net3D)
    assert m.mp_layers[0].soft_edge_network.weight.shape == (1, 8)


def test_eval_forward_matches_jax(net3d):
    want = np.asarray(JaxNet3D(**net3d["mp"]).apply(
        {"params": net3d["params"], "batch_stats": net3d["stats"]},
        net3d["jg"], deterministic=True))
    with torch.no_grad():
        got = _load(net3d, False)(net3d["g"]).numpy()
    assert got.shape == (B * C, 16) and np.abs(want).max() > 0.1
    assert _rel(got, want) <= 1e-5


def _jax_train(case, double):
    """The JAX Net3D's training forward: output, parameter gradients (torch
    names), each real edge's distance gradient (as an edge table) and the
    updated running statistics, under the cotangent `w`."""
    net = JaxNet3D(**case["mp"])
    jg, params, stats, w = case["jg"], case["params"], case["stats"], \
        case["w"]
    cast = _to64 if double else (lambda t: jax.tree_util.tree_map(
        jnp.asarray, t))

    def lf(p, dist):
        g = dataclasses.replace(jg, edge_dist=dist)
        z, mut = net.apply({"params": p, "batch_stats": cast(stats)}, g,
                           deterministic=False, mutable=["batch_stats"])
        return (z * w).sum(), (z, mut["batch_stats"])

    (_, (z, st)), (gp, gd) = jax.jit(jax.value_and_grad(
        lf, argnums=(0, 1), has_aux=True))(cast(params),
                                          cast(np.asarray(jg.edge_dist)))
    np_t = lambda t: jax.tree_util.tree_map(  # noqa: E731
        lambda v: np.asarray(v, np.float64), t)
    grads = {n: v.numpy() for n, v in params_from_jax(np_t(gp), {}).items()}
    run = {n: v.numpy() for n, v in params_from_jax({}, np_t(st)).items()
           if "running" in n}
    return (np.asarray(z, np.float64), grads, run,
            _edge_table(jg.senders, jg.receivers, np.asarray(gd),
                        jg.edge_mask))


# The float32 readings are held to the JAX package in float64 within twice
# the JAX float32 computation's own distance to it (its worst over the
# same kind of reading), at least 1e-5.
WITNESS, FLOOR = 2.0, 1e-5


def _witness_tol(pairs):
    """The bound of a kind of float32 reading: WITNESS times the worst
    distance of the JAX float32 values to the float64 ones over `pairs`
    ((float32, float64) each), at least FLOOR."""
    return max(WITNESS * max(_rel(a, b) for a, b in pairs), FLOOR)


def _zero_leaf(ref, gmax):
    """A bias feeding a BatchNorm: its exact gradient is 0."""
    return np.abs(ref).max() < 1e-6 * gmax


def test_training_forward_and_gradients_match_jax(net3d):
    """Output, every gradient, each real edge's distance gradient and the
    running statistics of a training forward, against the JAX Net3D in
    float64, each kind within twice the JAX float32 forward's own distance
    to it (`_witness_tol`; the readings are in the module docstring)."""
    with _jax_float64():
        z64, g64, st64, d64 = _jax_train(net3d, True)
    z32, g32, st32, d32 = _jax_train(net3d, False)
    m = _load(net3d, True)
    g = net3d["g"]
    dist = g.edge_dist.clone().requires_grad_()
    z = m(dataclasses.replace(g, edge_dist=dist))
    (z * torch.from_numpy(net3d["w"])).sum().backward()
    assert _rel(z.detach().numpy(), z64) <= _witness_tol([(z32, z64)])
    gmax = max(np.abs(v).max() for v in g64.values())
    live = [n for n in g64 if not _zero_leaf(g64[n], gmax)]
    tol = _witness_tol([(g32[n], g64[n]) for n in live])
    for n, p in m.named_parameters():
        got = p.grad.numpy()
        if n in live:
            assert _rel(got, g64[n]) <= tol, n
        else:
            assert np.abs(got).max() <= FLOOR * gmax, n
    tol = _witness_tol([(st32[n], st64[n]) for n in st64])
    for n, v in m.named_buffers():
        if "running" in n:
            assert _rel(v.numpy(), st64[n]) <= tol, n
    got_d = _edge_table(g.senders, g.receivers, dist.grad.numpy(),
                        g.edge_mask)
    np.testing.assert_array_equal(got_d[:, :2], d64[:, :2])
    assert _rel(got_d[:, 2], d64[:, 2]) <= _witness_tol(
        [(d32[:, 2], d64[:, 2])])


def test_bf16_flat_net3d_encodes_bf16_distances(net3d):
    """The bf16 recipe casts `edge_dist` (and `in_degree`) to bf16 before
    the Fourier encoding, as the JAX trainer's `_cast_in` casts every
    float32 leaf; the forward and its gradients stay finite."""
    g = cast_batch(net3d["g"], torch.bfloat16)
    assert g.edge_dist.dtype == g.in_degree.dtype == torch.bfloat16
    m = _load(net3d, True)
    seen = {}
    enc = torch.nn.Module.__call__

    def spy(mod, *a, **k):
        if mod is m.edge_input:
            seen["d"] = a[0].dtype
        return enc(mod, *a, **k)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(torch.nn.Module, "__call__", spy)
        z = torch.func.functional_call(m, compute_params(m, torch.bfloat16),
                                       (g,))
    assert seen["d"] == torch.bfloat16
    z.float().sum().backward()
    for n, p in m.named_parameters():
        assert p.grad is not None and torch.isfinite(p.grad).all(), n


# --- the metrics on a [B * C, D] 3D side -------------------------------------

METRICS = ("positive_similarity", "negative_similarity",
           "contrastive_accuracy", "true_negative_rate", "true_positive_rate",
           "uniformity", "alignment", "batch_variance",
           "dimension_covariance", "conformer_3d_variance")
PROB_METRICS = ("positive_prob", "negative_prob", "conformer_2d_variance")


@pytest.mark.parametrize("name", METRICS + PROB_METRICS)
def test_metrics_read_a_conformer_3d_side_the_jax_way(name):
    """Each probe the conformer configs name, on z1 [B, D] (or the [B, 2D]
    probabilistic head) and z3d [B * C, D], against the JAX metric: the
    truncation to the first B rows where the shapes differ (a reference
    quirk on molecule-major packing), the conformer reshape."""
    table = port_cli.build_metrics({"metrics": [name], "main_metric": "loss",
                                    "loss_func": "NTXent"})
    rng = np.random.default_rng(METRICS.index(name) if name in METRICS
                                else 20 + PROB_METRICS.index(name))
    D = 6
    z1 = rng.normal(size=(B, (2 if name in PROB_METRICS else 1) * D))
    z2 = rng.normal(size=(B * C, D))
    z1, z2 = z1.astype(np.float32) * 0.5, z2.astype(np.float32) * 0.5
    want = float(jax_metrics.get_metric(name)(jnp.asarray(z1),
                                               jnp.asarray(z2)))
    got = float(table[name](z1, z2))
    assert abs(got - want) <= 1e-5 * max(abs(want), 1.0), (got, want)


def test_positive_similarity_truncates_to_the_first_molecules():
    """`PositiveSimilarity` on [B * C] reads z3d[:B]: the first B
    conformer rows (molecule 0's C conformers first), as the JAX metric
    does (a reference quirk)."""
    rng = np.random.default_rng(9)
    z1 = rng.normal(size=(B, 4)).astype(np.float32)
    z2 = rng.normal(size=(B * C, 4)).astype(np.float32)
    metric = port_metrics.PositiveSimilarity()
    assert float(metric(z1, z2)) == float(metric(z1, z2[:B]))


# --- one multi-conformer pre-training step -----------------------------------

def _variables():
    p2, s2 = init_jax_variables(MODEL, 1)
    p3, s3 = init_jax_variables(MODEL3D, 2, "Net3D")
    return {"model": {"params": p2, "batch_stats": s2},
            "model3d": {"params": p3, "batch_stats": s3}}


def _jax_step(variables, double):
    """The JAX trainer's multi-conformer step on the CPU, in float32 or
    float64: PNA on the non-CSR 2D batch and Net3D on the non-CSR conformer
    batch (molecule-major), `NTXentMultiplePositives` tau 0.1, batch
    statistics mutable.  Returns the loss and the gradients and running
    statistics in the port's names."""
    mols = SyntheticMolecules(B, num_conformers=C, **DATA)
    g2s = [mols.graph2d(i) for i in range(B)]
    confs = [mols.graph3d(i, conformer=c) for i in range(B)
             for c in range(C)]
    b2, b3 = bucket_for(g2s, B), bucket_for(confs, B * C)
    g2 = jax_graph_batch(jax_batch_graphs(g2s, JaxBucket(B, b2.n_nodes,
                                                         b2.n_edges)))
    g3 = jax_graph_batch(jax_batch_graphs(confs, JaxBucket(
        B * C, b3.n_nodes, b3.n_edges)))
    pna, net3d = JaxPNA(**MODEL), JaxNet3D(**MODEL3D)
    loss_obj = JAX_LOSSES["NTXentMultiplePositives"](tau=0.1)
    cast = _to64 if double else (lambda t: jax.tree_util.tree_map(
        jnp.asarray, t))
    params = {k: cast(v["params"]) for k, v in variables.items()}
    stats = {k: cast(v["batch_stats"]) for k, v in variables.items()}
    g2c, g3c = (cast(g2), cast(g3)) if double else (g2, g3)

    def lf(p):
        z1, m2 = pna.apply({"params": p["model"],
                            "batch_stats": stats["model"]}, g2c,
                           deterministic=False, mutable=["batch_stats"])
        z2, m3 = net3d.apply({"params": p["model3d"],
                              "batch_stats": stats["model3d"]}, g3c,
                             deterministic=False, mutable=["batch_stats"])
        return loss_obj(z1, z2), (m2, m3)

    (loss, (m2, m3)), grads = jax.jit(jax.value_and_grad(
        lf, has_aux=True))(params)
    np_t = lambda t: jax.tree_util.tree_map(  # noqa: E731
        lambda v: np.asarray(v, np.float64), t)
    out = {}
    for k, st in (("model", m2), ("model3d", m3)):
        sd = params_from_jax(np_t(grads[k]), np_t(st["batch_stats"]))
        out.update({f"{k}.{n}": v.numpy() for n, v in sd.items()
                    if "num_batches" not in n})
    return float(loss), out


def _port_step(variables, graph_major=False):
    """The port's float32 step on the conformer batch (or, as a planted
    fault, on the conformers packed graph-major): loss, gradients and
    running statistics."""
    port = PretrainStep(MODEL, MODEL3D, variables, "cpu", None,
                        {"tau": 0.1}, {"lr": 8e-5},
                        "NTXentMultiplePositives", "Net3D")
    g2, g3, sizes = conformer_batches(B, C, **DATA)
    if graph_major:
        mols = SyntheticMolecules(B, num_conformers=C, **DATA)
        confs = [mols.graph3d(i, conformer=c) for c in range(C)
                 for i in range(B)]
        b = bucket_for(confs, B * C)
        g3 = to_graph_batch(batch_graphs(confs, b), b, "cpu")
    a, b = port.prepare(g2, g3)
    loss = float(port.loss_and_grads(a, b))
    got = {n: p.grad.numpy().copy() for n, p in port.named_parameters()}
    for pre, m in (("model", port.model), ("model3d", port.model3d)):
        got.update({f"{pre}.{n}": v.numpy().copy()
                    for n, v in m.named_buffers() if "running" in n})
    return loss, got, sizes


@pytest.fixture(scope="module")
def steps():
    variables = _variables()
    with _jax_float64():
        jax64 = _jax_step(variables, True)
    return {"variables": variables, "port": _port_step(variables),
            "jax64": jax64, "jax32": _jax_step(variables, False)}


def _step_violations(port, steps):
    """What a port step breaks of the check against the JAX step in
    float64: the loss, every gradient leaf and running statistic within
    twice the JAX float32 step's own distance (`_witness_tol`, per kind
    and side), zero-gradient leaves below FLOOR of the side's max."""
    loss, got, _ = port
    jl, want = steps["jax64"]
    jl32, want32 = steps["jax32"]
    bad = []
    if abs(loss - jl) > _witness_tol([(jl32, jl)]) * abs(jl):
        bad.append(("loss", loss, jl))
    for side in ("model", "model3d"):
        keys = [k for k in want if k.startswith(side + ".")]
        gmax = max(np.abs(want[k]).max() for k in keys if "running" not in k)
        stats = [k for k in keys if "running" in k]
        live = [k for k in keys if k not in stats
                and not _zero_leaf(want[k], gmax)]
        for group in (stats, live):
            tol = _witness_tol([(want32[k], want[k]) for k in group])
            bad += [(k, _rel(got[k], want[k]), tol) for k in group
                    if _rel(got[k], want[k]) > tol]
        bad += [(k, np.abs(got[k]).max() / gmax) for k in
                set(keys) - set(stats) - set(live)
                if np.abs(got[k]).max() > FLOOR * gmax]
    return bad


def test_step_matches_the_jax_step(steps):
    """The port's float32 multi-conformer step against the JAX step in
    float64: the loss, every gradient leaf and every running statistic,
    each kind within twice the JAX float32 step's own distance to it
    (`_witness_tol`)."""
    _, got, sizes = steps["port"]
    assert sizes["conformers"] == B * C and sizes["edges_3d"] > 0
    assert set(got) == set(steps["jax64"][1])
    assert _step_violations(steps["port"], steps) == []


def test_step_check_fails_on_graph_major_packing(steps):
    """A planted fault, the conformers packed graph-major (conformer 0 of
    every molecule first) where the loss reshapes molecule-major, must
    fail the step check."""
    bad = _step_violations(_port_step(steps["variables"], True), steps)
    assert any(k == "loss" for k, *_ in bad), bad
    assert any(k.startswith("model3d.") for k, *_ in bad), bad


def test_pretrain_entry_point_runs_the_flat_net3d_on_cpu():
    """`pretrain()` with `model3d_type` Net3D trains on the conformer
    batch: the loss falls over a few steps, in float32 and bf16."""
    for bf16 in (False, True):
        out = pretrain({"model_parameters": MODEL,
                        "model3d_parameters": MODEL3D,
                        "model3d_type": "Net3D", "num_conformers": C,
                        "loss_func": "NTXentMultiplePositives",
                        "loss_params": {"tau": 0.1},
                        "optimizer_params": {"lr": 1e-3}, "batch_size": B,
                        "bf16_compute": bf16, "dataset_params": DATA},
                       steps=4, device="cpu")
        assert out["sizes"]["conformers"] == B * C
        assert all(np.isfinite(out["losses"]))
        assert out["losses"][-1] < out["losses"][0]


# --- the CLI -----------------------------------------------------------------

QMUGS = "configs_clean/pre-train_QMugs.yml"


# pre-train_QMugs.yml at this file's widths on 400 synthetic molecules of
# 4 to 10 atoms: 2 steps an epoch at batch 32, 2 epochs, logged every 2
CLI = dict(dataset="synthetic",
           dataset_params={"num": 400, "n_min": 4, "n_max": 10},
           num_train=64, batch_size=32, num_epochs=2, log_iterations=2,
           model_parameters=MODEL, model3d_parameters=MODEL3D,
           use_tensorboard=False)


@pytest.fixture(scope="module")
def cli_runs(tmp_path_factory):
    """The JAX CLI (its non-CSR batches) and the port's CLI on the CPU
    from the same initial weights, each also from weights perturbed by
    2^-20 (the witnesses of `tests/test_torch_port_cli.py`)."""
    d = tmp_path_factory.mktemp("conformer_cli")
    runs = {"jax_qmugs": _run_jax(QMUGS, CLI, str(d / "jax")),
            "jax_qmugs_w": _run_jax(QMUGS, CLI, str(d / "jax_w"), True)}
    init = runs["jax_qmugs"]["init"]
    runs["port_qmugs"] = _run_port(QMUGS, CLI, str(d / "port"), init)
    runs["port_qmugs_w"] = _run_port(QMUGS, CLI, str(d / "port_w"), init,
                                     True)
    return runs


def test_cli_first_logged_loss(cli_runs):
    name = "NTXentMultiplePositives"
    want = _first_loss(cli_runs["jax_qmugs"]["records"], 2, name)
    got = _first_loss(cli_runs["port_qmugs"]["records"], 2, name)
    assert abs(got - want) <= 1e-5 * abs(want)


def test_cli_validation_metrics(cli_runs):
    """Every validation metric of both epochs and of the best checkpoint's
    evaluation, within 4x the chaos scale plus 1e-3 of the JAX run."""
    assert "positive_similarity" in cli_runs["port_qmugs"]["result"]
    assert _metric_violations(cli_runs, "qmugs") == []


def test_resolve_fast_paths_routes_the_flat_net3d():
    for collate, dense, want in (("conformer_collate", "auto", False),
                                 ("contrastive_collate", False, False),
                                 ("contrastive_collate", "auto", True)):
        args = {"model3d_type": "Net3D", "collate_function": collate,
                "dense_3d": dense}
        port_cli.resolve_fast_paths(args)
        assert args["_dense_3d"] is want
        models = port_cli.build_models(dict(
            args, model_type="PNA", trainer="contrastive",
            model_parameters=MODEL, model3d_parameters=MODEL3D))
        assert type(models["model3d"]).__name__ == \
            ("Net3DDense" if want else "Net3D")


def test_dense_net3d_refuses_node_features():
    """`use_node_features` gives Net3DDense the flat Net3D's parameters
    (the atom encoder in place of the node embedding), and the dense
    forward on the same molecules equals the flat one with the same
    weights (it raised before the dense layout ported the encoder)."""
    from infomax3d_tpu_torch.graphs.batch import (batch_graphs, bucket_for,
                                                  to_graph_batch)
    from infomax3d_tpu_torch.graphs.dense import dense_batch, to_dense_batch
    from infomax3d_tpu_torch.models import Net3DDense
    mols = SyntheticMolecules(B, **DATA)
    confs = [mols.graph3d(i) for i in range(B)]
    g = to_dense_batch(dense_batch(
        confs, B, max(m["node_feat"].shape[0] for m in confs)), "cpu")
    b = bucket_for(confs, B)
    flat_g = to_graph_batch(batch_graphs(confs, b), b, "cpu")
    mp = dict(MODEL3D, use_node_features=True)
    dense, flat = Net3DDense.from_config(mp), Net3D.from_config(mp)
    assert dict(dense.named_parameters()).keys() == \
        dict(flat.named_parameters()).keys()
    assert hasattr(dense, "atom_encoder")
    dense.load_state_dict(flat.state_dict())
    with torch.no_grad():
        want = flat.eval()(flat_g)
        got = dense.eval()(g)
    assert float((got - want).abs().max()) <= 1e-5 * float(
        want.abs().max())


def test_chip_smoke_trains_the_conformer_configs():
    """Phase 18 trains the architecture of `pre-train_QMugs.yml` and
    `pre-train_GEOM-Drugs.yml` as the files state it."""
    root = Path(__file__).resolve().parents[1]
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  root / "chip_smoke.py")
    chip_smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip_smoke)
    for path, C_ in ((QMUGS, 3), ("configs_clean/pre-train_GEOM-Drugs.yml",
                                  5)):
        cfg = yaml.safe_load(open(root / path))
        assert chip_smoke.MODEL_PARAMETERS == cfg["model_parameters"]
        assert chip_smoke.MODEL3D_PARAMETERS == cfg["model3d_parameters"]
        assert cfg["model3d_type"] == "Net3D"
        assert cfg["loss_func"] == chip_smoke.CONF_LOSS
        assert chip_smoke.LOSS_PARAMS == cfg["loss_params"]
        assert chip_smoke.OPTIMIZER_PARAMS == cfg["optimizer_params"]
        assert chip_smoke.BATCH == cfg["batch_size"]
        assert cfg["num_conformers"] == C_ == chip_smoke.CONF_CONFS[path]
