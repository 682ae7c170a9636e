"""The GIN slice on the CPU: the CSR sum and the sender-keyed segment sum
(each kernel's plain twin against the JAX package's Pallas kernel in
interpret mode), the sender gather with its segment-sum backward, OGBGNN's
weights, forward and bf16 dtype flow, and the whole supervised step
(masked BCEWithLogits, Adam) against the JAX package's `Trainer` step.
Small sizes: GIN 3 layers of width 32, 24 molecule-like graphs of 10-41
atoms; every input comes from numpy seeds.

Tolerances, each with its reading on this data (the reason first).  A
leaf's error is its max |port - ref| over its max |ref|; the zero-gradient
leaves (`ZERO_GRADIENT`: the Linear biases that feed a BatchNorm with no
nonlinearity between, whose gradient the normalization removes) read their
max |port| over the largest gradient instead.

* Kernel twins: `csr_sum` and the JAX `csr_sum` sum at most max_deg (4)
  values per node in float32; the port adds them in range order, the Pallas
  kernel through a 0/1 incidence matmul (interpret mode: XLA's float32 dot).
  Held at 1e-6 relative (plus 1e-6 of the max for cancelling sums); reading
  0 (bit-equal) in bf16 and float32.  The gradient is a gather: exact.
  `snd_segment_sum` in bf16 against `snd_segment_sum_bf16`: both round one
  float32 sum of at most 4 bf16 values once: equal.  In float32 against
  `jax.ops.segment_sum` over the senders: 1e-6 (reading 0).
* The sender gather's gradient against `jax.vjp` of the JAX `gather_src`
  (whose CPU backward is `sorted_segment_sum`, float32 prefix-sum
  differences): float32 within 1e-6 of the max (reading 5.6e-7), bf16
  within one bf16 ulp (2**-7) of the max (reading 4.5e-3: a prefix
  difference can round to the neighbouring bf16 value).
* Forward, float32, against the JAX OGBGNN from the same weights: 1e-5 of
  the output's max in eval and training mode (readings 1.8e-7 and
  7.6e-7), the updated running statistics 1e-5 of each buffer's max
  (reading 4.0e-7).
* The whole float32 step against the JAX `Trainer` step: the loss within
  1e-5 relative (reading 9.2e-8), each leaf within 1e-4 (reading 2.3e-5),
  the zero-gradient leaves below 1e-5 (reading 2.3e-7), the running
  statistics within 1e-5 (reading 3.7e-7); one Adam update within 1e-6.
* The bf16 step: the bf16 check (`_bf16_violations`): every leaf has a
  finite gradient, non-zero unless it is a zero-gradient leaf; the
  zero-gradient leaves below 1e-4 of the largest gradient; each leaf
  within 0.5; the gradient within 0.3 (L2).  Readings against the JAX
  bf16 step: worst leaf 0.108, zero-gradient 3.2e-7, L2 0.042; against the
  port's float32 step: 0.197, 3.3e-7, 0.070 (the JAX bf16 step is 0.171
  and 0.071 off its float32 one).  The planted fault (a zeroed
  `snd_segment_sum`, which drops every message-path gradient into h)
  reads a leaf at 1.02 and L2 0.78, so it fails.  The bf16 gap is the
  step's sensitivity to rounding: master weights perturbed by 2**-16
  relative (below bf16 resolution) move the bf16 gradient by 0.030 (L2),
  the float32 one by 0.0038.  The loss is held to the JAX bf16 step
  within 5e-3 (reading 9.4e-4; JAX bf16 against float32 4.9e-3), the
  running statistics within 1e-2 (reading 2.5e-4).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from infomax3d_tpu.graphs.batch import BucketSpec as JaxBucket
from infomax3d_tpu.graphs.batch import batch_graphs as jax_batch_graphs
from infomax3d_tpu.graphs.batch import to_graph_batch as jax_graph_batch
from infomax3d_tpu.models.gin import OGBGNN as JaxOGBGNN
from infomax3d_tpu.ops import mailbox
from infomax3d_tpu.ops.pallas import spmm
from infomax3d_tpu.train.optim import GroupedOptimizer, label_params
from infomax3d_tpu.train.trainer import Trainer, _elementwise_supervised_loss
from infomax3d_tpu_torch.data.synthetic import SyntheticMolecules
from infomax3d_tpu_torch.graphs.batch import (batch_graphs, bucket_for,
                                              to_graph_batch)
from infomax3d_tpu_torch.interop import init_jax_variables, params_from_jax
from infomax3d_tpu_torch.models.gin import OGBGNN
from infomax3d_tpu_torch.ops import aggregate
from infomax3d_tpu_torch.ops.kernels import (_build, csr_mean, csr_sum,
                                             csr_sum_reference,
                                             snd_segment_sum,
                                             snd_segment_sum_reference)
from infomax3d_tpu_torch.ops.segment import take_rows
from infomax3d_tpu_torch.train.supervised import (SupervisedStep,
                                                  labelled_batch,
                                                  supervised,
                                                  supervised_loss)

# configs/30.yml's model at a small size: `emb_dim` is no field of the
# model and is dropped, as the JAX package's `_adapt_model_params` drops it
MODEL = dict(target_dim=1, num_layers=3, hidden_dim=32, dropout=0.0,
             batch_norm_momentum=0.1, emb_dim=32, virtual_node=False)
JAX_MODEL = {k: v for k, v in MODEL.items() if k != "emb_dim"}
LOSS = "BCEWithLogitsLoss"
OPT = {"lr": 1e-3}
B = 24
DATA = dict(seed=0, n_min=10, n_max=41)
D = 24


def _t(x):
    return torch.from_numpy(np.array(x))


def _bf16(x):
    return np.asarray(jnp.asarray(x, jnp.bfloat16).astype(jnp.float32))


@pytest.fixture(scope="module")
def batch():
    """The labelled batch of `labelled_batch(B)`, built by both batchers:
    (port arrays, bucket, JAX arrays, JAX GraphBatch)."""
    ds = SyntheticMolecules(B, num_targets=1, **DATA)
    labels = (ds.targets > 0).astype(np.float32)
    mols = [dict(ds.graph2d(i), targets=labels[i]) for i in range(B)]
    b = bucket_for(mols, B)
    jarr = jax_batch_graphs(mols, JaxBucket(
        b.n_graphs, b.n_nodes, b.n_edges, max_deg=b.max_deg, csr=True,
        nmax=b.nmax), extras_keys=("targets",))
    return (batch_graphs(mols, b), b, jarr,
            jax_graph_batch(jarr, extras_keys=("targets",)))


def test_labelled_batch_matches_jax_batcher(batch):
    """`labelled_batch` is that batch: the labels are [G, 1] float32 0/1
    with zero padding rows, as the JAX batcher stacks them."""
    arr, b, jarr, _ = batch
    g, sizes = labelled_batch(B, **DATA)
    assert g.targets.dtype == torch.float32 and g.targets.shape == (B, 1)
    np.testing.assert_array_equal(g.targets.numpy(), jarr["targets"])
    assert set(np.unique(arr["targets"])) == {0.0, 1.0}
    for key in ("csr_row_ptr", "csc_row_ptr", "csc_perm", "senders",
                "receivers", "node_feat", "edge_feat"):
        np.testing.assert_array_equal(getattr(g, key).numpy(), jarr[key],
                                      err_msg=key)
    assert sizes == {"graphs": B, "nodes": int(arr["node_mask"].sum()),
                     "edges": int(arr["edge_mask"].sum())}
    padded = to_graph_batch(batch_graphs(
        [dict(SyntheticMolecules(3, **DATA).graph2d(i), targets=[1.0])
         for i in range(3)], dataclasses.replace(b, n_graphs=5)),
        dataclasses.replace(b, n_graphs=5), "cpu")
    np.testing.assert_array_equal(padded.targets.numpy()[:, 0],
                                  [1, 1, 1, 0, 0])


# --- the kernels' plain twins against the Pallas kernels --------------------

@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_csr_sum_matches_jax(batch, dtype):
    """The twin against the JAX `csr_sum` (Pallas, interpret mode), and
    the gradient against its `jax.vjp` (module docstring)."""
    arr, b, jarr, _ = batch
    N, E, K = b.n_nodes, b.n_edges, b.max_deg
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    rng = np.random.default_rng(1)
    m = _bf16(rng.normal(size=(E, D)))
    ct = rng.normal(size=(N, D)).astype(np.float32)
    rp, recv = jnp.asarray(arr["csr_row_ptr"]), jnp.asarray(arr["receivers"])
    want, vjp = jax.vjp(lambda x: spmm.csr_sum(x, rp, recv, K, True),
                        jnp.asarray(m, jdt))
    tm = _t(m).to(tdt).requires_grad_()
    got = csr_sum(tm, _t(arr["csr_row_ptr"]), _t(arr["receivers"]))
    assert got.dtype == torch.float32 and want.dtype == jnp.float32
    w = np.asarray(want)
    np.testing.assert_allclose(got.detach().numpy(), w, rtol=1e-6,
                               atol=1e-6 * np.abs(w).max())
    assert torch.equal(got.detach(), csr_sum_reference(
        tm.detach(), _t(arr["csr_row_ptr"])))
    deg = np.diff(arr["csr_row_ptr"])
    assert (got.detach().numpy()[deg == 0] == 0).all()
    got.backward(_t(ct))
    d_want = np.asarray(vjp(jnp.asarray(ct))[0], np.float32)
    assert tm.grad.dtype == tdt
    np.testing.assert_array_equal(tm.grad.float().numpy(), d_want)
    e_real = int(arr["csr_row_ptr"][-1])
    assert (tm.grad.float().numpy()[e_real:] == 0).all()


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_csr_mean_matches_jax(batch, dtype):
    """`csr_mean` is the sum over max(deg, 1) in the messages' dtype: the
    JAX `csr_mean`'s value (float32 1e-6; bf16 equal, one rounding of the
    same float32 quotient)."""
    arr, b, _, _ = batch
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    m = _bf16(np.random.default_rng(2).normal(size=(b.n_edges, D)))
    want = spmm.csr_mean(jnp.asarray(m, jdt), jnp.asarray(arr["csr_row_ptr"]),
                         jnp.asarray(arr["receivers"]), b.max_deg, True)
    got = csr_mean(_t(m).to(tdt), _t(arr["csr_row_ptr"]),
                   _t(arr["receivers"]))
    assert got.dtype == tdt
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), rtol=1e-6,
                               atol=1e-6)


def test_snd_segment_sum_bf16_matches_pallas(batch):
    """bf16: equal to `snd_segment_sum_bf16` (interpret mode, the JAX
    batcher's window markers), nodes that send nothing get 0."""
    arr, b, jarr, _ = batch
    N = b.n_nodes
    ct = _bf16(np.random.default_rng(3).normal(size=(b.n_edges, D)))
    want = spmm.snd_segment_sum_bf16(
        jnp.asarray(ct, jnp.bfloat16), jnp.asarray(arr["senders"]),
        jnp.asarray(jarr["csr_pair_base"]), jarr["csr_pair_win"].shape[0],
        True)[:N]
    got = snd_segment_sum(_t(ct).bfloat16(), _t(arr["csc_row_ptr"]),
                          _t(arr["csc_perm"]))
    assert got.dtype == torch.bfloat16 and got.shape == (N, D)
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want, np.float32))
    sent = np.diff(arr["csc_row_ptr"])
    assert (sent == 0).any() and (got.float().numpy()[sent == 0] == 0).all()


def test_snd_segment_sum_f32_matches_segment_sum(batch):
    """float32: the sum over the senders of `jax.ops.segment_sum`, 1e-6."""
    arr, b, _, _ = batch
    N = b.n_nodes
    ct = np.random.default_rng(4).normal(size=(b.n_edges, D)).astype(
        np.float32)
    want = jax.ops.segment_sum(ct, np.minimum(arr["senders"], N),
                               num_segments=N + 1)[:N]
    got = snd_segment_sum_reference(_t(ct), _t(arr["csc_row_ptr"]),
                                    _t(arr["csc_perm"]))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_take_rows_matches_jax_gather_src(batch, dtype):
    """The sender gather: its value equals the JAX `gather_src`'s, and its
    gradient (the segment sum over the CSC order) matches `jax.vjp` of it
    on the JAX CSR batch (tolerances in the module docstring)."""
    arr, b, _, jb = batch
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    rng = np.random.default_rng(5)
    h = _bf16(rng.normal(size=(b.n_nodes, D)))
    ct = _bf16(rng.normal(size=(b.n_edges, D)))   # padding rows included
    want, vjp = jax.vjp(lambda x: mailbox.gather_src(jb, x),
                        jnp.asarray(h, jdt))
    th = _t(h).to(tdt).requires_grad_()
    got = take_rows(th, _t(arr["senders"]), _t(arr["csc_row_ptr"]),
                    _t(arr["csc_perm"]))
    np.testing.assert_array_equal(got.detach().float().numpy(),
                                  np.asarray(want, np.float32))
    got.backward(_t(ct).to(tdt))
    w = np.asarray(vjp(jnp.asarray(ct, jdt))[0], np.float32)
    tol = 1e-6 if dtype == "float32" else 2.0 ** -7
    assert th.grad.dtype == tdt
    assert np.abs(th.grad.float().numpy() - w).max() <= tol * np.abs(w).max()
    assert torch.equal(th.grad, snd_segment_sum(
        _t(ct).to(tdt), _t(arr["csc_row_ptr"]), _t(arr["csc_perm"])))


def test_edge_aggregate_dispatch(batch):
    """"sum" is `csr_sum`, "mean" `csr_mean`; any other op raises."""
    arr, b, _, _ = batch
    g = to_graph_batch(arr, b, "cpu")
    m = torch.randn(b.n_edges, D, generator=torch.Generator().manual_seed(0))
    assert torch.equal(aggregate.edge_aggregate(g, m, "sum"),
                       csr_sum(m, g.csr_row_ptr))
    assert torch.equal(aggregate.edge_aggregate(g, m, "mean"),
                       csr_mean(m, g.csr_row_ptr))
    with pytest.raises(ValueError, match="unsupported edge aggregation"):
        aggregate.edge_aggregate(g, m, "max")


def test_gin_kernels_take_the_card_path(batch, monkeypatch):
    """With the device check stubbed to take the CUDA path on CPU tensors:
    a raw launch given a tensor that requires grad raises before anything
    is built; the CSR sum launches inside its Function, the segment sum
    inside the gather's backward, each counted once."""
    import importlib
    arr, b, _, _ = batch
    mods = {n: importlib.import_module(f"infomax3d_tpu_torch.ops.kernels.{n}")
            for n in ("csr_sum", "snd_segment_sum")}
    monkeypatch.setattr(_build, "on_card", lambda t, name: True)
    rp, crp, perm = (_t(arr[k]) for k in ("csr_row_ptr", "csc_row_ptr",
                                          "csc_perm"))
    x = torch.zeros(b.n_edges, D, requires_grad=True)
    with pytest.raises(RuntimeError, match="not differentiable"):
        mods["csr_sum"]._launch(x, rp)
    with pytest.raises(RuntimeError, match="not differentiable"):
        mods["snd_segment_sum"]._launch(x, crp, perm)
    launched = []
    for m in mods.values():
        monkeypatch.setattr(m, "launcher", lambda name, symbol, argtypes:
                            lambda *args: launched.append(symbol) or 0)
        monkeypatch.setattr(m, "stream_of", lambda t: 0)
    before = (csr_sum.launches, snd_segment_sum.launches)
    h = torch.zeros(b.n_nodes, D, dtype=torch.bfloat16, requires_grad=True)
    msg = take_rows(h, _t(arr["senders"]), crp, perm)
    csr_sum(msg, rp, _t(arr["receivers"])).sum().backward()
    assert launched == ["csr_sum_bf16", "snd_segment_sum_bf16"]
    assert (csr_sum.launches, snd_segment_sum.launches) == (
        before[0] + 1, before[1] + 1)


# --- weights, forward, dtype flow -------------------------------------------

def _variables(seed=1):
    params, stats = init_jax_variables(MODEL, seed, "OGBGNN")
    return {"params": params, "batch_stats": stats}


def _port_model(variables):
    m = OGBGNN.from_config(MODEL)
    m.load_state_dict(params_from_jax(variables["params"],
                                      variables["batch_stats"]), strict=True)
    return m


def _jax_tree(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def test_weights_load_strictly_and_convert_back(batch):
    """The seeded flax-layout trees load strictly into the port's OGBGNN;
    its state_dict, renamed by the JAX package's own `convert_state_dict`
    against a flax `OGBGNN.init` template, fills every leaf (no `missing`,
    no `unused`) with the trees' values."""
    from flax import traverse_util
    from infomax3d_tpu.train.torch_interop import convert_state_dict
    variables = _variables()
    sd = {k: v.numpy() for k, v in _port_model(variables).state_dict().items()}
    tmpl = JaxOGBGNN(**JAX_MODEL).init(jax.random.key(0), batch[3])
    flat_p = traverse_util.flatten_dict(tmpl["params"])
    flat_s = traverse_util.flatten_dict(tmpl["batch_stats"])
    out_p, out_s, report = convert_state_dict(sd, flat_p, flat_s)
    assert report["missing"] == [] and report["unused"] == []
    for out, tree in ((out_p, variables["params"]),
                      (out_s, variables["batch_stats"])):
        want = traverse_util.flatten_dict(tree)
        assert set(out) == set(want)
        for k, v in want.items():
            np.testing.assert_array_equal(out[k], v, err_msg=str(k))
    assert float(abs(variables["params"]["node_gnn"]["conv_0"]["eps"][0])) > 0


@pytest.mark.parametrize("train", [False, True])
def test_forward_matches_jax(batch, train):
    """float32 forward against the JAX OGBGNN from the same weights, in
    eval mode and in training mode (batch statistics, updated running
    statistics)."""
    arr, b, _, jb = batch
    variables = _variables()
    jm = JaxOGBGNN(**JAX_MODEL)
    jv = _jax_tree(variables)
    if train:
        want, mut = jm.apply(jv, jb, deterministic=False,
                             mutable=["batch_stats"])
        want_stats = params_from_jax({}, jax.tree_util.tree_map(
            np.asarray, mut["batch_stats"]))
    else:
        want = jm.apply(jv, jb, deterministic=True)
    m = _port_model(variables).train(train)
    with torch.no_grad():
        got = m(to_graph_batch(arr, b, "cpu"))
    w = np.asarray(want)
    assert got.shape == w.shape == (B, 1)
    assert np.abs(got.numpy() - w).max() <= 1e-5 * np.abs(w).max()
    if train:
        bufs = dict(m.named_buffers())
        for k, v in want_stats.items():
            if "running" in k:
                v = v.numpy()
                assert np.abs(bufs[k].numpy() - v).max() <= \
                    1e-5 * np.abs(v).max(), k


def _flax_paths(tree, prefix=()):
    for k, v in tree.items():
        if hasattr(v, "items"):
            yield from _flax_paths(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def test_bf16_dtype_flow_matches_jax(batch, monkeypatch):
    """Under the bf16 recipe the dtypes of the encoders, every `conv_i`
    output, inner Linear and BatchNorm, outer BatchNorm and the prediction
    head are the JAX package's (read with `capture_intermediates`): float32
    after the encoders and layer 0's messages, because the CSR sum returns
    float32."""
    from infomax3d_tpu.train.precision import cast_floats
    from infomax3d_tpu_torch.train.precision import (cast_batch,
                                                     compute_params)
    arr, b, _, jb = batch
    variables = _variables()
    _, inter = JaxOGBGNN(**JAX_MODEL).apply(
        cast_floats(_jax_tree(variables), jnp.bfloat16) | {
            "batch_stats": _jax_tree(variables["batch_stats"])},
        cast_floats(jb, jnp.bfloat16), deterministic=False,
        mutable=["batch_stats", "intermediates"],
        capture_intermediates=True)
    want = {"/".join(path[:-1]): str(v[0].dtype)
            for path, v in _flax_paths(inter["intermediates"])
            if path[-1] == "__call__" and path[-2:-1] != ("encoder",)}
    names = {"node_gnn/atom_encoder": "node_gnn.atom_encoder",
             "graph_pred_linear": "graph_pred_linear"}
    for i in range(MODEL["num_layers"]):
        conv = f"node_gnn.convs.{i}"
        names[f"node_gnn/conv_{i}"] = conv
        for fl, tn in (("bond_encoder", "bond_encoder"), ("Dense_0", "mlp.0"),
                       ("MaskedBatchNorm_0", "mlp.1"), ("Dense_1", "mlp.3")):
            names[f"node_gnn/conv_{i}/{fl}"] = f"{conv}.{tn}"
        names[f"node_gnn/batch_norm_{i}"] = f"node_gnn.batch_norms.{i}"
    assert set(want) - {"", "node_gnn"} == set(names)

    m = _port_model(variables).train()
    got, msgs = {}, []
    mods = dict(m.named_modules())
    for tn in names.values():
        mods[tn].register_forward_hook(
            lambda mod, i, o, tn=tn: got.__setitem__(tn, str(o.dtype)))
    real = aggregate.edge_aggregate
    monkeypatch.setattr(aggregate, "edge_aggregate", lambda g, msg, op: (
        msgs.append(msg.dtype), real(g, msg, op))[1])
    monkeypatch.setattr("infomax3d_tpu_torch.models.gin.edge_aggregate",
                        aggregate.edge_aggregate)
    g = cast_batch(to_graph_batch(arr, b, "cpu"), torch.bfloat16)
    torch.func.functional_call(m, compute_params(m, torch.bfloat16), (g,))
    assert {jn: got[tn].replace("torch.", "") for jn, tn in names.items()} \
        == {jn: want[jn] for jn in names}
    assert got["node_gnn.convs.0.bond_encoder"] == "torch.bfloat16"
    assert got["node_gnn.convs.0"] == "torch.float32"
    assert msgs == [torch.bfloat16] + [torch.float32] * (
        MODEL["num_layers"] - 1)


# --- the whole step ---------------------------------------------------------

def _jax_step(jb, variables, cdt):
    """The JAX package's supervised step as its `Trainer` runs it:
    `Trainer.loss_fn` (through `_apply` with its bf16 casts and the loss
    read from the uncast batch) under `value_and_grad`, batch statistics
    mutable.  Returns the loss, the gradients and the updated running
    statistics, named as the port's state_dict."""
    tr = Trainer.__new__(Trainer)
    tr.models = {"model": JaxOGBGNN(**JAX_MODEL)}
    tr.loss_name, tr.compute_dtype, tr.args = LOSS, cdt, {}
    params = {"model": _jax_tree(variables["params"])}
    stats = {"model": _jax_tree(variables["batch_stats"])}

    def lf(p):
        loss, _, new_stats = tr.loss_fn(p, stats, {"graph": jb}, 0,
                                        jax.random.key(0), True)
        return loss, new_stats

    (loss, new_stats), grads = jax.jit(jax.value_and_grad(
        lf, has_aux=True))(params)
    to_np = lambda t: jax.tree_util.tree_map(  # noqa: E731
        lambda v: np.asarray(v, np.float32), t)
    sd = params_from_jax(to_np(grads["model"]), to_np(new_stats["model"]))
    return float(loss), {n: v.numpy() for n, v in sd.items()
                         if "num_batches" not in n}


def _port_step(arr, b, variables, dtype):
    step = SupervisedStep("OGBGNN", MODEL, variables, "cpu", dtype, LOSS,
                          OPT)
    g = step.prepare(to_graph_batch(arr, b, "cpu"))
    loss = step.loss_and_grads(g)
    out = {n: None if p.grad is None else p.grad.numpy().copy()
           for n, p in step.model.named_parameters()}
    out.update({n: v.numpy().copy() for n, v in step.model.named_buffers()
                if "running" in n})
    return float(loss), out, step


@pytest.fixture(scope="module")
def steps(batch):
    arr, b, _, jb = batch
    variables = _variables()
    return {"variables": variables,
            "jax32": _jax_step(jb, variables, None),
            "jax16": _jax_step(jb, variables, jnp.bfloat16),
            "port32": _port_step(arr, b, variables, None),
            "port16": _port_step(arr, b, variables, torch.bfloat16)}


# Leaves with an exactly zero gradient: the Linear biases that feed a
# BatchNorm with no nonlinearity between (a GINConv's first Linear feeds
# its BatchNorm, its last one the layer's BatchNorm).
ZERO_GRADIENT = ("mlp.0.bias", "mlp.3.bias")


def _grad_keys(ref):
    return [k for k in ref if "running" not in k]


def _leaf_errors(got, ref):
    """Each leaf's max |got - ref| over its max |ref|; a zero-gradient
    leaf reads its max |got| over the largest gradient."""
    keys = _grad_keys(ref)
    gmax = max(np.abs(ref[k]).max() for k in keys)
    return {k: (np.abs(got[k]).max() / gmax if k.endswith(ZERO_GRADIENT)
                else np.abs(got[k] - ref[k]).max() / np.abs(ref[k]).max())
            for k in keys}


def _l2(got, ref):
    keys = [k for k in _grad_keys(ref) if not k.endswith(ZERO_GRADIENT)]
    fa = np.concatenate([got[k].ravel() for k in keys])
    fb = np.concatenate([ref[k].ravel() for k in keys])
    return float(np.linalg.norm(fa - fb) / np.linalg.norm(fb))


def _stats_error(got, ref):
    return max(np.abs(got[k] - ref[k]).max() / np.abs(ref[k]).max()
               for k in ref if "running" in k)


def test_step_f32_matches_jax(steps):
    """The port's float32 step against the JAX `Trainer` step: the loss,
    every gradient leaf and the running statistics (module docstring)."""
    jl, jg = steps["jax32"]
    pl, pg, _ = steps["port32"]
    assert abs(pl - jl) <= 1e-5 * abs(jl)
    assert set(pg) == set(jg)
    for k, e in _leaf_errors(pg, jg).items():
        assert e <= (1e-5 if k.endswith(ZERO_GRADIENT) else 1e-4), (k, e)
    assert _stats_error(pg, jg) <= 1e-5


def test_adam_update_matches_grouped_optimizer(steps):
    """One Adam step (lr 1e-3) from the port's float32 gradients: the
    port's `torch.optim.Adam` groups against `GroupedOptimizer.update` on
    the same gradients, 1e-6 of each parameter's max."""
    from flax import traverse_util
    from infomax3d_tpu.train.torch_interop import convert_state_dict
    variables = steps["variables"]
    _, pg, step = steps["port32"]
    params = _jax_tree(variables["params"])
    flat = traverse_util.flatten_dict(variables["params"])
    out, _, report = convert_state_dict(
        {n: v for n, v in pg.items() if "running" not in n}, flat, {})
    assert report["missing"] == []
    grads = traverse_util.unflatten_dict(
        {k: jnp.asarray(v) for k, v in out.items()})
    labels, active = label_params(params)
    opt = GroupedOptimizer(labels, name="Adam", lr=OPT["lr"])
    lrs = np.zeros(4, np.float32)
    lrs[:2] = OPT["lr"]
    upd, _ = opt.update(grads, opt.init(params), params, lrs)
    want = params_from_jax(jax.tree_util.tree_map(
        lambda p, u: np.asarray(p + u), params, upd), {})
    step.optimizer.step()
    got = dict(step.model.named_parameters())
    for n, w in want.items():
        w = w.numpy()
        assert np.abs(got[n].detach().numpy() - w).max() <= \
            1e-6 * max(np.abs(w).max(), 1.0), n


# The bf16 check: a bf16 step's gradients held to a reference step's (see
# the module docstring for the readings these bounds sit between).
BF16_ZERO_FLOOR = 1e-4     # zero-gradient leaves, of the largest gradient
BF16_LEAF = 0.5            # each other leaf, of its own max
BF16_L2 = 0.3              # the whole gradient, L2


def _bf16_violations(got, ref):
    """What `got` (a bf16 step's gradients) breaks of the bf16 check
    against `ref`: a leaf without a finite gradient, a zero gradient where
    the leaf has one, a zero-gradient leaf above BF16_ZERO_FLOOR, a leaf
    off by more than BF16_LEAF, an L2 above BF16_L2."""
    keys = _grad_keys(ref)
    dead = [k for k in keys if got[k] is None
            or not np.isfinite(got[k]).all()
            or not (k.endswith(ZERO_GRADIENT) or np.abs(got[k]).max() > 0)]
    if dead:
        return [f"{k}: no finite non-zero gradient" for k in dead]
    bad = [f"{k}: {e:.3g}" for k, e in _leaf_errors(got, ref).items()
           if e > (BF16_ZERO_FLOOR if k.endswith(ZERO_GRADIENT)
                   else BF16_LEAF)]
    l2 = _l2(got, ref)
    return bad + ([f"L2 {l2:.3g}"] if l2 > BF16_L2 else [])


def test_step_bf16_matches_jax(steps):
    """The port's bf16 step against the JAX package's bf16 `Trainer` step:
    the loss, the running statistics and the bf16 check (module
    docstring)."""
    jl, jg = steps["jax16"]
    pl, pg, _ = steps["port16"]
    assert abs(pl - jl) <= 5e-3 * abs(jl)
    assert _stats_error(pg, jg) <= 1e-2
    assert _bf16_violations(pg, jg) == []


@pytest.mark.parametrize("fault", [None, "zeroed snd_segment_sum"])
def test_step_bf16_check_against_f32(batch, steps, monkeypatch, fault):
    """The bf16 check holds the port's bf16 step to its float32 step, and
    fails when the sender gather's backward returns zeros."""
    arr, b, _, _ = batch
    if fault:
        monkeypatch.setattr("infomax3d_tpu_torch.ops.segment.snd_segment_sum",
                            lambda ct, *a: torch.zeros(
                                b.n_nodes, ct.shape[1], dtype=ct.dtype))
    got = _port_step(arr, b, steps["variables"], torch.bfloat16)[1]
    bad = _bf16_violations(got, steps["port32"][1])
    assert bool(bad) == bool(fault), bad



def _perturbed(variables, rel, seed=7):
    """`variables` with every parameter scaled by 1 + rel * U(-1, 1)."""
    rng = np.random.default_rng(seed)
    return {"params": jax.tree_util.tree_map(
        lambda v: (v * (1 + rel * rng.uniform(-1, 1, v.shape))).astype(
            np.float32), variables["params"]),
        "batch_stats": variables["batch_stats"]}


def test_step_bf16_gap_is_rounding_sensitivity(batch, steps):
    """The witness for the bf16 gap: master weights perturbed by 2**-16
    relative (below bf16 resolution) move the bf16 step's gradient by a
    sizeable share of its distance from the float32 step, and the float32
    step's by far less (readings in the module docstring)."""
    arr, b, _, _ = batch
    pv = _perturbed(steps["variables"], 2.0 ** -16)
    moved = {dt: _l2(_port_step(arr, b, pv, dt)[1], steps[key][1])
             for dt, key in ((torch.bfloat16, "port16"), (None, "port32"))}
    gap = _l2(steps["port16"][1], steps["port32"][1])
    assert moved[torch.bfloat16] >= gap / 3, (moved, gap)
    assert moved[None] <= moved[torch.bfloat16] / 4, moved

# --- labels, the loss, the entry point --------------------------------------

@pytest.mark.parametrize("name", ["L1Loss", "MSELoss", "BCEWithLogitsLoss",
                                  "OGBNanLabelBCEWithLogitsLoss",
                                  "OGBNanLabelMSELoss"])
def test_supervised_loss_matches_jax(name):
    """Each loss name against `_elementwise_supervised_loss` (NaN labels
    and padding graphs masked), value and gradient, float32 1e-6."""
    rng = np.random.default_rng(6)
    pred = (rng.normal(size=(10, 3)) * 3).astype(np.float32)
    target = (rng.random((10, 3)) > 0.5).astype(np.float32)
    target[2, 1] = target[5, 0] = np.nan
    graph_mask = np.arange(10) < 8
    valid = ~np.isnan(target) & graph_mask[:, None]
    want, want_g = jax.value_and_grad(
        lambda x: _elementwise_supervised_loss(
            name, x, jnp.asarray(target), jnp.asarray(valid)))(
        jnp.asarray(pred))
    tp = _t(pred).requires_grad_()
    got = supervised_loss(name, tp, _t(target), _t(valid))
    got.backward()
    assert got.dtype == torch.float32
    np.testing.assert_allclose(float(got.detach()), float(want),
                               rtol=1e-6)
    np.testing.assert_allclose(tp.grad.numpy(), np.asarray(want_g),
                               rtol=1e-6, atol=1e-7)
    assert (tp.grad.numpy()[~valid] == 0).all()
    with pytest.raises(KeyError, match="unsupported"):
        supervised_loss("HuberLoss", tp, _t(target), _t(valid))


def test_labels_reach_the_loss_in_float32(batch, steps, monkeypatch):
    """Under the bf16 recipe `prepare` casts the batch's float fields but
    keeps the labels float32, and the loss reads them so; NaN labels and
    padding graphs do not count."""
    arr, b, _, _ = batch
    arr = dict(arr)
    arr["targets"] = arr["targets"].copy()
    arr["targets"][[1, 4]] = np.nan
    gb = dataclasses.replace(to_graph_batch(arr, b, "cpu"),
                             graph_mask=torch.arange(B) < B - 3)
    step = SupervisedStep("OGBGNN", MODEL, steps["variables"], "cpu",
                          torch.bfloat16, LOSS, OPT)
    g = step.prepare(gb)
    assert g.in_degree.dtype == torch.bfloat16
    assert g.targets.dtype == torch.float32
    seen = []
    import infomax3d_tpu_torch.train.supervised as sup
    real = sup.supervised_loss

    def spy(name, pred, target, valid):
        seen.append((pred.dtype, target.dtype, valid.clone()))
        return real(name, pred, target, valid)
    monkeypatch.setattr(sup, "supervised_loss", spy)
    loss = step.loss_and_grads(g)
    (pdt, tdt, valid), = seen
    assert pdt == tdt == torch.float32
    want = np.ones((B, 1), bool)
    want[[1, 4]] = False
    want[B - 3:] = False
    np.testing.assert_array_equal(valid.numpy(), want)
    assert np.isfinite(float(loss))
    assert all(p.grad is not None and torch.isfinite(p.grad).all()
               for p in step.model.parameters())


@pytest.mark.parametrize("option", [
    {"virtual_node": True}, {"gnn_type": "gcn"}, {"dropout": 0.5},
    {"residual": True}, {"JK": "sum"}, {"graph_pooling": "set2set"}])
def test_ogbgnn_refuses_unported_options(batch, option):
    """The options the port once refused now build and match the JAX
    `OGBGNN`'s eval forward from the same weights within 1e-5 of the
    output's max (the training step of each: tests/
    test_torch_port_gin_options.py); like the JAX module, `OGBGNN`
    defaults to a virtual node."""
    arr, b, _, jb = batch
    mp = {**JAX_MODEL, **option}
    params, stats = init_jax_variables(mp, 2, "OGBGNN")
    variables = {"params": params, "batch_stats": stats}
    model = OGBGNN.from_config({**MODEL, **option})
    model.load_state_dict(params_from_jax(params, stats))
    with torch.no_grad():
        got = model.eval()(to_graph_batch(arr, b, "cpu")).numpy()
    want = np.asarray(JaxOGBGNN(**mp).apply(_jax_tree(variables), jb,
                                            deterministic=True))
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()
    assert OGBGNN(hidden_dim=8, num_layers=1).node_gnn.virtual_node


def test_supervised_entry_point_on_cpu():
    """`supervised()` trains OGBGNN on the CPU when asked: finite losses
    that fall over 6 steps, the running statistics tracked once per step,
    the batch sizes; without `device` it needs the card."""
    args = dict(model_type="OGBGNN", model_parameters=MODEL, loss_func=LOSS,
                optimizer_params=OPT, batch_size=B, dataset_params=DATA,
                bf16_compute=False)
    out = supervised(args, steps=6, device="cpu")
    losses = out["losses"]
    assert len(losses) == 6 and np.isfinite(losses).all()
    assert losses[-1] < losses[0]
    bn = out["step"].model.node_gnn.batch_norms[0]
    assert int(bn.num_batches_tracked) == 6
    assert out["sizes"]["graphs"] == B
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            supervised(args, steps=1)
