"""The 3D side and the loss of the training slice against the JAX package:
`fourier_encode_dist`, `Net3DDense` (layout, eval and training forward,
gradients, bf16) and NT-Xent, at a small size (hidden 8, 16 molecules);
inputs from numpy seeds.

Tolerances:
* eval forward, float32: 1e-5 of max|ref| (measured 3.4e-7).
* training forward and gradients, float32: the JAX package's own float32
  error dominates.  XLA on the CPU sums the BatchNorm statistics over the
  ~10^4 pair rows sequentially (~2e-6 relative; torch ~4e-8), and one
  column of the message BatchNorm has mean^2 / var ~1.1e3 here, so XLA's
  variance there is 1.1e-2 off float64 (torch 2e-4, same activations).
  Measured against a float64 run of the port: JAX output 1.6e-3, JAX
  gradients up to 1.2e-2 of a leaf's max; the port 1.5e-5 and 1.2e-4.
  So: port against JAX at 5e-3 (output) and 3e-2 (gradients), and port
  against its own float64 run at 1e-4 and 1e-3.
* bf16 training forward: 5e-2 of max|ref| (both round at bf16 at other
  points; measured 1.2e-2).
* NT-Xent: 1e-5 (float32, the same formula).
"""
import dataclasses
import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util

from infomax3d_tpu.graphs.dense import dense_batch as jax_dense_batch
from infomax3d_tpu.graphs.dense import to_dense_batch as jax_dense
from infomax3d_tpu.losses import LOSS_REGISTRY
from infomax3d_tpu.models import Net3DDense as JaxNet3D
from infomax3d_tpu.models.net3d import _dense_readout
from infomax3d_tpu.ops.encodings import fourier_encode_dist as jax_fourier
from infomax3d_tpu.train.precision import cast_floats
from infomax3d_tpu_torch.data.synthetic import SyntheticMolecules
from infomax3d_tpu_torch.graphs.dense import dense_batch, to_dense_batch
from infomax3d_tpu_torch.interop import init_jax_variables, params_from_jax
from infomax3d_tpu_torch.losses import NTXent
from infomax3d_tpu_torch.models import Net3DDense
from infomax3d_tpu_torch.models.net3d import dense_readout
from infomax3d_tpu_torch.ops.encodings import fourier_encode_dist
from infomax3d_tpu_torch.train.precision import cast_batch, compute_params

# configs_clean/pre-train_QM9.yml `model3d_parameters` at hidden 8
MODEL3D = dict(target_dim=16, hidden_dim=8, hidden_edge_dim=8,
               node_wise_output_layers=0, message_net_layers=1,
               update_net_layers=1, reduce_func="mean", fourier_encodings=4,
               propagation_depth=1, dropout=0.0, batch_norm=True,
               readout_batchnorm=True, batch_norm_momentum=0.93,
               readout_hidden_dim=8, readout_layers=1,
               readout_aggregators=["min", "max", "mean"])
JAX_MODEL3D = {k: v for k, v in MODEL3D.items() if k != "hidden_edge_dim"}
B = 16


def _rel(got, ref):
    return float(np.abs(got - ref).max() / np.abs(ref).max())


@pytest.fixture(scope="module")
def case():
    ds = SyntheticMolecules(B, seed=0, n_min=10, n_max=26)
    mols = [ds.graph3d(i) for i in range(B)]
    nmax = max(m["node_feat"].shape[0] for m in mols)
    params, stats = init_jax_variables(MODEL3D, seed=2, model_type="Net3D")
    w = np.random.default_rng(3).normal(size=(B, 16)).astype(np.float32)
    return dict(g=to_dense_batch(dense_batch(mols, B, nmax), "cpu"),
                jg=jax_dense(jax_dense_batch(mols, B, nmax,
                                             with_edges=False)),
                params=params, stats=stats, w=w)


def _port(case, train=True, double=False):
    m = Net3DDense.from_config(MODEL3D)
    m.load_state_dict(params_from_jax(case["params"], case["stats"]),
                      strict=True)
    return (m.double() if double else m).train(train)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fourier_encoding_matches_jax(dtype):
    x = np.random.default_rng(0).uniform(0.0, 12.0, (5, 7)).astype(np.float32)
    want = jax_fourier(jnp.asarray(x, getattr(jnp, dtype)), 4)
    got = fourier_encode_dist(torch.from_numpy(x).to(getattr(torch, dtype)),
                              4)
    assert got.shape == (5, 7, 9) and got.dtype == getattr(torch, dtype)
    tol = 1e-6 if dtype == "float32" else 2.0 ** -7
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol)


def test_layout_names_and_config(case):
    """The numpy init has the flax layout of the JAX Net3DDense; the bare
    Dense (`soft_edge_network`) and bare parameter (`node_embedding`) get
    their torch names; the YAML's `hidden_edge_dim` is dropped."""
    v = JaxNet3D(**JAX_MODEL3D).init(jax.random.key(0), case["jg"])
    for ref, mine in ((v["params"], case["params"]),
                      (v["batch_stats"], case["stats"])):
        ref_f = traverse_util.flatten_dict(ref)
        mine_f = traverse_util.flatten_dict(mine)
        assert mine_f.keys() == ref_f.keys()
        for path in ref_f:
            assert mine_f[path].shape == ref_f[path].shape, path
    sd = params_from_jax(case["params"], case["stats"])
    assert sd["node_embedding"].shape == (8,)
    np.testing.assert_array_equal(
        sd["mp_layers.0.soft_edge_network.weight"].numpy(),
        case["params"]["mp_0"]["soft_edge_network"]["kernel"].T)
    m = _port(case)
    assert m.mp_layers[0].soft_edge_network.weight.shape == (1, 8)
    assert "hidden_edge_dim" not in inspect.signature(Net3DDense).parameters


def test_eval_forward_matches_jax(case):
    want = np.asarray(JaxNet3D(**JAX_MODEL3D).apply(
        {"params": case["params"], "batch_stats": case["stats"]},
        case["jg"], deterministic=True))
    with torch.no_grad():
        got = _port(case, train=False)(case["g"]).numpy()
    assert got.shape == (B, 16) and np.abs(want).max() > 0.5
    assert _rel(got, want) < 1e-5


def test_training_forward_and_grads_match_jax(case):
    net = JaxNet3D(**JAX_MODEL3D)
    w = case["w"]

    def lf(p):
        z, mut = net.apply({"params": p, "batch_stats": case["stats"]},
                           case["jg"], deterministic=False,
                           mutable=["batch_stats"])
        return (z * w).sum(), z

    (_, zj), gj = jax.value_and_grad(lf, has_aux=True)(
        jax.tree_util.tree_map(jnp.asarray, case["params"]))
    gj = {k: v.numpy() for k, v in params_from_jax(
        jax.tree_util.tree_map(np.asarray, gj), {}).items()}
    results = {}
    for double in (False, True):
        m = _port(case, double=double)
        g = case["g"]
        if double:
            g = dataclasses.replace(g, coords=g.coords.double())
        z = m(g)
        (z * torch.from_numpy(w).to(z.dtype)).sum().backward()
        results[double] = (z.detach().numpy(),
                           {n: p.grad.numpy() for n, p in
                            m.named_parameters()})
    (z32, g32), (z64, g64) = results[False], results[True]
    assert _rel(z32, np.asarray(zj)) < 5e-3
    assert _rel(z32, z64) < 1e-4
    gmax = max(np.abs(v).max() for v in g64.values())
    for n, ref in gj.items():
        if np.abs(g64[n]).max() < 1e-5 * gmax:   # Linear bias before BN
            continue
        assert np.abs(g32[n] - ref).max() <= 3e-2 * np.abs(ref).max(), n
        assert np.abs(g32[n] - g64[n]).max() <= \
            1e-3 * np.abs(g64[n]).max(), n


def test_bf16_training_forward_matches_jax(case):
    """The bf16 recipe: parameters and coordinates in bf16, BatchNorm
    statistics in float32; distances come from bf16 coordinates through
    the NaN-safe sqrt, and the gradients are finite."""
    net = JaxNet3D(**JAX_MODEL3D)
    pj = cast_floats(jax.tree_util.tree_map(jnp.asarray, case["params"]),
                     jnp.bfloat16)
    zj, _ = net.apply({"params": pj, "batch_stats": case["stats"]},
                      cast_floats(case["jg"], jnp.bfloat16),
                      deterministic=False, mutable=["batch_stats"])
    m = _port(case)
    g = cast_batch(case["g"], torch.bfloat16)
    assert g.coords.dtype == torch.bfloat16
    z = torch.func.functional_call(m, compute_params(m, torch.bfloat16),
                                   (g,))
    assert z.dtype == torch.bfloat16
    assert _rel(z.float().detach().numpy(), np.asarray(zj, np.float32)) < 5e-2
    z.float().sum().backward()
    for n, p in m.named_parameters():
        assert p.grad is not None and torch.isfinite(p.grad).all(), n
        assert p.grad.dtype == torch.float32


def test_dense_readout_matches_jax_with_ties():
    """min / max / mean over real atoms; tied maxima share the gradient
    evenly, as jnp.max does."""
    rng = np.random.default_rng(5)
    h = np.round(rng.normal(size=(4, 6, 3)) * 2).astype(np.float32)
    mask = np.ones((4, 6), bool)
    mask[1, 4:] = False
    mask[3] = False
    sizes = mask.sum(1)
    ct = rng.normal(size=(4, 9)).astype(np.float32)
    f = lambda x: (_dense_readout(x, jnp.asarray(mask),  # noqa: E731
                                  ["min", "max", "mean"],
                                  jnp.asarray(sizes)) * ct).sum()
    want, gwant = jax.value_and_grad(f)(jnp.asarray(h))
    th = torch.from_numpy(h).requires_grad_()
    got = (dense_readout(th, torch.from_numpy(mask), ["min", "max", "mean"],
                         torch.from_numpy(sizes)) * torch.from_numpy(ct)).sum()
    got.backward()
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
    np.testing.assert_allclose(th.grad.numpy(), np.asarray(gwant), rtol=1e-6,
                               atol=1e-6)


@pytest.mark.parametrize("reg", [{}, {"variance_reg": 0.5,
                                      "covariance_reg": 0.1,
                                      "uniformity_reg": 0.2}])
def test_ntxent_matches_jax(reg):
    rng = np.random.default_rng(6)
    z1, z2 = (rng.normal(size=(12, 16)).astype(np.float32) for _ in range(2))
    jl = LOSS_REGISTRY["NTXent"](tau=0.1, **reg)
    want, (g1, g2) = jax.value_and_grad(lambda a, b: jl(a, b),
                                        argnums=(0, 1))(jnp.asarray(z1),
                                                        jnp.asarray(z2))
    t1, t2 = (torch.from_numpy(z).requires_grad_() for z in (z1, z2))
    got = NTXent(tau=0.1, **reg)(t1, t2)
    got.backward()
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)
    for t, g in ((t1, g1), (t2, g2)):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(g), rtol=1e-5,
                                   atol=1e-5 * np.abs(np.asarray(g)).max())
