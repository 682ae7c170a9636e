"""The serving slice as a whole: the port's PNA eval forward against the JAX
package's, from one set of randomized weights, in float32 and bf16, plus
`inference()` on the CPU end to end.

The JAX side runs as its own tests run it on the CPU: the Pallas kernels in
interpret mode (f32: the multi-reduce kernel; bf16: the stats kernel, with
the edge combine on its gather fallback).

Tolerances (relative to max|reference| over real graphs):
* float32, 1e-4: both sides compute in float32; sums are taken in another
  order (the JAX kernel reduces through an incidence matmul), and the std
  aggregator's E[m^2] - mean^2 cancellation amplifies those last-bit
  differences (measured ~1.4e-5 at this size).
* bf16, 3e-2: both sides compute in bf16 but round at different points —
  the port's combine kernel rounds once where the JAX fallback rounds
  after each add, the weight folds and scaler products round differently —
  so each layer differs by a few bf16 ulps (2^-8 ~ 4e-3) and two layers
  plus the readout MLP accumulate them (measured ~1.1e-2, the same size as
  JAX bf16 against JAX f32).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from infomax3d_tpu.graphs.batch import BucketSpec as JaxBucket
from infomax3d_tpu.graphs.batch import batch_graphs as jax_batch_graphs
from infomax3d_tpu.graphs.batch import to_graph_batch as jax_graph_batch
from infomax3d_tpu.models import PNA as JaxPNA
from infomax3d_tpu.ops.segment import _graph_readout_dense
from infomax3d_tpu.train.precision import cast_floats
from infomax3d_tpu_torch.cli.inference import inference
from infomax3d_tpu_torch.data.synthetic import SyntheticMolecules
from infomax3d_tpu_torch.graphs.batch import (batch_graphs, bucket_for,
                                              to_graph_batch)
from infomax3d_tpu_torch.interop import init_jax_variables, params_from_jax
from infomax3d_tpu_torch.models import PNA
from infomax3d_tpu_torch.models.base import EdgeInput, FCLayer
from infomax3d_tpu_torch.ops.aggregate import use_stats_kernel
from infomax3d_tpu_torch.ops.segment import graph_readout_dense
from infomax3d_tpu_torch.train.precision import cast_parameters

F32_TOL = 1e-4
BF16_TOL = 3e-2

# every flagship option of configs_clean/pre-train_QM9.yml, at a small size
MODEL = dict(target_dim=16, hidden_dim=32, mid_batch_norm=True,
             last_batch_norm=True, readout_batchnorm=True,
             batch_norm_momentum=0.93, readout_hidden_dim=32,
             readout_layers=2, dropout=0.0, propagation_depth=2,
             aggregators=["mean", "max", "min", "std"],
             scalers=["identity", "amplification", "attenuation"],
             readout_aggregators=["min", "max", "mean"], pretrans_layers=2,
             posttrans_layers=1, residual=True)
DATA = dict(num=16, seed=3, n_min=10, n_max=26)


@pytest.fixture(scope="module")
def slice_case():
    ds = SyntheticMolecules(**DATA)
    graphs = [ds.graph2d(i) for i in range(len(ds))]
    b = bucket_for(graphs, len(graphs))
    arr = batch_graphs(graphs, b)
    jg = jax_graph_batch(jax_batch_graphs(graphs, JaxBucket(
        b.n_graphs, b.n_nodes, b.n_edges, max_deg=b.max_deg, csr=True,
        nmax=b.nmax)))
    params, stats = init_jax_variables(MODEL, seed=1)
    jm = JaxPNA(**MODEL)
    ref32 = np.asarray(jm.apply({"params": params, "batch_stats": stats},
                                jg, deterministic=True))
    pb = cast_floats(jax.tree_util.tree_map(jnp.asarray, params),
                     jnp.bfloat16)
    ref16 = np.asarray(jm.apply({"params": pb, "batch_stats": stats}, jg,
                                deterministic=True).astype(jnp.float32))
    return dict(arr=arr, bucket=b, params=params, stats=stats,
                ref32=ref32, ref16=ref16)


def _port_model(case, dtype=None):
    m = PNA(**MODEL)
    m.load_state_dict(params_from_jax(case["params"], case["stats"]),
                      strict=True)
    return cast_parameters(m.eval(), dtype)


def _rel_err(got, ref, mask):
    return float(np.abs(got - ref)[mask].max() / np.abs(ref[mask]).max())


def test_reference_outputs_are_not_trivial(slice_case):
    """Randomized weights and running statistics give O(1) outputs, so the
    relative tolerances below mean something."""
    mask = slice_case["arr"]["graph_mask"]
    assert np.abs(slice_case["ref32"][mask]).max() > 0.5
    assert np.isfinite(slice_case["ref32"]).all()


def test_pna_f32_matches_jax(slice_case):
    g = to_graph_batch(slice_case["arr"], slice_case["bucket"], "cpu")
    with torch.inference_mode():
        out = _port_model(slice_case)(g).numpy()
    assert out.dtype == np.float32 and out.shape == slice_case["ref32"].shape
    mask = slice_case["arr"]["graph_mask"]
    assert _rel_err(out, slice_case["ref32"], mask) < F32_TOL


def test_pna_bf16_matches_jax(slice_case):
    g = to_graph_batch(slice_case["arr"], slice_case["bucket"], "cpu")
    with torch.inference_mode():
        out = _port_model(slice_case, torch.bfloat16)(g)
    assert out.dtype == torch.bfloat16
    out = out.float().numpy()
    mask = slice_case["arr"]["graph_mask"]
    assert _rel_err(out, slice_case["ref16"], mask) < BF16_TOL
    assert _rel_err(out, slice_case["ref32"], mask) < BF16_TOL


def test_inference_cpu_end_to_end(slice_case, tmp_path):
    """`inference()` on the CPU: same molecules, same weights -> the JAX
    fingerprints; batching in smaller buckets changes nothing (eval-mode
    BatchNorm reads only running statistics); the file is saved."""
    args = dict(model_parameters=MODEL, bf16_compute="auto",
                dataset_params=DATA, batch_size=DATA["num"],
                jax_variables=dict(params=slice_case["params"],
                                   batch_stats=slice_case["stats"]),
                output_dir=str(tmp_path))
    fp = inference(args, device="cpu")
    mask = slice_case["arr"]["graph_mask"]
    ref = slice_case["ref32"][mask]
    assert fp.shape == ref.shape and fp.dtype == np.float32
    assert _rel_err(fp, ref, slice(None)) < F32_TOL
    np.testing.assert_array_equal(np.load(tmp_path / "fingerprints.npy"), fp)
    small = inference(dict(args, batch_size=5,
                           output_path=str(tmp_path / "b5.npy")),
                      device="cpu")
    np.testing.assert_allclose(small, fp, rtol=1e-5, atol=1e-5)
    # the same weights as a port state_dict
    sd_args = {k: v for k, v in args.items() if k != "jax_variables"}
    sd_args["state_dict"] = _port_model(slice_case).state_dict()
    np.testing.assert_array_equal(inference(sd_args, device="cpu"), fp)


def test_edge_input_layer_equals_concat_form():
    """The fused first pretrans layer equals Linear on the concatenation
    [h[senders] ‖ h[receivers] ‖ e] on every real edge (the sender block is
    the weight's first D columns)."""
    ds = SyntheticMolecules(6, seed=11)
    graphs = [ds.graph2d(i) for i in range(6)]
    b = bucket_for(graphs, 8)
    g = to_graph_batch(batch_graphs(graphs, b), b, "cpu")
    gen = torch.Generator().manual_seed(0)
    h = torch.randn(b.n_nodes, 12, generator=gen)
    e = torch.randn(b.n_edges, 5, generator=gen)
    fc = FCLayer(2 * 12 + 5, 7, activation="none").eval()
    with torch.no_grad():
        fc.linear.weight.normal_(generator=gen)
        fc.linear.bias.normal_(generator=gen)
        got = fc(EdgeInput(h, g.senders, g.receivers, e))
        e_real = int(g.csr_row_ptr[-1])
        s, r = g.senders[:e_real].long(), g.receivers[:e_real].long()
        want = F.linear(torch.cat([h[s], h[r], e[:e_real]], dim=1),
                        fc.linear.weight, fc.linear.bias)
    torch.testing.assert_close(got[:e_real], want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("aggs", [["min", "max", "mean"], ["sum", "max"]])
def test_readout_matches_jax(slice_case, aggs):
    arr = slice_case["arr"]
    rng = np.random.default_rng(4)
    h = rng.normal(size=(arr["node_feat"].shape[0], 8)).astype(np.float32)
    want = _graph_readout_dense(jnp.asarray(h), jnp.asarray(arr["rd_node_idx"]),
                                jnp.asarray(arr["rd_inv_flat"]), aggs,
                                jnp.asarray(arr["n_nodes"]))
    got = graph_readout_dense(torch.from_numpy(h),
                              torch.from_numpy(arr["rd_node_idx"]),
                              torch.from_numpy(arr["rd_inv_flat"]), aggs,
                              torch.from_numpy(arr["n_nodes"]))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)


@pytest.mark.parametrize("bf16", [False, True])
def test_aggregate_parts_match_jax(slice_case, bf16):
    """`pna_aggregate_parts` against the JAX `pna_csr_aggregate_parts` on
    aggregators the flagship does not use (sum, var), with the scalers and
    a folded affine; the JAX scaled parts are materialized.  Tolerances:
    float32 1e-5 (sum order); bf16 one bf16 ulp (2**-7 relative, see
    test_torch_port_kernels.py) on every block."""
    from infomax3d_tpu.models.base import AffinePart as JaxAffine
    from infomax3d_tpu.models.base import ScaledPart
    from infomax3d_tpu.ops.pallas.spmm import pna_csr_aggregate_parts
    from infomax3d_tpu_torch.ops.aggregate import (AffinePart,
                                                   pna_aggregate_parts)
    arr, b = slice_case["arr"], slice_case["bucket"]
    rng = np.random.default_rng(6)
    D = 24
    x = rng.normal(size=(b.n_edges, D)).astype(np.float32)
    a = rng.uniform(0.5, 1.5, D).astype(np.float32)
    s = rng.normal(0.0, 0.3, D).astype(np.float32)
    jdt, tdt = (jnp.bfloat16, torch.bfloat16) if bf16 else \
        (jnp.float32, torch.float32)
    x = np.array(jnp.asarray(x, jdt).astype(jnp.float32))
    aggs = ["sum", "mean", "var", "max"]
    scalers = ["identity", "amplification", "attenuation"]
    want = pna_csr_aggregate_parts(
        JaxAffine(jnp.asarray(x, jdt), jnp.asarray(a), jnp.asarray(s)),
        jnp.asarray(arr["csr_row_ptr"]), jnp.asarray(arr["receivers"]),
        b.max_deg, aggs, scalers, 1.0, interpret=True)
    want = [p.row_scale * p.x if isinstance(p, ScaledPart) else p
            for p in want]
    g = to_graph_batch(arr, b, "cpu")
    got = pna_aggregate_parts(
        g, AffinePart(torch.from_numpy(x).to(tdt), torch.from_numpy(a),
                      torch.from_numpy(s)), aggs, scalers)
    assert len(got) == len(want) == 12
    tol = 2.0 ** -7 if bf16 else 1e-5
    for i, (gp, wp) in enumerate(zip(got, want)):
        assert gp.dtype == tdt
        np.testing.assert_allclose(gp.float().numpy(),
                                   np.asarray(wp, np.float32), rtol=tol,
                                   atol=1e-5, err_msg=f"block {i}")


def test_aggregation_dispatch():
    """bf16 with max_deg <= 16 -> fused stats kernel; float32 or a wider
    degree bound -> multi-reduce (the JAX package's `_use_stats_kernel`)."""
    x = torch.zeros(4, 8)
    assert use_stats_kernel(x.bfloat16(), 4)
    assert use_stats_kernel(x.bfloat16(), 16)
    assert not use_stats_kernel(x.bfloat16(), 17)
    assert not use_stats_kernel(x, 4)
