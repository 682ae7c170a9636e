"""Parameter names between the JAX package's flax trees and the port's
modules: `params_from_jax` loads strictly, and the JAX package's own
torch-name converter maps the port's state_dict back onto the flax tree."""
import jax
import numpy as np
import pytest
import torch
from flax import traverse_util

from infomax3d_tpu.graphs.batch import BucketSpec as JaxBucket
from infomax3d_tpu.graphs.batch import batch_graphs as jax_batch_graphs
from infomax3d_tpu.graphs.batch import to_graph_batch as jax_graph_batch
from infomax3d_tpu.models import PNA as JaxPNA
from infomax3d_tpu.train.torch_interop import convert_state_dict
from infomax3d_tpu_torch.data.synthetic import SyntheticMolecules
from infomax3d_tpu_torch.graphs.batch import bucket_for
from infomax3d_tpu_torch.interop import init_jax_variables, params_from_jax
from infomax3d_tpu_torch.models import PNA

MODEL = dict(target_dim=8, hidden_dim=16, mid_batch_norm=True,
             last_batch_norm=True, readout_batchnorm=True,
             batch_norm_momentum=0.93, readout_hidden_dim=24,
             readout_layers=2, propagation_depth=2,
             aggregators=["mean", "max", "min", "std"],
             scalers=["identity", "amplification", "attenuation"],
             readout_aggregators=["min", "max", "mean"], pretrans_layers=2,
             posttrans_layers=1)


@pytest.fixture(scope="module")
def jax_init():
    graphs = [SyntheticMolecules(6, seed=0).graph2d(i) for i in range(6)]
    b = bucket_for(graphs, 6)
    jg = jax_graph_batch(jax_batch_graphs(graphs, JaxBucket(
        b.n_graphs, b.n_nodes, b.n_edges, max_deg=b.max_deg, csr=True,
        nmax=b.nmax)))
    v = JaxPNA(**MODEL).init(jax.random.key(0), jg, deterministic=True)
    to_np = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
    return to_np(v["params"]), to_np(v["batch_stats"])


def test_params_from_jax_loads_strict(jax_init):
    params, stats = jax_init
    model = PNA(**MODEL)
    result = model.load_state_dict(params_from_jax(params, stats),
                                   strict=True)
    assert result.missing_keys == [] and result.unexpected_keys == []
    w = model.node_gnn.mp_layers[1].pretrans.fully_connected[0].linear.weight
    k = params["node_gnn"]["mp_1"]["pretrans"]["FCLayer_0"]["Dense_0"]["kernel"]
    np.testing.assert_array_equal(w.detach().numpy(), k.T)
    rv = model.output.fully_connected[0].batch_norm.running_var
    np.testing.assert_array_equal(
        rv.numpy(), stats["output"]["FCLayer_0"]["MaskedBatchNorm_0"]["var"])


def test_port_names_roundtrip_through_jax_converter(jax_init):
    params, stats = jax_init
    model = PNA(**MODEL)
    model.load_state_dict(params_from_jax(params, stats), strict=True)
    sd = {k: v.numpy() for k, v in model.state_dict().items()}
    flat_p = traverse_util.flatten_dict(params)
    flat_s = traverse_util.flatten_dict(stats)
    out_p, out_s, report = convert_state_dict(sd, flat_p, flat_s)
    assert report["missing"] == []
    assert report["unused"] == []
    for flat, out in ((flat_p, out_p), (flat_s, out_s)):
        assert out.keys() == flat.keys()
        for path, v in flat.items():
            np.testing.assert_array_equal(out[path], v, err_msg=str(path))


def test_numpy_init_has_the_flax_layout(jax_init):
    params, stats = jax_init
    mine_p, mine_s = init_jax_variables(MODEL, seed=3)
    for ref, mine in ((params, mine_p), (stats, mine_s)):
        ref_f = traverse_util.flatten_dict(ref)
        mine_f = traverse_util.flatten_dict(mine)
        assert mine_f.keys() == ref_f.keys()
        for path in ref_f:
            assert mine_f[path].shape == ref_f[path].shape, path
            assert mine_f[path].dtype == np.float32, path
    again_p, _ = init_jax_variables(MODEL, seed=3)
    for path, v in traverse_util.flatten_dict(mine_p).items():
        np.testing.assert_array_equal(
            traverse_util.flatten_dict(again_p)[path], v)


def test_exact_shapes_only(jax_init):
    params, stats = jax_init
    sd = params_from_jax(params, stats)
    key = "node_gnn.mp_layers.0.pretrans.fully_connected.0.batch_norm.weight"
    sd[key] = sd[key].reshape(1, -1)          # same size, other shape
    with pytest.raises(RuntimeError, match="size mismatch"):
        PNA(**MODEL).load_state_dict(sd, strict=True)
    with pytest.raises(KeyError, match="no torch name"):
        params_from_jax({"odd": {"leaf": np.zeros(2)}}, {})
    sd = params_from_jax(params, stats)
    assert sd[key.replace("weight", "num_batches_tracked")].dtype == \
        torch.long
