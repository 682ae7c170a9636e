"""SAN on the CPU against the JAX package: the eval forward with the fake
channel (`full_graph`) on and off, one supervised step with dropout (the
flax masks replayed in its order) each way, the state_dict through the
JAX converter, and planted faults that the checks must catch.  Small
sizes: `configs/san.yml`'s model at width 16 (4 heads, 2 layers, LPE 4 x
1 layer with 2 heads, gamma 0.1 so that the fake channel weighs in),
readout min / max / mean / sum, 8 labelled molecules of 6 to 14 atoms on
`san_collate`'s dense batch with 16 atom slots and one padding graph;
every input from numpy seeds and `init_jax_variables`.

Tolerances, float32 on both sides (the worst reading on this data in
brackets):

* the forward: 1e-5 of the output's max over the real graphs
  [3.5e-7 / 1.4e-7 with / without the fake channel];
* the step as `test_torch_port_gin_options.check_step` (the loss 1e-5
  relative, the real graphs' predictions 1e-5, each gradient leaf 1e-4
  of its own max, the running statistics 1e-5, leaves the loss does not
  reach below 1e-5 of the largest gradient) [loss 4.9e-7, predictions
  1.3e-6, leaf 3.4e-6 / 8.0e-6, statistics 7.8e-7].

The planted faults (the fake channel scored on the real bonds' mask, the
clamp at +-5 dropped) each move the forward past its tolerance.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from infomax3d_tpu.data.loader import san_collate as jax_san_collate
from infomax3d_tpu.graphs.batch import BucketSpec as JaxBucket
from infomax3d_tpu.models import get_model_class as jax_model_class
from infomax3d_tpu_torch.data.loader import get_collate
from infomax3d_tpu_torch.graphs.batch import bucket_for
from infomax3d_tpu_torch.graphs.dense import to_dense_batch
from infomax3d_tpu_torch.interop import init_jax_variables, load_variables
from infomax3d_tpu_torch.models import san
from infomax3d_tpu_torch.models.registry import build_model
from test_torch_port_egnn import _dense_items, _round_trip
from test_torch_port_gin_options import (check_step, jax_step,
                                         labelled_graphs, port_step,
                                         step_errors)
from test_torch_port_ot import _jax_tree, _rel

B = 8
FWD_TOL = 1e-5
SAN = dict(GT_out_dim=16, readout_hidden_dim=10,
           readout_aggregators=["min", "max", "mean", "sum"], target_dim=1,
           gamma=0.1, GT_hidden_dim=16, GT_n_heads=4, GT_layers=2,
           LPE_n_heads=2, LPE_layers=1, LPE_dim=4, dropout=0.1,
           in_feat_dropout=0.1, batch_norm=True, batch_norm_momentum=0.1,
           readout_batchnorm=True, readout_layers=2, residual=True)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def dense():
    """(port DenseBatch, JAX DenseGraphBatch) of the same molecules."""
    mols = labelled_graphs(B, 1, seed=1, n_min=6, n_max=14)
    items = _dense_items(mols)
    got = get_collate("san_collate")(items, bucket_for(mols, B + 1),
                                     max_nodes=16)["graph"]
    want = jax_san_collate(items, JaxBucket(B + 1, 256, 512),
                           max_nodes=16)["graph"]
    return to_dense_batch(got, "cpu"), want


def _case(full_graph):
    mp = dict(SAN, full_graph=full_graph)
    var = dict(zip(("params", "batch_stats"),
                   init_jax_variables(mp, 3, "SAN")))
    return mp, var


def _forward_error(mp, var, g, jb) -> float:
    model = load_variables(build_model("SAN", mp), var).eval()
    with torch.no_grad():
        got = model(g).numpy()
    want = np.asarray(jax_model_class("SAN")(**mp).apply(
        {k: _jax_tree(v) for k, v in var.items()}, jb))
    real = g.graph_mask.numpy()
    return _rel(got[real], want[real])


@pytest.mark.parametrize("full_graph", [True, False],
                         ids=["full_graph", "real_bonds"])
def test_san_forward_and_step(dense, full_graph):
    """The eval forward (the flax init's shapes, the state_dict through
    the JAX converter), then one supervised L1 step with dropout against
    the JAX `Trainer.loss_fn`, the masks replayed; every parameter gets a
    gradient."""
    g, jb = dense
    mp, var = _case(full_graph)
    jm = jax_model_class("SAN")(**mp)
    shapes = jax.eval_shape(jm.init, jax.random.key(0), jb)
    for k in ("params", "batch_stats"):
        assert jax.tree_util.tree_map(np.shape, shapes[k]) == \
            jax.tree_util.tree_map(np.shape, var[k])
    _round_trip(load_variables(build_model("SAN", mp), var), var)
    assert _forward_error(mp, var, g, jb) <= FWD_TOL
    jout = jax_step(jm, var, jb, "L1Loss")
    # in_feat_dropout, then per layer the attention's and the FFN's
    assert len(jout[3]) == 1 + 2 * mp["GT_layers"]
    pout = port_step("SAN", mp, var, g, "L1Loss", jout[3])
    check_step(step_errors(jout, pout, g.graph_mask.numpy()))


def _fake_on_real_mask(monkeypatch):
    """The fake channel's scores on the real bonds' pairs, as the real
    channel's mask selects them."""
    real = san.SANAttention.forward

    def forward(self, g, h, e_real, e_fake):
        pair = g.node_mask[:, :, None] & g.node_mask[:, None, :]
        return real(self, dataclasses.replace(
            g, real_edge_mask=pair & ~g.real_edge_mask), h, e_real, e_fake)
    monkeypatch.setattr(san.SANAttention, "forward", forward)


def _clamp_dropped(monkeypatch):
    """The scores' clamp at +-5 dropped (they reach 34 to 103 here)."""
    monkeypatch.setattr(san, "SCORE_CLAMP", float("inf"))


@pytest.mark.parametrize("fault", [_fake_on_real_mask, _clamp_dropped],
                         ids=["fake_on_real_mask", "clamp_dropped"])
def test_forward_check_fails_planted_faults(dense, fault, monkeypatch):
    g, jb = dense
    mp, var = _case(True)
    fault(monkeypatch)
    # a fault may also overflow the scores: a NaN reading fails too
    assert not _forward_error(mp, var, g, jb) <= FWD_TOL
