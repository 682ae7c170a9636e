"""The harness finds a cell's files by name: a traffic mix, a configuration,
a per-layer metric, and the reference's model, loss and schedule files
dropped in as new files become new cells and their metrics, with no edit
of a file that is there."""
import json
import shutil
import time

import pytest

from bench_port import cell, faults, manifest
from bench_port.tests.tiny import tiny_root


def _copied_bench(tmp_path, monkeypatch):
    """A copy of the benchmark's folder, which the harness then reads, and
    a checkout root with the tiny `BENCHMARK.json`: (folder, root)."""
    bench_dir = tmp_path / "bench_port"
    shutil.copytree(manifest.BENCH, bench_dir,
                    ignore=shutil.ignore_patterns("__pycache__"))
    monkeypatch.setattr(manifest, "BENCH", str(bench_dir))
    root = tmp_path / "root"
    root.mkdir()
    tiny_root(root)
    return bench_dir, root


def test_dropped_in_files_make_a_cell(tmp_path, monkeypatch):
    bench_dir, root = _copied_bench(tmp_path, monkeypatch)
    traffic = json.loads((bench_dir / "workloads" /
                          "drug_size_closed.json").read_text())
    traffic.update(n_min=8, n_max=12)
    (bench_dir / "workloads" / "small_closed.json").write_text(
        json.dumps(traffic))
    (bench_dir / "limits" / "qmugs_small.json").write_text(
        (bench_dir / "limits" / "qmugs_c3_b500.json").read_text())
    (bench_dir / "metrics" / "window_steps.py").write_text(
        "def read(ctx):\n    return ctx['steps']\n")
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["workloads"].append({"name": "qmugs_small",
                               "config": "pretrain_qmugs",
                               "traffic": "small_closed", "chips": 1,
                               "why": "small molecules"})
    bench["per_layer"].append({"name": "window_steps", "unit": "steps",
                               "better": "higher",
                               "source": "program_counter",
                               "layer": "training loop (train/trainer.py)",
                               "moves": "train_graphs_per_s"})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    c = manifest.cell("qmugs_small", str(root))
    assert c.traffic["n_max"] == 12
    assert "window_steps" in c.per_layer
    out = cell.execute(cell.Options("qmugs_small", 1, 0.2, True,
                                    device="cpu", root=str(root)),
                       time.perf_counter())
    assert out["correct"]
    assert out["metrics"]["window_steps"]["value"] == out["attempted"]


# A supervised configuration (no 3D model): the port's trainer with its
# default flavour, L1 on one target, one linear warm-up phase.
SUPERVISED = """dataset: synthetic
batch_size: 8
log_iterations: 2
num_train: 32
loss_func: L1Loss
metrics: []
main_metric: loss
collate_function: graph_collate
optimizer: Adam
optimizer_params:
  lr: 1.0e-3
scheduler_step_per_batch: False
lr_scheduler: WarmUpWrapper
lr_scheduler_params:
  warmup_steps: [3]
use_tensorboard: False
"""
PNA = """model_type: PNA
model_parameters:
  target_dim: 1
  hidden_dim: 16
  mid_batch_norm: True
  last_batch_norm: True
  readout_batchnorm: True
  batch_norm_momentum: 0.93
  readout_hidden_dim: 16
  readout_layers: 2
  dropout: 0.0
  propagation_depth: 2
  aggregators: [mean, max, min, std]
  scalers: [identity, amplification, attenuation]
  readout_aggregators: [min, max, mean]
  pretrans_layers: 2
  posttrans_layers: 1
  residual: True
"""
GIN = """model_type: OGBGNN
model_parameters:
  target_dim: 1
  num_layers: 2
  hidden_dim: 16
  gnn_type: gin
  virtual_node: False
  residual: False
  dropout: 0.0
  JK: last
  graph_pooling: sum
"""
# the reference of a loss the benchmark had none of
L1_LOSS = '''"""L1 on the targets: the mean absolute error over [B, T]."""


def loss(params, outputs, batch):
    return (outputs["model"] - batch["targets"]).abs().mean()
'''
L1_FLOPS = '''def forward_flops(config, counts):
    return 0.0      # no matrix products
'''
# the reference of a registered port model the benchmark had none of:
# OGBGNN as GIN without a virtual node, jumping knowledge "last", sum
# pooling, dropout 0
GIN_MODEL = '''"""OGBGNN: GIN layers without a virtual node, sum pooling."""
import torch.nn.functional as F

from bench_port.reference.nn import (batch_norm_spec, embedding_spec,
                                     linear_spec)
from bench_port.reference.pna import ATOM_VOCAB, BOND_VOCAB
from bench_port.reference.views import bond_graphs


def shape(params):
    if params.get("virtual_node", True) or params.get("gnn_type") != "gin":
        raise NotImplementedError("GIN without a virtual node only")
    return {"D": int(params["hidden_dim"]), "T": int(params["target_dim"]),
            "layers": int(params["num_layers"])}


def spec(s):
    D, out = s["D"], []
    for i, v in enumerate(ATOM_VOCAB):
        out += embedding_spec(
            f"node_gnn.atom_encoder.atom_embedding_list.{i}", v, D)
    for l in range(s["layers"]):
        c = f"node_gnn.convs.{l}"
        for i, v in enumerate(BOND_VOCAB):
            out += embedding_spec(
                f"{c}.bond_encoder.bond_embedding_list.{i}", v, D)
        out += [(f"{c}.eps", (1,), "zeros", 0.0)]
        out += linear_spec(f"{c}.mlp.0", D, D)
        out += batch_norm_spec(f"{c}.mlp.1", D)
        out += linear_spec(f"{c}.mlp.3", D, D)
        out += batch_norm_spec(f"node_gnn.batch_norms.{l}", D)
    return out + linear_spec("graph_pred_linear", D, s["T"])


def view(s, mols, device):
    return bond_graphs(mols, device)


def forward(s, L, g):
    src, dst = g["senders"], g["receivers"]
    h = sum(L.embed(f"node_gnn.atom_encoder.atom_embedding_list.{i}",
                    g["atoms"][:, i]) for i in range(len(ATOM_VOCAB)))
    for l in range(s["layers"]):
        c = f"node_gnn.convs.{l}"
        e = sum(L.embed(f"{c}.bond_encoder.bond_embedding_list.{i}",
                        g["bonds"][:, i]) for i in range(len(BOND_VOCAB)))
        agg = h.new_zeros(h.shape).index_add(0, dst, F.relu(h[src] + e))
        z = (1.0 + L.P[f"{c}.eps"]) * h + agg
        z = L.linear(f"{c}.mlp.0", z)
        z = L.linear(f"{c}.mlp.3", F.relu(L.batch_norm(f"{c}.mlp.1", z)))
        h = L.batch_norm(f"node_gnn.batch_norms.{l}", z)
        if l < s["layers"] - 1:
            h = F.relu(h)
    pooled = h.new_zeros(g["n_graphs"], s["D"]).index_add(
        0, g["node_graph"], h)
    return L.linear("graph_pred_linear", pooled)
'''
GIN_FLOPS = '''def forward_flops(params, counts):
    D, T = int(params["hidden_dim"]), int(params["target_dim"])
    return (int(params["num_layers"]) * 2 * 2.0 * counts["nodes"] * D * D
            + 2.0 * counts["graphs"] * D * T)
'''
SUPERVISED_CELLS = {"pna_l1": PNA, "gin_l1": GIN}


@pytest.fixture
def supervised_root(tmp_path, monkeypatch):
    """A checkout root whose `BENCHMARK.json` adds two supervised cells,
    each of a configuration with no 3D model under a traffic with targets:
    PNA under L1 (a new loss) and OGBGNN under L1 (a new model type), from
    files dropped into the copied benchmark folder alone."""
    bench_dir, root = _copied_bench(tmp_path, monkeypatch)
    traffic = json.loads((bench_dir / "workloads" /
                          "drug_size_closed.json").read_text())
    traffic.update(n_min=8, n_max=12, targets=1)
    (bench_dir / "workloads" / "labelled_closed.json").write_text(
        json.dumps(traffic))
    (bench_dir / "reference" / "losses" / "L1Loss.py").write_text(L1_LOSS)
    (bench_dir / "flops" / "L1Loss.py").write_text(L1_FLOPS)
    (bench_dir / "reference" / "models" / "OGBGNN.py").write_text(GIN_MODEL)
    (bench_dir / "flops" / "OGBGNN.py").write_text(GIN_FLOPS)
    bench = json.loads((root / "BENCHMARK.json").read_text())
    for name, model in SUPERVISED_CELLS.items():
        (root / f"{name}.yml").write_text(SUPERVISED + model)
        (bench_dir / "limits" / f"{name}.json").write_text(
            (bench_dir / "limits" / "qmugs_c3_b500.json").read_text())
        bench["configs"].append({"name": name, "source": "a test",
                                 "file": f"{name}.yml", "reduced": [],
                                 "why": "supervised, no 3D model"})
        bench["workloads"].append({"name": name, "config": name,
                                   "traffic": "labelled_closed",
                                   "chips": 1, "why": "labelled molecules"})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return str(root)


@pytest.mark.parametrize("workload", sorted(SUPERVISED_CELLS))
def test_dropped_in_supervised_cell(supervised_root, workload):
    """A configuration with no 3D model, a new loss and, for `gin_l1`, a
    new model type runs through the port's supervised trainer against the
    reference and is correct, on the CPU."""
    out = cell.execute(cell.Options(workload, 2 ** 31 + 3, 0.2, True,
                                    device="cpu", root=supervised_root),
                       time.perf_counter())
    assert out["correct"], out["checks"]
    checks = {k: v["value"] for k, v in out["checks"].items()}
    assert checks["loss_gap"] < 1e-5 and checks["out_gap"] < 1e-4
    assert checks["change_gap"] < 0.05
    assert out["attempted"] >= 2
    assert out["metrics"]["step_mfu"]["value"] > 0


@pytest.mark.parametrize("fault", faults.FAULTS)
def test_dropped_in_supervised_cell_faults(supervised_root, fault):
    """Each planted fault makes the supervised cell not correct."""
    out = cell.execute(cell.Options("pna_l1", 11, 0.2, False, device="cpu",
                                    fault=fault, root=supervised_root),
                       time.perf_counter())
    assert not out["correct"], out["checks"]


def test_missing_reference_file_is_named():
    """A configuration whose model type has no reference file is refused
    by name, before any run."""
    config = {"model_type": "SMP", "model_parameters": {},
              "loss_func": "L1Loss"}
    with pytest.raises(NotImplementedError, match="no reference for SMP"):
        manifest.reference_parts(config)
