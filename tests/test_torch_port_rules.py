"""Rules the port lives by: no JAX (nor the JAX package, nor YAML, msgpack
or networkx) at run time, also where it serves from a JAX checkpoint, no
silent CPU fallback, kernels dispatch by
device, and `chip_smoke.py` serves and trains the models of
`configs_clean/pre-train_QM9.yml` and trains those of `configs/30.yml` and
`configs_clean/pre-train_Optimal_Transport_baseline.yml`."""
import ast
import importlib.util
import json
import subprocess
import sys
from pathlib import Path

import pytest
import torch
import yaml

from infomax3d_tpu_torch.cli.inference import inference
from infomax3d_tpu_torch.graphs.batch import batch_graphs, bucket_for
from infomax3d_tpu_torch.data.synthetic import SyntheticMolecules
from infomax3d_tpu_torch.ops.kernels import (WRAPPERS, csr_segment_sum,
                                             csr_segment_sum_reference,
                                             csr_sum,
                                             csr_sum_reference, edge_combine,
                                             edge_combine_reference,
                                             multi_reduce,
                                             multi_reduce_reference,
                                             pna_stats, pna_stats_reference,
                                             snd_segment_sum,
                                             snd_segment_sum_reference)

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "infomax3d_tpu_torch"
FORBIDDEN = ("jax", "flax", "infomax3d_tpu", "yaml", "msgpack", "networkx")

TINY = dict(target_dim=4, hidden_dim=8, mid_batch_norm=True,
            last_batch_norm=True, readout_batchnorm=True,
            readout_hidden_dim=8, readout_layers=2, propagation_depth=1,
            aggregators=["mean", "max", "min", "std"],
            scalers=["identity", "amplification", "attenuation"],
            readout_aggregators=["min", "max", "mean"], pretrans_layers=2,
            posttrans_layers=1)


def _forbidden(name: str) -> bool:
    # dotted prefixes: the port's own name starts with "infomax3d_tpu"
    return any(name == f or name.startswith(f + ".") for f in FORBIDDEN)


TINY_GIN = dict(target_dim=1, num_layers=2, hidden_dim=8, dropout=0.0,
                emb_dim=8, virtual_node=False)

TINY_OT = {"gnn_model": "PNAGNNRandomEdgeUpdate",
           "gnn_params": dict(hidden_dim=8, propagation_depth=1,
                              aggregators=["sum"], scalers=["identity"],
                              pretrans_layers=2, posttrans_layers=2),
           "hyperparams": dict(hidden_dim=8, random_vec_dim=2,
                               random_vec_std=1.0, loss_type="ot_emd",
                               n_model_confs=2, n_true_confs=2)}

TINY3D = dict(target_dim=4, hidden_dim=4, hidden_edge_dim=4,
              node_wise_output_layers=0, message_net_layers=1,
              update_net_layers=1, reduce_func="mean", fourier_encodings=2,
              propagation_depth=1, batch_norm=True, readout_layers=1,
              readout_aggregators=["min", "max", "mean"])


def test_runtime_imports_no_jax(tmp_path):
    code = f"""
import json, sys
import infomax3d_tpu_torch
from infomax3d_tpu_torch.cli.inference import inference
from infomax3d_tpu_torch.train.pretrain import pretrain
fp = inference({{"model_parameters": {TINY!r}, "batch_size": 4,
                "dataset_params": {{"num": 6, "seed": 0}},
                "output_dir": {str(tmp_path)!r}}}, device="cpu")
assert fp.shape == (6, 4), fp.shape
out = pretrain({{"model_parameters": {TINY!r},
                "model3d_parameters": {TINY3D!r}, "batch_size": 6,
                "bf16_compute": True}}, steps=1, device="cpu")
assert len(out["losses"]) == 1, out
from infomax3d_tpu_torch.train.supervised import supervised
out = supervised({{"model_type": "OGBGNN", "model_parameters": {TINY_GIN!r},
                   "loss_func": "BCEWithLogitsLoss", "batch_size": 6,
                   "bf16_compute": True}}, steps=1, device="cpu")
assert len(out["losses"]) == 1, out
from infomax3d_tpu_torch.train.ot import ot
out = ot({{"model_parameters": {TINY_OT!r}, "batch_size": 3,
          "dataset_params": {{"n_min": 5, "n_max": 9}}}}, steps=1,
         device="cpu")
assert len(out["losses"]) == 1, out
from infomax3d_tpu_torch.cli.analysis import singular_value_spectrum
from infomax3d_tpu_torch.cli.config import load_config
fx = "tests/fixtures/jax_serving"
fp = inference(load_config(None, {{
    "checkpoint": fx + "/best_checkpoint.pt",
    "smiles_txt_path": fx + "/smiles.txt",
    "output_dir": {str(tmp_path)!r}}}), device="cpu")
assert singular_value_spectrum(fp).shape == (64,), fp.shape
print(json.dumps(sorted(sys.modules)))
"""
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, text=True,
                         capture_output=True, timeout=300)
    assert out.returncode == 0, out.stderr
    mods = json.loads(out.stdout.strip().splitlines()[-1])
    for m in ("ops.kernels.pna_stats", "ops.kernels.pna_stats_bwd",
              "ops.kernels.pair_segment_sum", "models.net3d",
              "losses.contrastive", "train.optim", "train.pretrain",
              "ops.kernels.csr_sum", "ops.kernels.snd_segment_sum",
              "models.gin", "train.supervised",
              "ops.kernels.csr_segment_sum", "data.geomol_featurize",
              "data.loader", "models.optimal_transport", "train.ot",
              "train.flax_msgpack", "train.torch_interop", "cli.analysis"):
        assert f"infomax3d_tpu_torch.{m}" in mods, m
    assert [m for m in mods if _forbidden(m)] == []


def _imports(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", sorted(PORT.rglob("*.py"))
                         + [ROOT / "chip_smoke.py",
                            ROOT / "tools" / "torch_stats_ab.py"],
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_source_imports_no_jax(path):
    bad = [m for m in _imports(path) if _forbidden(m)]
    assert bad == [], f"{path.name} imports {bad}"


def test_inference_without_device_raises_without_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        inference({"model_parameters": TINY})


def _csr(num=5, D=16):
    graphs = [SyntheticMolecules(num, seed=1).graph2d(i) for i in range(num)]
    b = bucket_for(graphs, num)
    arr = batch_graphs(graphs, b)
    gen = torch.Generator().manual_seed(0)
    N, E = b.n_nodes, b.n_edges
    return (torch.from_numpy(arr["receivers"]),
            torch.from_numpy(arr["senders"]),
            torch.from_numpy(arr["csr_row_ptr"]), b.max_deg,
            lambda *s: torch.randn(*s, generator=gen), N, E, D)


def _csc(num=5):
    graphs = [SyntheticMolecules(num, seed=1).graph2d(i) for i in range(num)]
    arr = batch_graphs(graphs, bucket_for(graphs, num))
    return (torch.from_numpy(arr["csc_row_ptr"]),
            torch.from_numpy(arr["csc_perm"]))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_wrappers_on_cpu_use_plain_version(dtype):
    recv, send, rp, K, randn, N, E, D = _csr()
    before = {n: w.launches for n, w in WRAPPERS.items()}
    hd, hs, pe = (randn(N, D).to(dtype), randn(N, D).to(dtype),
                  randn(E, D).to(dtype))
    assert torch.equal(edge_combine(hd, hs, pe, recv, send),
                       edge_combine_reference(hd, hs, pe, recv, send))
    x = randn(E, D).to(dtype)
    for k, r in zip(multi_reduce(x, rp, K), multi_reduce_reference(x, rp, K)):
        assert torch.equal(k, r)
    assert torch.equal(csr_sum(x, rp), csr_sum_reference(x, rp))
    crp, perm = _csc()
    assert torch.equal(snd_segment_sum(x, crp, perm),
                       snd_segment_sum_reference(x, crp, perm))
    assert torch.equal(csr_segment_sum(x, rp),
                       csr_segment_sum_reference(x, rp))
    if dtype == torch.bfloat16:
        aff = (torch.ones(D), torch.zeros(D))
        for k, r in zip(pna_stats(x, rp, K, aff, False),
                        pna_stats_reference(x, rp, K, aff, False)):
            assert (k is None and r is None) or torch.equal(k, r)
    assert {n: w.launches for n, w in WRAPPERS.items()} == before


def test_wrappers_reject_other_devices():
    recv, send, rp, K, randn, N, E, D = _csr()
    meta = torch.empty(E, D, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        edge_combine(meta[:N], meta[:N], meta, recv, send)
    with pytest.raises(ValueError, match="unsupported device"):
        multi_reduce(meta, rp, K)
    with pytest.raises(ValueError, match="unsupported device"):
        csr_sum(meta, rp)
    with pytest.raises(ValueError, match="unsupported device"):
        snd_segment_sum(meta, *_csc())
    with pytest.raises(ValueError, match="unsupported device"):
        csr_segment_sum(meta, rp)


def test_chip_smoke_serves_the_flagship_config():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    chip_smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip_smoke)
    with open(ROOT / "configs_clean" / "pre-train_QM9.yml") as f:
        cfg = yaml.safe_load(f)
    assert chip_smoke.MODEL_PARAMETERS == cfg["model_parameters"]
    assert cfg["model_type"] == "PNA"
    assert chip_smoke.MODEL3D_PARAMETERS == cfg["model3d_parameters"]
    assert cfg["model3d_type"] == "Net3D"
    assert chip_smoke.LOSS_PARAMS == cfg["loss_params"]
    assert cfg["loss_func"] == "NTXent"
    assert chip_smoke.OPTIMIZER_PARAMS == cfg["optimizer_params"]
    assert cfg["optimizer"] == "Adam"
    assert chip_smoke.BATCH == cfg["batch_size"]


def test_chip_smoke_trains_config_30():
    """Phase 12 trains `configs/30.yml`'s model, loss, optimizer and batch
    size as the file states them."""
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    chip_smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip_smoke)
    with open(ROOT / "configs" / "30.yml") as f:
        cfg = yaml.safe_load(f)
    assert chip_smoke.GIN_MODEL_PARAMETERS == cfg["model_parameters"]
    assert chip_smoke.GIN_MODEL_TYPE == cfg["model_type"] == "OGBGNN"
    assert chip_smoke.GIN_LOSS == cfg["loss_func"]
    assert chip_smoke.GIN_OPTIMIZER_PARAMS == cfg["optimizer_params"]
    assert cfg["optimizer"] == "Adam"
    assert chip_smoke.GIN_BATCH == cfg["batch_size"]


def test_chip_smoke_trains_the_ot_config():
    """Phase 15 trains `configs_clean/pre-train_Optimal_Transport_baseline.
    yml`'s model, optimizer and batch size as the file states them."""
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    chip_smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip_smoke)
    with open(ROOT / "configs_clean" /
              "pre-train_Optimal_Transport_baseline.yml") as f:
        cfg = yaml.safe_load(f)
    assert chip_smoke.OT_MODEL_PARAMETERS == cfg["model_parameters"]
    assert cfg["model_type"] == "OptimalTransportModel"
    assert cfg["trainer"] == "optimal_transport"
    assert chip_smoke.OT_OPTIMIZER_PARAMS == cfg["optimizer_params"]
    assert cfg["optimizer"] == "Adam"
    assert chip_smoke.OT_BATCH == cfg["batch_size"]
