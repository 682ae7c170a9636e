"""No module of the harness or the reference has a forbidden top-level
name (compared whole: the port's name begins with the JAX package's), the
reference loads nothing of the port, and the check itself compares whole
names."""
import ast
import glob
import json
import os
import subprocess
import sys

from bench_port import cell, manifest

FILES = sorted(glob.glob(os.path.join(manifest.BENCH, "**", "*.py"),
                         recursive=True))


def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_sources_import_nothing_forbidden():
    for path in FILES:
        for name in _imports(path):
            assert name.split(".")[0] not in cell.FORBIDDEN, (path, name)


def test_reference_sources_import_no_port():
    """The reference's modules and its files found by name (models,
    losses, schedules) import only torch, numpy and the reference."""
    for path in glob.glob(os.path.join(manifest.BENCH, "reference", "**",
                                       "*.py"), recursive=True):
        for name in _imports(path):
            assert name.split(".")[0] in ("torch", "numpy", "math",
                                          "typing", "__future__",
                                          "bench_port"), (path, name)
            if name.startswith("bench_port"):
                assert name.startswith("bench_port.reference"), (path, name)


def test_whole_names():
    sys.modules["infomax3d_tpu_torch_probe"] = sys
    try:
        assert "infomax3d_tpu" not in cell.forbidden_modules()
    finally:
        del sys.modules["infomax3d_tpu_torch_probe"]
    sys.modules["infomax3d_tpu.probe"] = sys
    try:
        assert "infomax3d_tpu" in cell.forbidden_modules()
    finally:
        del sys.modules["infomax3d_tpu.probe"]


def test_reference_run_loads_no_port():
    """The reference trains a few steps in a fresh process, which then
    holds no module of the port and none of JAX."""
    code = """
import json, sys
sys.path.insert(0, %r)
import numpy as np, torch
from bench_port import manifest
from bench_port.molecules import MoleculePool
from bench_port.reference.run import ReferenceRun
from bench_port.weights import make_weights
config = {"model_type": "PNA", "model3d_type": "Net3D",
          "loss_func": "NTXentMultiplePositives", "loss_params": {"tau": 0.1},
          "optimizer_params": {"lr": 1e-3},
          "model_parameters": {"hidden_dim": 8, "target_dim": 4,
              "propagation_depth": 1, "aggregators": ["mean", "std"],
              "scalers": ["identity"], "readout_aggregators": ["mean"],
              "pretrans_layers": 1, "posttrans_layers": 1,
              "readout_layers": 1},
          "model3d_parameters": {"hidden_dim": 4, "target_dim": 4,
              "fourier_encodings": 2, "propagation_depth": 1,
              "readout_aggregators": ["mean"], "node_wise_output_layers": 0,
              "readout_layers": 1, "reduce_func": "mean"}}
pool = MoleculePool(5, {"n_min": 4, "n_max": 6, "coord_scale": 2.0,
                        "conformer_noise": 0.3}, 4, 2)
mols = [pool.molecule(i) for i in range(4)]
run = ReferenceRun(config, make_weights(config, 5, "cpu"),
                   manifest.reference_parts(config))
rec = run.run([run.batch(mols, "cpu")] * 2)
print(json.dumps(sorted({m.split(".")[0] for m in sys.modules})))
""" % manifest.ROOT
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    top = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert not top & set(cell.FORBIDDEN)
    assert "infomax3d_tpu_torch" not in top


def test_cli_refuses_without_cards():
    """Without the cell's CUDA cards the run exits non-zero and prints no
    result."""
    out = subprocess.run([sys.executable, os.path.join(manifest.BENCH,
                                                       "run.py"),
                          "--workload", "qmugs_c3_b500", "--seed", "1",
                          "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, timeout=300,
                         cwd=manifest.ROOT,
                         env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert out.returncode != 0
    assert out.stdout.strip() == ""
