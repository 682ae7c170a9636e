"""The harness finds a cell's files by name: a traffic mix, a configuration
and a per-layer metric dropped in as new files become a new cell and its
metrics, with no edit of a file that is there."""
import json
import shutil
import time

from bench_port import cell, manifest
from bench_port.tests.tiny import tiny_root


def test_dropped_in_files_make_a_cell(tmp_path, monkeypatch):
    bench_dir = tmp_path / "bench_port"
    shutil.copytree(manifest.BENCH, bench_dir,
                    ignore=shutil.ignore_patterns("__pycache__"))
    monkeypatch.setattr(manifest, "BENCH", str(bench_dir))
    root = tmp_path / "root"
    root.mkdir()
    tiny_root(root)
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
