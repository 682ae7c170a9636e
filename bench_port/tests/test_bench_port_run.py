"""Whole runs of each cell on the CPU at tiny widths (`tiny.py`): the
port's trainer through set-up, the checked steps, the window and a traced
period, against the plain reference; every number agrees within float32
rounding, and the result line has the contract's keys."""
import time

import pytest

from bench_port import cell, manifest
from bench_port.tests.tiny import tiny_root

CELLS = [w["name"] for w in manifest.load()["workloads"]]


@pytest.mark.parametrize("trace", [False, True])
@pytest.mark.parametrize("workload", CELLS)
def test_cell_agrees_with_reference(tmp_path, workload, trace):
    opts = cell.Options(workload, 2 ** 31 + 7, 0.5, trace, device="cpu",
                        root=tiny_root(tmp_path))
    out = cell.execute(opts, time.perf_counter())
    assert out["correct"], out["checks"]
    checks = {k: v["value"] for k, v in out["checks"].items()}
    assert checks["loss_gap"] < 1e-5
    assert checks["out_gap"] < 1e-4
    assert checks["change_gap"] < 0.05
    assert out["readings"]["grad_share_gap"] < 1e-3
    assert list(out)[-1] == "checks"
    assert cell.forbidden_modules() == []
    c = manifest.cell(workload, opts.root)
    want = c.per_layer if trace else c.end_to_end
    # the device metrics read nothing on the CPU
    cpu_silent = {"peak_mem_gib", "kernel_roofline_share", "step_device_ms"}
    assert set(want) - cpu_silent <= set(out["metrics"]) <= set(want)
    assert out["attempted"] >= 2 and out["device"]["count"] == c.chips
    if trace:
        assert out["device"]["window_s"] > 0
        assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}
