"""Runs with the timed path broken underneath come out not correct: each
fault the cell can have (`faults.py`), planted in a whole run on the CPU
at tiny widths (the harness's look for a card skipped), is held to the
cell's own limits."""
import time

import pytest

from bench_port import cell, faults
from bench_port.tests.tiny import tiny_root


@pytest.mark.parametrize("fault", faults.FAULTS)
def test_fault_is_not_correct(tmp_path, fault):
    opts = cell.Options("qmugs_c3_b500", 11, 0.2, False, device="cpu",
                        fault=fault, root=tiny_root(tmp_path))
    out = cell.execute(opts, time.perf_counter())
    assert not out["correct"], out["checks"]
    if fault == "unchanged_state":
        assert out["checks"]["change_gap"]["value"] >= 0.99
