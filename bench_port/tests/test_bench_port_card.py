"""On the card: a short run of the one-card cell at its own size is
correct and reports its metrics (run on the chip:
``python -m pytest bench_port/tests -q -n 0 -m card``)."""
import time

import pytest

from bench_port import cell, manifest


@pytest.mark.card
def test_one_card_cell_is_correct(card):
    one = [w["name"] for w in manifest.load()["workloads"]
           if w["chips"] == 1]
    opts = cell.Options(one[0], 2 ** 31 + 99, 5.0, False)
    out = cell.execute(opts, time.perf_counter())
    assert out["correct"], out["checks"]
    assert out["device"]["platform"] == "gpu"
    assert "train_graphs_per_s" in out["metrics"]
