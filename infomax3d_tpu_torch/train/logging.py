"""Run logging (port of `infomax3d_tpu/train/logging.py`): JSONL always;
TensorBoard when `use_tensorboard` and `torch.utils.tensorboard` imports
(the reference's observability contract — scalars per split,
trainer/trainer.py:185-203 — with a machine-readable JSONL next to it)."""
from __future__ import annotations

import json
import os
import time
from typing import Dict

import numpy as np


class RunLogger:
    def __init__(self, run_dir: str, use_tensorboard: bool = True):
        self.run_dir = run_dir
        os.makedirs(run_dir, exist_ok=True)
        self._jsonl = open(os.path.join(run_dir, "metrics.jsonl"), "a")
        self._tb = None
        if use_tensorboard:
            try:
                from torch.utils.tensorboard import SummaryWriter
                self._tb = SummaryWriter(run_dir)
            except Exception:
                self._tb = None

    def log(self, metrics: Dict[str, float], split: str, step: int,
            epoch: int):
        rec = {"split": split, "step": int(step), "epoch": int(epoch),
               "time": time.time()}
        for k, v in metrics.items():
            try:
                rec[k] = float(v)
            except (TypeError, ValueError):
                continue
        self._jsonl.write(json.dumps(rec) + "\n")
        self._jsonl.flush()
        if self._tb is not None:
            for k, v in rec.items():
                if k in ("split", "time"):
                    continue
                try:
                    self._tb.add_scalar(f"{k}/{split}", float(v), step)
                except (TypeError, ValueError):
                    pass

    def log_spectrum(self, name: str, values, step: int, split: str):
        """Array-valued log record (figure hooks): always JSONL
        (`figures.jsonl`); a matplotlib line figure goes to TensorBoard
        when both import (reference add_figure, commons/utils.py:118-121)."""
        path = os.path.join(self.run_dir, "figures.jsonl")
        with open(path, "a") as f:
            f.write(json.dumps({"name": name, "split": split,
                                "step": int(step),
                                "values": [float(v) for v in values]}) + "\n")
        if self._tb is not None:
            try:
                import matplotlib
                matplotlib.use("Agg")
                import matplotlib.pyplot as plt
                for suffix, ys in ((name, values),
                                   (f"{name}_cumsum", np.cumsum(values))):
                    fig, ax = plt.subplots()
                    ax.plot(np.asarray(ys))
                    self._tb.add_figure(f"{suffix}/{split}", figure=fig,
                                        global_step=step)
                    plt.close(fig)
            except Exception:
                pass

    def close(self):
        self._jsonl.close()
        if self._tb is not None:
            self._tb.close()


class NullLogger:
    """`RunLogger`'s interface writing nothing: the data-parallel ranks
    other than rank 0 log nothing."""

    def log(self, *a, **kw):
        pass

    def log_spectrum(self, *a, **kw):
        pass

    def close(self):
        pass


def tensorboard_singular_value_plot(predictions, targets, logger: RunLogger,
                                    step: int, data_split: str):
    """Singular-value spectrum of the prediction / embedding matrix as % of
    the nuclear norm (reference `tensorboard_singular_value_plot`,
    commons/utils.py:113-124: torch.pca_lowrank == SVD of the centered
    matrix at q=min(shape))."""
    x = np.asarray(predictions, np.float64)
    if x.ndim == 1:
        x = x[:, None]
    x = x - x.mean(axis=0, keepdims=True)
    s = np.linalg.svd(x, compute_uv=False)
    total = s.sum()
    if total > 0:
        s = 100.0 * s / total
    logger.log_spectrum("singular_values", s, step, data_split)


# config key `tensorboard_functions: [singular_values]`
# (reference commons/utils.py:135-137 TENSORBOARD_FUNCTIONS)
TENSORBOARD_FUNCTIONS = {
    "singular_values": tensorboard_singular_value_plot,
}
