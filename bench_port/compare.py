"""The comparison that decides `correct`: the program's first training
steps against the reference's, by three numbers, each held to its limit
(`limits/<workload>.json`, which keeps the readings it was set from).

- ``loss_gap``: the largest relative gap of a step's loss, over the
  checked steps.
- ``out_gap``: the models' outputs at the first step (what the loss
  reads): the largest relative gap
  ``|z_program - z_reference| / |z_reference|`` over the models.
- ``change_gap``: each leaf's change over the checked steps (parameters
  and BatchNorm running statistics), by the worst leaf:
  ``| |d_program| - |d_reference| |`` over the larger of the reference
  leaf's norm and the median leaf's.

Two numbers of the first gradient as the optimizer got it are read and
not held: ``grad_gap``, its norms by the worst leaf (the same measure),
and ``grad_share_gap``, each leaf's norm as a share of the whole
gradient's norm, by the worst leaf.  At the weights' start both swing
with the forward's rounding: sound bf16 runs read up to 0.95 and 1.12,
the reference itself rounded to bf16 up to 0.33 and 0.31, and no limit
separates the control (PERF.md).  The backward is held through the signs
of Adam's first updates, in ``change_gap``.

Leaves whose reference gradient is under a thousandth of the median
leaf's (a bias that a BatchNorm cancels moves by round-off alone) are
left out of the leaf numbers; the running statistics are always in."""
from __future__ import annotations

import json
import os
from statistics import median
from typing import Dict, Mapping

import numpy as np

from bench_port import manifest

NEGLIGIBLE = 1e-3
NAMES = ("loss_gap", "out_gap", "change_gap")


def _worst_leaf(prog: Mapping[str, float], ref: Mapping[str, float],
                names) -> float:
    names = list(names)
    mid = median(ref[n] for n in names)
    return max(abs(prog[n] - ref[n]) / max(ref[n], mid, 1e-30)
               for n in names)


def _shares(norms: Mapping[str, float], names) -> Dict[str, float]:
    """Each leaf's norm over the norm of all `names` together."""
    total = sum(norms[n] ** 2 for n in names) ** 0.5
    return {n: norms[n] / max(total, 1e-30) for n in names}


def readings(prog: Mapping, ref: Mapping) -> Dict[str, float]:
    """The numbers of a program record against a reference record
    (`reference.run.ReferenceRun.record`'s layout)."""
    if set(prog["grad"]) != set(ref["grad"]) or \
            set(prog["change"]) != set(ref["change"]):
        raise ValueError("the program's leaves are not the reference's")
    losses = zip(prog["losses"], ref["losses"])
    pairs = list(zip(prog["outputs"], ref["outputs"]))
    # outputs of another shape (rows left out) are as wrong as can be
    out_gap = max(float(np.linalg.norm(p - r) / np.linalg.norm(r))
                  if p.shape == r.shape else float("inf") for p, r in pairs)
    mid = median(ref["grad"].values())
    kept = [n for n, g in ref["grad"].items() if g >= NEGLIGIBLE * mid]
    moved = kept + [n for n in ref["change"] if n not in ref["grad"]]
    return {"loss_gap": max(abs(p - r) / abs(r) for p, r in losses),
            "grad_gap": _worst_leaf(prog["grad"], ref["grad"], kept),
            "grad_share_gap": _worst_leaf(_shares(prog["grad"], kept),
                                          _shares(ref["grad"], kept), kept),
            "change_gap": _worst_leaf(prog["change"], ref["change"], moved),
            "out_gap": out_gap}


def leaf_gaps(prog: Mapping, ref: Mapping) -> Dict[str, float]:
    """The first gradient's median leaf gap and the whole gradient's gap of
    norms, beside its worst leaf, for reading a cell's calibration."""
    mid = median(ref["grad"].values())
    kept = [k for k, g in ref["grad"].items() if g >= NEGLIGIBLE * mid]
    m = median(ref["grad"][k] for k in kept)
    gaps = sorted(abs(prog["grad"][k] - ref["grad"][k])
                  / max(ref["grad"][k], m) for k in kept)
    total = [sum(r["grad"][k] ** 2 for k in kept) ** 0.5 for r in (prog, ref)]
    sp, sr = _shares(prog["grad"], kept), _shares(ref["grad"], kept)
    ms = median(sr.values())
    share = sorted(abs(sp[k] - sr[k]) / max(sr[k], ms) for k in kept)
    return {"grad_median": gaps[len(gaps) // 2],
            "grad_total": abs(total[0] - total[1]) / total[1],
            "grad_share_median": share[len(share) // 2]}


def worst_leaves(prog: Mapping, ref: Mapping, n: int = 4) -> Dict:
    """The `n` worst leaves of each leaf number, with both norms (for
    reading a cell's calibration)."""
    mid = median(ref["grad"].values())
    kept = [k for k, g in ref["grad"].items() if g >= NEGLIGIBLE * mid]
    out = {}
    for key, names in (("grad", kept), ("change", kept + [
            k for k in ref["change"] if k not in ref["grad"]])):
        m = median(ref[key][k] for k in names)
        rows = sorted(((abs(prog[key][k] - ref[key][k])
                        / max(ref[key][k], m, 1e-30), k, prog[key][k],
                        ref[key][k]) for k in names), reverse=True)[:n]
        out[key] = [[k, gap, p, r] for gap, k, p, r in rows]
    return out


def load_limits(workload: str) -> Dict[str, float]:
    with open(os.path.join(manifest.BENCH, "limits", f"{workload}.json")) as f:
        spec = json.load(f)
    return {n: float(spec[n]["limit"]) for n in NAMES}


def judge(read: Mapping[str, float], limits: Mapping[str, float]) -> Dict:
    """{name: {"value", "limit"}} of the held numbers, whether every one is
    within its limit (a NaN is not), and every reading."""
    checks = {n: {"value": read[n], "limit": limits[n]} for n in NAMES}
    ok = all(read[n] <= limits[n] for n in NAMES)
    return {"checks": checks, "correct": bool(ok), "readings": dict(read)}
