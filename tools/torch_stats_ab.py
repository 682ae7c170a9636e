#!/usr/bin/env python3
"""The two PNA-statistics kernels of the PyTorch/CUDA port (`pna_stats`,
`pna_stats_bwd`) measured in two trees of the repository on one card.

    python3 tools/torch_stats_ab.py PARENT_ROOT CHANGE_ROOT [SUMMARY_JSON]

runs, in the order parent, change, change, parent and each in a process
of its own, that tree's `chip_smoke.py` phases 1 to 3 and 7 (the kernels
built and held against their plain versions), 6 and 10 (cold-L2, warm and
plain device times), the bf16 pre-training step of phase 8 timed by CUDA
events over 20 warm steps, and phase 9 (its profile); then one more profile
of 5 warm steps gives the in-step device time of every `__global__` of the
two kernels (the wrapper's time split by kernel).  Each run's numbers end
in one JSON line; the summary goes to SUMMARY_JSON (default
`CHANGE_ROOT/build/stats_ab.json`).  Needs one CUDA card; the kernels of
each tree build into that tree's `build/`.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
from pathlib import Path

NEEDLES = ("pna_stats", "column_sums")
WRAPPERS = ("pna_stats", "pna_stats_bwd")


def one(root: str) -> dict:
    """One tree's measurements (run in a process of its own)."""
    root = str(Path(root).resolve())
    sys.path.insert(0, root)
    os.chdir(root)
    import torch
    from torch.profiler import ProfilerActivity, profile
    import chip_smoke as cs

    smi = cs.phase_device()
    cs.phase_build()
    g = cs.bench_batch()
    errs = cs.phase_kernels(g)
    errs.update(cs.phase_train_kernels(g))
    launches = {n: 0 for n in cs.NONE}
    rows = cs.phase_kernel_times(g, launches, errs)
    g2, g3, _ = cs.flagship_batches(cs.BATCH, seed=0, n_min=cs.DATA["n_min"],
                                    n_max=cs.DATA["n_max"])
    step = cs.build_step(cs._train_args(True), torch.device("cuda"))
    a, b = step.prepare(g2.to("cuda"), g3.to("cuda"))
    step_ms = cs.cuda_ms(lambda: step.step(a, b), iters=20)
    in_step = cs.phase_train_profile({"batches": (g2, g3),
                                      "step_ms": {True: step_ms}})
    rows += cs.phase_train_kernel_times(g, launches, errs, in_step)
    n = 5
    for _ in range(3):
        step.step(a, b)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            step.step(a, b)
        torch.cuda.synchronize()
    by_name = cs._profile_kernels(prof)
    split = {name: {"us_per_launch": us / cnt, "per_step": cnt / n}
             for name, (us, cnt) in by_name.items()
             if any(nd in name for nd in NEEDLES)}
    out = {"tree": root, "card": smi, "step_ms": step_ms,
           "kernels_per_step": sum(c for _, c in by_name.values()) / n,
           "busy_ms_per_step": sum(us for us, _ in by_name.values()) / n / 1e3,
           "in_step_ms": {k: in_step.get(k) for k in WRAPPERS},
           "globals": split,
           "rows": [r for r in rows if r["name"] in WRAPPERS]}
    for name, v in sorted(split.items()):
        print(f"[ab] __global__ {name[:90]}: {v['us_per_launch']:.3f} us per "
              f"launch in the step, {v['per_step']:.0f} per step")
    return out


def main(argv) -> int:
    if len(argv) == 3 and argv[1] == "--one":
        print(json.dumps(one(argv[2])))
        return 0
    if len(argv) not in (3, 4):
        print(__doc__)
        return 2
    parent, change = argv[1:3]
    summary = Path(argv[3] if len(argv) == 4
                   else Path(change) / "build" / "stats_ab.json")
    runs = []
    for tag, root in (("parent", parent), ("change", change),
                      ("change", change), ("parent", parent)):
        print(f"[ab] === {tag}: {root}", flush=True)
        proc = subprocess.run([sys.executable, __file__, "--one", root],
                              capture_output=True, text=True, timeout=900)
        print(proc.stdout[-12000:], flush=True)
        if proc.returncode != 0:
            print(proc.stderr[-6000:])
            return proc.returncode
        runs.append(dict(json.loads(proc.stdout.strip().splitlines()[-1]),
                         tag=tag))
    for r in runs:
        times = {row["name"]: (row["ms"], row["bound_ms"]) for row in r["rows"]}
        print(f"[ab] {r['tag']}: step {r['step_ms']:.4f} ms, "
              f"{r['kernels_per_step']:.0f} kernels per step, busy "
              f"{r['busy_ms_per_step']:.4f} ms; in step "
              + ", ".join(f"{k} {v if v is None else round(v, 6)} ms"
                          for k, v in r["in_step_ms"].items())
              + "; cold, bound " + ", ".join(
                  f"{k} {v[0]:.5f} / {v[1]:.5f} ms" for k, v in times.items()))
    summary.parent.mkdir(parents=True, exist_ok=True)
    summary.write_text(json.dumps(runs, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
