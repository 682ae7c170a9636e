#!/usr/bin/env python3
"""Data parallelism over NCCL with one rank per card of one host:
`chip_smoke.py`'s phase 27 (`phase_data_parallel`) with as many ranks as
the host has cards, NCCL in place of gloo for the steps, the planted
faults and the training CLI.

    python3 tools/dp_nccl.py            # needs 2 or more CUDA cards
    python3 tools/dp_nccl.py --only 29  # phase 29 alone (4 cards)

Each rank takes its 1/k of phase 8's 500-molecule pre-training batch and
of phase 12's 128-molecule GIN batch.  It prints what phase 27 prints: the
k-rank steps against one process on the whole batch (float32 within
STEP_TOL, bf16 within the witnesses' limits), the planted faults, the
all-reduce and all-gather calls of a step with their host milliseconds,
ms per bf16 step with one card per rank beside one process on the whole
batch, and the CLI's run under torchrun's environment; then the CLI's run
with the ranks it starts itself (NCCL, its default backend); then phase
28's partitioned modes (c) with one NCCL rank per card, `graph_shards: k`
and `node_shards: k` of the flat pre-training step against one process
on the whole non-CSR batch (with (b), which gives that one-process step);
then phase 29's tensor parallelism with one NCCL rank per card:
`model_shards: k` alone on the whole batch (its planted faults, bytes per
rank, shard gathers and ms per step), `n_shards: 2` x `model_shards: k/2`
against one process on the whole batch, and the CLI with `model_shards:
k` under torchrun's environment; and every card's name and power limit.
"""
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402


def main() -> int:
    smi = cs.phase_device()
    k = torch.cuda.device_count()
    if k < 2:
        raise SystemExit(f"NCCL data parallelism needs 2 or more cards, "
                         f"found {k}")
    cs.phase_build()
    only = sys.argv[sys.argv.index("--only") + 1] \
        if "--only" in sys.argv else None
    if only not in (None, "29"):
        raise SystemExit(f"--only {only}: 29 is the phase run alone")
    if k % 2:
        raise SystemExit(f"phase 29's grid is 2 x k / 2: {k} cards")
    out = ROOT / "build" / "dp_nccl"
    out.mkdir(parents=True, exist_ok=True)
    if only is None:
        _phases_27_28(smi, k, out)
    spec29 = cs._tp_spec()
    spec29.update(ranks=k, alone=k, backend="nccl")
    config29, over29 = spec29["cli"]
    spec29["cli"] = (config29, dict(over29, model_shards=k,
                                    dist_backend="nccl"))
    with cs._Phase(f"29 tensor parallelism, {k} cards, NCCL"):
        cs.phase_slice22(smi, out, spec=spec29)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True, timeout=60).stdout.strip())
    return 0


def _phases_27_28(smi: str, k: int, out: Path) -> None:
    spec = cs._dp_spec()
    spec.update(ranks=k, backend="nccl")
    config, overrides = spec["cli"]
    spec["cli"] = (config, dict(overrides, n_shards=k, dist_backend="nccl"))
    with cs._Phase(f"27 data parallel, {k} cards, NCCL"):
        cs.phase_data_parallel(smi, out, spec)
    from infomax3d_tpu_torch.cli.config import load_config
    from infomax3d_tpu_torch.cli.train import train
    over = dict(overrides, n_shards=k, logdir=str(out / "cli_spawn"))
    del over["dist_backend"]
    t0 = time.perf_counter()
    result = train(load_config(config, over))
    loss = next(key for key in result if "NTXent" in key)
    print(f"[dp-nccl] CLI {config} with n_shards {k}, the ranks started by "
          f"the CLI (NCCL, one card each): {time.perf_counter() - t0:.1f} "
          f"s, {loss} {result[loss]:.6f}")
    spec21 = cs._s21_spec()
    spec21.update(ranks=k, backend="nccl")
    with cs._Phase(f"28 (b, c) non-CSR batch and partitions, {k} cards, "
                   f"NCCL"):
        b = cs._s21_noncsr(spec21, smi)
        cs._s21_partitions(spec21, b, out, smi)


if __name__ == "__main__":
    sys.exit(main())
