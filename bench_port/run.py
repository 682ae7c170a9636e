"""The port's benchmark: one cell of BENCHMARK.json per run.

    python3 bench_port/run.py --workload qmugs_c3_b500 --seed 7 --seconds 20 --trace 0

Run from the root of a checkout on a machine with the cell's CUDA cards.
Prints the checks, each number beside its limit, as the last lines of
standard error, and one JSON object as the last line of standard output.
Exits 2 without a result where CUDA or the cell's cards are missing, and 1
where a forbidden module (JAX, the JAX package) was loaded."""
import time

T0 = time.perf_counter()     # set-up counts from the process's start

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = p.parse_args(argv)
    import torch
    from bench_port import cell, manifest
    chips = manifest.cell(a.workload).chips
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"{a.workload} needs {chips} CUDA card(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}"
              f" available", file=sys.stderr)
        return 2
    opts = cell.Options(a.workload, a.seed, a.seconds, bool(a.trace))
    result = cell.execute(opts, T0)
    found = cell.forbidden_modules()
    if found:
        print(f"forbidden modules loaded: {', '.join(found)}",
              file=sys.stderr)
        return 1
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
