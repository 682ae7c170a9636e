"""The readings that a cell's limits are set from (`limits/<workload>.json`),
on the chip at the cell's own size; not part of a benchmark run.

    python3 bench_port/calibrate.py --workload qmugs_c3_b500 --seeds 1-12 --control-seeds 1-3
    python3 bench_port/calibrate.py --workload qmugs_c3_b500 --seeds 1-3 --fault half_batch

For each of `seeds`, the program's checked first steps (its set-up as a
run builds it, no window) against the reference: the lower readings, or
with `--fault` the readings of that fault planted in the program
(`faults.py`).  For each of `control-seeds`, the control (the reference
with its matrix operands in float8, the precision below the
configuration's bf16), its witness in bf16 (the reference rounded where
the program rounds), with `--witness-bits` witnesses that round to that
many mantissa bits, and the fault `half_batch` planted in the reference
put in the program's place (the first half of the molecules) against the
reference: the upper readings.  A state left unchanged reads 1 by the
change's measure and needs no run.  Prints one JSON line per reading."""
import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def seed_list(text: str):
    """"1-3,7" -> [1, 2, 3, 7]."""
    out = []
    for part in text.split(","):
        if "-" in part:
            a, b = part.split("-")
            out += list(range(int(a), int(b) + 1))
        elif part:
            out.append(int(part))
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", default="")
    p.add_argument("--control-seeds", default="")
    p.add_argument("--fault", default=None)
    p.add_argument("--witness-bits", default="")
    a = p.parse_args(argv)
    from bench_port import cell, compare, manifest
    from bench_port.reference.nn import bf16, fp8, mantissa
    c = manifest.cell(a.workload)
    opts = cell.Options(a.workload, 0, 0.0, False, fault=a.fault)
    dev = cell.device_of(opts)

    def emit(seed, kind, prog, ref):
        print(json.dumps({"workload": a.workload, "seed": seed,
                          "kind": kind, **compare.readings(prog, ref),
                          **compare.leaf_gaps(prog, ref),
                          "losses": [prog["losses"], ref["losses"]],
                          "grads": [prog["grad"], ref["grad"]],
                          "worst": compare.worst_leaves(prog, ref)}),
              flush=True)

    seeds = seed_list(a.seeds)
    records = cell.checked_records(c, opts, seeds) if seeds else []
    for seed, record in zip(seeds, records):
        emit(seed, a.fault or "program", record,
             cell.reference_record(c, seed, dev))
    faults = {"control": dict(q=fp8), "bf16_witness": dict(q=bf16),
              "half_batch": dict(take=lambda mols: mols[:len(mols) // 2])}
    for bits in seed_list(a.witness_bits):
        faults[f"witness_{bits}bit"] = dict(q=mantissa(bits))
    for seed in seed_list(a.control_seeds):
        ref = cell.reference_record(c, seed, dev)
        for kind, kw in faults.items():
            emit(seed, kind, cell.reference_record(c, seed, dev, **kw), ref)
    print(f"calibrate: {time.perf_counter() - T0:.1f} s", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
