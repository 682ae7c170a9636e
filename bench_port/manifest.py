"""`BENCHMARK.json` and the files it names, found by name: a cell's
configuration (`configs/<config>.yml`, read by the port's `load_config`),
its traffic (`workloads/<traffic>.json`), its limits
(`limits/<workload>.json`), the readers of its metrics
(`metrics/<metric>.py`) and the reference's files of its configuration
(`reference/models/<model_type>.py`, `reference/losses/<loss_func>.py`,
`reference/schedules/<lr_scheduler>.py`)."""
from __future__ import annotations

import json
import os
from dataclasses import dataclass, field
from typing import Dict, List, Mapping

BENCH = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH)


@dataclass
class Cell:
    name: str
    config_path: str
    traffic: Dict
    chips: int
    end_to_end: List[str] = field(default_factory=list)
    per_layer: List[str] = field(default_factory=list)


def _reports(metric: Dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load(root: str = ROOT) -> Dict:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def cell(name: str, root: str = ROOT) -> Cell:
    """The cell `name` of `BENCHMARK.json`: its files, its chips, and the
    metrics it reports (an end-to-end metric listing no `workloads` is
    every cell's; a per-layer metric listing none is every cell's that
    reports its `moves`)."""
    bench = load(root)
    found = [w for w in bench["workloads"] if w["name"] == name]
    if not found:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    w = found[0]
    conf = [c for c in bench["configs"] if c["name"] == w["config"]][0]
    config_path = os.path.join(root, conf["file"])
    with open(os.path.join(BENCH, "workloads", f"{w['traffic']}.json")) as f:
        traffic = json.load(f)
    e2e = [m["name"] for m in bench["end_to_end"] if _reports(m, name)]
    layer = [m["name"] for m in bench["per_layer"]
             if (name in m["workloads"] if "workloads" in m
                 else m["moves"] in e2e)]
    return Cell(name, config_path, traffic, int(w["chips"]), e2e, layer)


def reference_file(kind: str, name: str):
    """The reference's file `name` of `kind` (``models``, ``losses`` or
    ``schedules``), loaded from `BENCH`; NotImplementedError where there is
    none."""
    from bench_port.trace import load_file
    path = os.path.join(BENCH, "reference", kind, f"{name}.py")
    if not os.path.isfile(path):
        raise NotImplementedError(f"no reference for {name} "
                                  f"(reference/{kind}/{name}.py)")
    return load_file(path, f"bench_port_reference_{kind}_{name}")


def reference_parts(config: Mapping):
    """The reference's files of a configuration (`reference.run.Parts`)."""
    from bench_port.reference.run import Parts
    return Parts(config, reference_file)
