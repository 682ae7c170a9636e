"""`BENCHMARK.json` against the benchmark's contract: its keys, names and
units, the files each entry names, the metrics each cell reports, the
configurations' changes from their sources, and the chip time of a full
check."""
import json
import os
import re

import pytest

from bench_port import compare, manifest

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
WIDTHS = re.compile(r"(hidden|intermediate|latent|state|projection|_dim$|"
                    r"_rank$|head|expansion|experts_per_token)")
SOURCES = {"pretrain_qmugs": "configs_clean/pre-train_QMugs.yml"}

BENCH = manifest.load()


def _line(text):
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "bench_port/run.py"]
    assert BENCH["paths"] == ["bench_port"]
    assert isinstance(BENCH["run_seconds"], int)
    assert 1 <= BENCH["run_seconds"] <= 51
    assert os.path.getsize(os.path.join(manifest.ROOT,
                                        "BENCHMARK.json")) <= 64 * 1024


def test_entries_and_names():
    keys = {"configs": {"name", "source", "file", "reduced", "why"},
            "workloads": {"name", "config", "traffic", "chips", "why"},
            "end_to_end": {"name", "unit", "better", "bound", "source"},
            "per_layer": {"name", "unit", "better", "source", "layer",
                          "moves"}}
    for section, want in keys.items():
        names = [e["name"] for e in BENCH[section]]
        assert len(names) == len(set(names))
        for e in BENCH[section]:
            extra = {"workloads"} if section in ("end_to_end",
                                                 "per_layer") else set()
            assert want <= set(e) <= want | extra, e
            assert NAME.match(e["name"]), e["name"]
            for k in ("why", "layer", "source"):
                if k in e:
                    assert _line(e[k]), (e["name"], k)
            if "unit" in e:
                assert UNIT.match(e["unit"]) and e["better"] in ("lower",
                                                                "higher")
    for w in BENCH["workloads"]:
        assert NAME.match(w["traffic"]) and w["chips"] in (1, 4)
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))
    four = sum(w["chips"] == 4 for w in BENCH["workloads"])
    assert four <= max(1, len(BENCH["workloads"]) // 4)
    assert all(c.split()[0] == c and _line(c) for c in BENCH["command"])


def test_bounds():
    bounds = {m["name"]: m["bound"] for m in BENCH["end_to_end"]}
    assert "setup_s" in bounds
    assert all(0.01 <= b <= 0.25 for b in bounds.values())
    assert all(m["source"] in ("host_clock", "device_trace")
               for m in BENCH["end_to_end"])
    assert all(m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
               for m in BENCH["per_layer"])


@pytest.mark.parametrize("w", [w["name"] for w in BENCH["workloads"]])
def test_cell_reports(w):
    """Every cell reports setup_s, another end-to-end metric and a
    per-layer metric; each per-layer metric it reports moves an
    end-to-end metric it reports; every metric has its reader and the
    cell its files."""
    cell = manifest.cell(w)
    assert "setup_s" in cell.end_to_end and len(cell.end_to_end) >= 2
    assert cell.per_layer
    moves = {m["name"]: m["moves"] for m in BENCH["per_layer"]}
    for name in cell.per_layer:
        assert moves[name] in cell.end_to_end
    for name in cell.end_to_end + cell.per_layer:
        assert os.path.exists(os.path.join(manifest.BENCH, "metrics",
                                           f"{name}.py"))
    assert os.path.exists(cell.config_path)
    with open(os.path.join(manifest.BENCH, "limits", f"{w}.json")) as f:
        limits = json.load(f)
    assert set(limits) == set(compare.NAMES)
    for spec in limits.values():
        assert spec["limit"] > 0


def test_layers_named_alike():
    layers = {}
    for m in BENCH["per_layer"]:
        layers.setdefault(m["layer"].split(" (")[0], set()).add(m["layer"])
    assert all(len(v) == 1 for v in layers.values())


@pytest.mark.parametrize("conf", BENCH["configs"], ids=lambda c: c["name"])
def test_config_changes_are_listed(conf):
    """Each top-level key of a configuration that differs from its source
    (the published file, kept in the repository) is in `reduced`, and no
    width is."""
    from infomax3d_tpu_torch.cli import yaml_lite
    assert conf["file"].startswith("bench_port/")
    with open(os.path.join(manifest.ROOT, conf["file"])) as f:
        ours = yaml_lite.safe_load(f)
    with open(os.path.join(manifest.ROOT, SOURCES[conf["name"]])) as f:
        source = yaml_lite.safe_load(f)
    changed = {k for k in set(ours) | set(source)
               if ours.get(k) != source.get(k)}
    assert changed == set(conf["reduced"])
    assert not [k for k in conf["reduced"] if WIDTHS.search(k)]
    assert len(conf["reduced"]) <= 16


def test_check_fits_its_time():
    """A full check of 24 cells fits 43200 s at this run length."""
    runs = 2 + 14 * 24
    assert runs * (BENCH["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200
