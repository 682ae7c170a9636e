"""The port's config layer against the JAX package's: `cli/yaml_lite.py`
against PyYAML's `safe_load` on every config file (YAML 1.1 scalars
exactly), its writer read back by both parsers, and `cli/config.py::
load_config` against the JAX `load_config` (the list-append quirk, the
override rule, a checkpoint's `train_arguments.yaml`).  Every comparison is
exact: same keys in the same order, same types, same values.

The port's `device` default is None (the card) where the JAX package's is
"tpu"; every other key must agree."""
import glob
import math
from pathlib import Path

import pytest
import yaml

from infomax3d_tpu.cli.config import load_config as jax_load_config
from infomax3d_tpu.train.trainer import _yamlable as jax_yamlable
from infomax3d_tpu_torch.cli import yaml_lite
from infomax3d_tpu_torch.cli.config import DEFAULTS, check_device, load_config
from infomax3d_tpu_torch.train.trainer import yamlable

ROOT = Path(__file__).resolve().parents[1]
CONFIGS = sorted(str(Path(p).relative_to(ROOT)) for p in
                 glob.glob(str(ROOT / "configs" / "*.yml"))
                 + glob.glob(str(ROOT / "configs_clean" / "*.yml")))


def _same(a, b, path="") -> None:
    """Exact equality with types (True is not 1, 1.0 is not 1), dict key
    order included; NaN equals NaN."""
    assert type(a) is type(b), f"{path}: {type(a).__name__} != " \
                               f"{type(b).__name__} ({a!r} vs {b!r})"
    if isinstance(a, dict):
        assert list(a) == list(b), f"{path}: keys {list(a)} != {list(b)}"
        for k in a:
            _same(a[k], b[k], f"{path}/{k}")
    elif isinstance(a, list):
        assert len(a) == len(b), f"{path}: {len(a)} != {len(b)} items"
        for i, (x, y) in enumerate(zip(a, b)):
            _same(x, y, f"{path}[{i}]")
    elif isinstance(a, float) and math.isnan(a):
        assert math.isnan(b), path
    else:
        assert a == b, f"{path}: {a!r} != {b!r}"


def test_there_are_configs():
    assert len(CONFIGS) > 90


@pytest.mark.parametrize("path", CONFIGS)
def test_reader_equals_safe_load(path):
    text = (ROOT / path).read_text()
    _same(yaml_lite.load(text), yaml.safe_load(text))


SCALARS = """
a: 1e-3
b: 1.0e5
c: 8.0e-5
d: 1.0e-11
e: yes
f: Off
g: 017
h: 0x1F
i: ~
j: 1_000
k: .inf
l: -.5
m: 'it''s'
n: "tab\\there"
o: 0b101
p: 1:30
q: +12
r: 3.
s: NaN
t: .NaN
u: [1, [a, 'b c'], {x: 1, y: [2, 3]}, null]
v: {num: 512, n_max: 24}
w:
- one
- k: 1
  z: [0.5]
-
  - nested
x: # only a comment
y: 'quoted: colon # not a comment'
z: plain#hash
"1": str key
2: int key
"""


def test_reader_scalars_and_structures():
    """YAML 1.1 resolution (`1e-3` and `1.0e5` are strings, `017` is
    octal, `yes` / `Off` booleans, `1:30` sexagesimal), quoting, flow
    collections, sequences at their key's indent and of mappings."""
    _same(yaml_lite.load(SCALARS), yaml.safe_load(SCALARS))


@pytest.mark.parametrize("text", ["a: &x 1", "a: !!str 1", "a: |\n  x",
                                  "---\na: 1", "a: 2001-12-14"])
def test_reader_rejects_what_is_outside_the_subset(text):
    with pytest.raises(ValueError):
        yaml_lite.load(text)


@pytest.mark.parametrize("path", CONFIGS)
def test_writer_reads_back_to_the_jax_yamlable(path):
    """`train_arguments.yaml` as the port writes it, read back by PyYAML
    and by the port, equals the JAX `_yamlable` of the JAX `load_config`
    (device aside: None in the port)."""
    want = jax_yamlable(jax_load_config(str(ROOT / path)))
    text = yaml_lite.dump(yamlable(load_config(str(ROOT / path))))
    for got in (yaml.safe_load(text), yaml_lite.load(text)):
        assert got.pop("device") is None
        _same(got, {k: v for k, v in want.items() if k != "device"})


def test_writer_round_trips_awkward_values():
    obj = {"f": [1e-05, 2.5e+20, -0.0, float("inf"), 1.0], "s": [
        "1e-3", "yes", "", " pad", "a: b", "#x", "- d", "it's", "line\nbreak",
        "null", "017", "[x]"], "e": {"l": [], "d": {}}, "n": None,
        "b": [True, False], 3: "int key", "nested": [[1, [2]], {"k": []}]}
    text = yaml_lite.dump(obj)
    _same(yaml.safe_load(text), obj)
    _same(yaml_lite.load(text), obj)


OVERRIDES = {"num_epochs": 3, "multithreaded_seeds": [1, 2],
             "logdir": "elsewhere", "metrics": ["mae"]}


def _jax_vs_port(path, overrides):
    got = load_config(path, dict(overrides) if overrides else None)
    want = jax_load_config(path, dict(overrides) if overrides else None)
    assert want.pop("device") == "tpu" and got.pop("device") is None
    _same(got, want)


@pytest.mark.parametrize("path", CONFIGS)
def test_load_config_matches_jax(path):
    """Defaults, the YAML laid over them with lists appended, and
    programmatic overrides replacing, in every key but `device`."""
    _jax_vs_port(str(ROOT / path), None)
    _jax_vs_port(str(ROOT / path), OVERRIDES)


@pytest.mark.parametrize("writer", ["pyyaml", "port"])
@pytest.mark.parametrize("path", ["configs_clean/tune_QM9_homo.yml",
                                  "configs_clean/tune_freesolv.yml",
                                  "configs/30.yml"])
def test_load_config_rehydrates_a_checkpoint(tmp_path, path, writer):
    """A checkpoint's `train_arguments.yaml` (written by PyYAML as the JAX
    trainer writes it, or by the port) fills the keys the config does not
    set, lists appended; the config and the overrides win."""
    saved = jax_yamlable(jax_load_config(
        str(ROOT / "configs_clean/pre-train_QM9.yml"),
        {"multithreaded_seeds": [7], "num_epochs": 11}))
    del saved["device"]          # each package's default stands
    with open(tmp_path / "train_arguments.yaml", "w") as f:
        if writer == "pyyaml":
            yaml.safe_dump(saved, f)
        else:
            yaml_lite.dump(saved, f)
    ckpt = str(tmp_path / "last_checkpoint.pt")
    _jax_vs_port(str(ROOT / path), {"checkpoint": ckpt})
    _jax_vs_port(str(ROOT / path), {"checkpoint": ckpt, "num_epochs": 4})
    args = load_config(str(ROOT / path), {"checkpoint": ckpt})
    config = yaml.safe_load((ROOT / path).read_text())
    for k, v in saved.items():   # keys from the checkpoint, lists appended
        if k not in config and k not in ("config", "checkpoint"):
            assert args[k] == (DEFAULTS[k] + v if isinstance(v, list)
                               else v), k


def test_defaults_keep_every_jax_key():
    from infomax3d_tpu.cli.config import DEFAULTS as JAX_DEFAULTS
    assert list(DEFAULTS) == list(JAX_DEFAULTS)
    assert {k: v for k, v in DEFAULTS.items() if k != "device"} == \
        {k: v for k, v in JAX_DEFAULTS.items() if k != "device"}
    assert DEFAULTS["device"] is None


@pytest.mark.parametrize("device", [None, "cuda", "cpu"])
def test_check_device_takes_the_card_or_the_cpu(device):
    check_device(device)


@pytest.mark.parametrize("device", ["tpu", "gpu", "cuda:0", ""])
def test_check_device_rejects_others(device):
    with pytest.raises(ValueError):
        check_device(device)
