"""The serving slice against the JAX package on the CPU: the port's flax
msgpack reader, `cli/inference.py` from SMILES and from a dataset with a
JAX-written checkpoint (and the same weights as a port `.pt`),
`cli/analysis.py`, and the fine-tune transfer from a JAX checkpoint.

The checkpoint is `tests/fixtures/jax_serving/` (written by
`tools/make_jax_serving_fixture.py`: PNA 16x2 trained 2 steps by the JAX
CLI, its 64 SMILES and the JAX CLI's fingerprints of them).  OGBGNN (GIN
2x16) is served from seeded weights written here as a JAX checkpoint.

Tolerances:
* fingerprints, the port on the CPU against the JAX CLI on the CPU:
  1e-5 relative to max|JAX| (both float32; sums in another order, the
  JAX side on its XLA segment path; readings 4.7e-7 PNA);
* the JAX CLI's fingerprints today against the stored ones: 1e-6 (the
  same program on the same kind of machine; the fixture is stale when it
  moves further);
* a `.pt` conversion of the same weights: equal;
* the singular-value spectrum: 1e-6 absolute (percentages);
* the transfer: every tensor equal and the count equal.
"""
import contextlib
import io
import json
import shutil
import types
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
import yaml
from flax import serialization

from infomax3d_tpu.cli import analysis as jax_analysis
from infomax3d_tpu.cli.config import load_config as jax_load_config
from infomax3d_tpu.cli.inference import inference as jax_inference
from infomax3d_tpu.cli.train import transfer_pretrained as jax_transfer
from infomax3d_tpu.train.checkpoint import save_checkpoint
from infomax3d_tpu.train.state import TrainState
from infomax3d_tpu_torch.cli import analysis
from infomax3d_tpu_torch.cli import inference as serving
from infomax3d_tpu_torch.cli.config import load_config
from infomax3d_tpu_torch.cli.train import transfer_pretrained
from infomax3d_tpu_torch.data.chem import SmilesError
from infomax3d_tpu_torch.interop import init_jax_variables, params_from_jax
from infomax3d_tpu_torch.models import PNA
from infomax3d_tpu_torch.train import precision
from infomax3d_tpu_torch.train.flax_msgpack import (MsgpackError,
                                                    msgpack_restore)
from infomax3d_tpu_torch.train.checkpoint import load_checkpoint
from infomax3d_tpu_torch.train.torch_interop import load_jax_checkpoint

FIXTURE = Path(__file__).resolve().parent / "fixtures" / "jax_serving"
CKPT = FIXTURE / "best_checkpoint.pt"
SMILES = FIXTURE / "smiles.txt"
META = json.loads((FIXTURE / "fixture.json").read_text())
TOL = 1e-5
STALE_TOL = 1e-6
GIN = dict(target_dim=4, num_layers=2, hidden_dim=16, dropout=0.0,
           virtual_node=False, batch_norm_momentum=0.1)
# the dataset route: a small synthetic set in place of the fixture's 512
DATASET = {"dataset": "synthetic", "dataset_params": {"num": 40, "seed": 2}}


def _rel(got, ref):
    return float(np.abs(got - ref).max() / np.abs(ref).max())


def _jax(overrides):
    with contextlib.redirect_stdout(io.StringIO()):
        return jax_inference(jax_load_config(None, overrides))


def _port(overrides, device="cpu"):
    return serving.inference(load_config(None, overrides), device=device)


@pytest.fixture(scope="module")
def gin_ckpt(tmp_path_factory):
    """Seeded OGBGNN weights as a JAX checkpoint, beside its arguments."""
    d = tmp_path_factory.mktemp("gin")
    params, stats = init_jax_variables(GIN, seed=3, model_type="OGBGNN")
    (d / "best_checkpoint.pt").write_bytes(serialization.to_bytes(
        {"params": {"model": params}, "batch_stats": {"model": stats},
         "opt_state": {}, "step": np.int32(0), "extra": None}))
    (d / "train_arguments.yaml").write_text(yaml.safe_dump(
        {"model_type": "OGBGNN", "model_parameters": GIN, "batch_size": 16,
         "trainer": "default", "bf16_compute": "auto"}))
    return d / "best_checkpoint.pt"


@pytest.fixture(scope="module")
def served(gin_ckpt, tmp_path_factory):
    """Each route through the JAX CLI and the port on the CPU."""
    d = tmp_path_factory.mktemp("served")
    routes = {
        "pna smiles": {"checkpoint": str(CKPT),
                       "smiles_txt_path": str(SMILES)},
        "pna dataset": dict(DATASET, checkpoint=str(CKPT)),
        "gin smiles": {"checkpoint": str(gin_ckpt),
                       "smiles_txt_path": str(SMILES)},
        "gin dataset": dict(DATASET, checkpoint=str(gin_ckpt)),
    }
    out = {}
    for name, ov in routes.items():
        tag = name.replace(" ", "_")
        out[name] = (
            _jax(dict(ov, output_path=str(d / f"jax_{tag}.npy"))),
            _port(dict(ov, output_path=str(d / f"port_{tag}.npy"))), ov)
    return out


# ------------------------------------------------------------------ reader

def _same(ref, got, path="") -> None:
    """`got` is `ref` bit for bit (a bfloat16 leaf of `ref` widened to
    float32, as the port's reader returns it)."""
    if isinstance(ref, dict):
        assert isinstance(got, dict) and list(ref) == list(got), path
        for k in ref:
            _same(ref[k], got[k], f"{path}/{k}")
    elif isinstance(ref, list):
        assert isinstance(got, list) and len(ref) == len(got), path
        for i, (a, b) in enumerate(zip(ref, got)):
            _same(a, b, f"{path}/{i}")
    elif isinstance(ref, (np.ndarray, np.generic)):
        a = np.asarray(ref)
        if a.dtype.name == "bfloat16":
            a = a.astype(np.float32)
        else:
            assert type(ref) is type(got), path
        b = np.asarray(got)
        assert (a.dtype, a.shape) == (b.dtype, b.shape), path
        assert a.tobytes() == b.tobytes(), path
    else:
        assert type(ref) is type(got) and ref == got, path


def _train_state_bytes(tmp_path) -> bytes:
    """A TrainState with Adam's state, written by the JAX trainer's
    `save_checkpoint`."""
    import optax
    params, stats = init_jax_variables(
        dict(META["tune_overrides"]["model_parameters"]), seed=1)
    params = jax.tree_util.tree_map(jax.numpy.asarray, params)
    opt = optax.adam(1e-3)
    state = TrainState(params={"model": params},
                       batch_stats={"model": stats},
                       opt_state=opt.init({"model": params}),
                       step=jax.numpy.asarray(7, jax.numpy.int32))
    save_checkpoint(str(tmp_path / "ckpt.pt"), state, {"epoch": 1})
    return (tmp_path / "ckpt.pt").read_bytes()


@pytest.mark.parametrize("source", ["save_checkpoint", "fixture"])
def test_reader_restores_train_states(source, tmp_path):
    data = _train_state_bytes(tmp_path) if source == "save_checkpoint" \
        else CKPT.read_bytes()
    ref = serialization.msgpack_restore(data)
    got = msgpack_restore(data)
    _same(ref, got)
    assert set(got) == {"params", "batch_stats", "opt_state", "step",
                        "extra"}
    assert got["opt_state"] and np.asarray(got["step"]).dtype == np.int32


def test_reader_leaf_types():
    rng = np.random.default_rng(0)
    tree = {"bf16": jax.numpy.asarray(rng.normal(size=(3, 5)),
                                      jax.numpy.bfloat16),
            "f64": rng.normal(size=4), "i8": np.arange(-4, 4, dtype=np.int8),
            "u16": np.arange(9, dtype=np.uint16).reshape(3, 3),
            "b": rng.random(6) > 0.5,
            "scalars": {"f32": np.float32(1.5), "i64": np.int64(-2 ** 40),
                        "bool": np.bool_(True), "bf16": jax.numpy.bfloat16(3)},
            "python": {"int": 5, "neg": -33, "big": 2 ** 63 - 1,
                       "float": 0.1, "true": True, "none": None, "str": "ü",
                       "bytes": b"\x00\x01", "list": [1, "a", [2.5]],
                       "complex": 1 - 2j},
            "empty": np.zeros((0, 3), np.float32)}
    data = serialization.to_bytes(tree)
    _same(serialization.msgpack_restore(data), msgpack_restore(data))
    got = msgpack_restore(data)
    np.testing.assert_array_equal(
        got["bf16"], np.asarray(tree["bf16"]).astype(np.float32))


def test_reader_chunked_arrays(monkeypatch):
    monkeypatch.setattr(serialization, "MAX_CHUNK_SIZE", 64)
    tree = {"w": np.arange(100, dtype=np.float32).reshape(4, 25),
            "v": {"x": np.arange(33, dtype=np.int64)},
            "small": np.ones(3, np.float32)}
    data = serialization.to_bytes(tree)
    assert b"__msgpack_chunked_array__" in data
    _same(serialization.msgpack_restore(data), msgpack_restore(data))


@pytest.mark.parametrize("cut", [1, 3, 40, 0.5, -1])
def test_reader_truncated_raises(cut):
    data = CKPT.read_bytes()
    n = int(len(data) * cut) if isinstance(cut, float) else cut
    with pytest.raises(MsgpackError, match="offset"):
        msgpack_restore(data[:n])


def test_reader_rejects_other_bytes():
    with pytest.raises(MsgpackError, match="left over at offset"):
        msgpack_restore(CKPT.read_bytes() + b"\xc0")
    with pytest.raises(MsgpackError, match="reserved byte 0xc1 at offset 1"):
        msgpack_restore(b"\x91\xc1")
    with pytest.raises(MsgpackError, match="unknown ext type 9 at offset 0"):
        msgpack_restore(b"\xd4\x09\x00")
    with pytest.raises(MsgpackError, match="map key of type int at offset 1"):
        msgpack_restore(b"\x81\x01\x02")


# ----------------------------------------------------------------- serving

def test_fixture_is_current(served):
    """The JAX CLI gives the stored fingerprints today."""
    jax_fp = served["pna smiles"][0]
    stored = np.load(FIXTURE / "fingerprints.npy")
    assert jax_fp.shape == stored.shape == (64, 64)
    assert _rel(jax_fp, stored) <= STALE_TOL


@pytest.mark.parametrize("route", ["pna smiles", "pna dataset",
                                   "gin smiles", "gin dataset"])
def test_serving_matches_jax(served, route):
    jax_fp, port_fp, _ = served[route]
    n = 64 if "smiles" in route else DATASET["dataset_params"]["num"]
    width = 64 if route.startswith("pna") else GIN["target_dim"]
    assert port_fp.shape == jax_fp.shape == (n, width)
    assert port_fp.dtype == np.float32 and np.isfinite(port_fp).all()
    assert np.abs(jax_fp).max() > 0
    assert _rel(port_fp, jax_fp) <= TOL


@pytest.mark.parametrize("route", ["pna smiles", "gin dataset"])
def test_port_pt_serves_the_same(served, route, tmp_path):
    """The JAX checkpoint converted to a port `.pt` (its arguments beside
    it) serves the same fingerprints."""
    _, port_fp, ov = served[route]
    src = Path(ov["checkpoint"])
    tree = load_jax_checkpoint(str(src))
    torch.save({"model_state_dict": params_from_jax(
        tree["params"]["model"], tree["batch_stats"]["model"])},
        tmp_path / "best_checkpoint.pt")
    shutil.copy(src.parent / "train_arguments.yaml", tmp_path)
    pt = str(tmp_path / "best_checkpoint.pt")
    assert set(load_checkpoint(pt)) == {"model_state_dict"}
    got = _port(dict(ov, checkpoint=pt,
                     output_path=str(tmp_path / "fp.npy")))
    np.testing.assert_array_equal(got, port_fp)


def test_auto_serves_float32_where_training_would_take_bf16(served,
                                                            monkeypatch,
                                                            tmp_path):
    """`bf16_compute: auto` (the fixture's saved arguments) serves float32
    even where "auto" means bf16 to the trainer, on the card: here
    `resolve_compute_dtype` is made to answer as it does for a CUDA device,
    and the fingerprints must still be the JAX CLI's float32 ones."""
    real = precision.resolve_compute_dtype

    def as_on_the_card(setting, device):
        return real(setting, "cuda")
    monkeypatch.setattr(precision, "resolve_compute_dtype", as_on_the_card)
    monkeypatch.setattr(serving, "resolve_compute_dtype", as_on_the_card,
                        raising=False)
    jax_fp, _, ov = served["pna smiles"]
    args = load_config(None, dict(ov, output_path=str(tmp_path / "a.npy")))
    assert args["bf16_compute"] == "auto"
    assert serving.serving_dtype("auto") is None
    assert _rel(serving.inference(args, device="cpu"), jax_fp) <= TOL
    # an explicit request serves bf16: further off, within bf16's reach
    assert serving.serving_dtype(True) == torch.bfloat16
    bf = serving.inference(dict(args, bf16_compute=True,
                                output_path=str(tmp_path / "b.npy")),
                           device="cpu")
    assert 1e-3 < _rel(bf, jax_fp) < 3e-2


def test_cli_main_serves_and_writes(tmp_path):
    cfg = tmp_path / "serve.yml"
    cfg.write_text(yaml.safe_dump({"smiles_txt_path": str(SMILES),
                                   "output_dir": str(tmp_path / "out")}))
    fp = serving.main(["--config", str(cfg), "--checkpoint", str(CKPT),
                       "--device", "cpu"])
    np.testing.assert_array_equal(
        np.load(tmp_path / "out" / "fingerprints.npy"), fp)
    assert _rel(fp, np.load(FIXTURE / "fingerprints.npy")) <= TOL


def test_serving_loads_strictly(tmp_path):
    """A tensor missing from the checkpoint, or of another shape, raises
    and names it; an invalid SMILES raises."""
    shutil.copy(FIXTURE / "train_arguments.yaml", tmp_path)
    tree = serialization.msgpack_restore(CKPT.read_bytes())
    out = tree["params"]["model"]["output"]
    del out["FCLayer_1"]["Dense_0"]["bias"]
    (tmp_path / "best_checkpoint.pt").write_bytes(
        serialization.msgpack_serialize(tree))
    ov = {"checkpoint": str(tmp_path / "best_checkpoint.pt"),
          "smiles_txt_path": str(SMILES),
          "output_path": str(tmp_path / "fp.npy")}
    with pytest.raises(RuntimeError,
                       match=r"output\.fully_connected\.1\.linear\.bias"):
        _port(ov)
    out["FCLayer_1"]["Dense_0"]["bias"] = np.zeros(3, np.float32)
    (tmp_path / "best_checkpoint.pt").write_bytes(
        serialization.msgpack_serialize(tree))
    with pytest.raises(RuntimeError, match=r"size mismatch for "
                       r"output\.fully_connected\.1\.linear\.bias"):
        _port(ov)
    bad = tmp_path / "bad.txt"
    bad.write_text("CCO\nC1CC\n")
    with pytest.raises(SmilesError, match="unclosed ring"):
        _port(dict(ov, checkpoint=str(CKPT), smiles_txt_path=str(bad)))


# ---------------------------------------------------------------- analysis

def test_analysis_matches_jax(served, tmp_path):
    """The spectrum of the same fingerprints to 1e-6; each CLI's JSON (the
    same keys) is its own fingerprints' spectrum, and the two differ by no
    more than the fingerprints' difference allows (Weyl: each singular
    value moves by at most the spectral norm w of the difference of the
    centred matrices, so each percentage by at most 100 w (1 + k) / S',
    k values summing to S')."""
    fp = served["pna smiles"][0]
    np.testing.assert_allclose(analysis.singular_value_spectrum(fp),
                               jax_analysis.singular_value_spectrum(fp),
                               rtol=0, atol=1e-6)
    out, fps = {}, {}
    for side, main, extra in (("jax", jax_analysis.main, []),
                              ("port", analysis.main, ["--device", "cpu"])):
        cfg = tmp_path / f"{side}.yml"
        cfg.write_text(yaml.safe_dump({"smiles_txt_path": str(SMILES),
                                       "output_dir": str(tmp_path / side)}))
        with contextlib.redirect_stdout(io.StringIO()):
            main(["--config", str(cfg), "--checkpoint", str(CKPT)] + extra)
        out[side] = json.loads(
            (tmp_path / side / "singular_values.json").read_text())
        fps[side] = np.load(tmp_path / side / "fingerprints.npy")
        np.testing.assert_allclose(
            out[side]["singular_values_pct"],
            jax_analysis.singular_value_spectrum(fps[side]), rtol=0,
            atol=1e-12)
    assert out["jax"].keys() == out["port"].keys()
    assert (out["port"]["n_samples"], out["port"]["dim"]) == (64, 64)
    dz = fps["port"] - fps["jax"]
    w = np.linalg.norm(dz - dz.mean(axis=0), 2)
    k = len(out["port"]["singular_values_pct"])
    s_sum = np.linalg.svd(fps["port"] - fps["port"].mean(axis=0),
                          compute_uv=False).sum()
    bound = 100 * w * (1 + k) / s_sum
    assert 0 < bound < 1e-2
    np.testing.assert_allclose(out["port"]["singular_values_pct"],
                               out["jax"]["singular_values_pct"], rtol=0,
                               atol=bound)
    s = np.asarray(out["port"]["singular_values_pct"])
    # float32 singular values: the percentages sum to 100 within 1e-4
    assert np.all(np.diff(s) <= 0) and abs(s.sum() - 100) < 1e-4
    np.testing.assert_allclose(out["port"]["cumsum_pct"], np.cumsum(s),
                               rtol=0, atol=1e-4)


# ---------------------------------------------------------------- transfer

def _variant(kind: str, tmp_path) -> str:
    """The fixture checkpoint as is, with its models wrapped in a BYOL
    `student`, or with the root `node_gnn` named `gnn`."""
    if kind == "as written":
        return str(CKPT)
    tree = serialization.msgpack_restore(CKPT.read_bytes())
    for coll in ("params", "batch_stats"):
        m = tree[coll]["model"]
        tree[coll]["model"] = {"student": m} if kind == "student" else \
            {("gnn" if k == "node_gnn" else k): v for k, v in m.items()}
    path = tmp_path / f"{kind}.pt"
    path.write_bytes(serialization.msgpack_serialize(tree))
    return str(path)


@pytest.mark.parametrize("kind", ["as written", "student", "root gnn"])
def test_transfer_from_jax_checkpoint_matches_jax(kind, tmp_path, capsys):
    """`transfer_pretrained` from a JAX msgpack copies what the JAX CLI's
    copies, under `configs/tune_pna.yml`'s transfer_layers /
    exclude_from_transfer, into a model with other weights."""
    tune = META["tune_overrides"]
    mp = tune["model_parameters"]
    args = {"pretrain_checkpoint": _variant(kind, tmp_path),
            "transfer_layers": tune["transfer_layers"],
            "exclude_from_transfer": tune["exclude_from_transfer"]}
    params, stats = init_jax_variables(mp, seed=9)
    state = jax_transfer(TrainState(
        params={"model": params}, batch_stats={"model": stats},
        opt_state=None, step=0), args)
    jax_count = int(capsys.readouterr().out.split("transferred ")[1]
                    .split()[0])
    model = PNA(**mp)
    model.load_state_dict(params_from_jax(params, stats))
    count = transfer_pretrained(types.SimpleNamespace(
        models={"model": model}), args)
    assert count == jax_count == META["transfer_count"]
    want = params_from_jax(jax.device_get(state.params["model"]),
                           jax.device_get(state.batch_stats["model"]))
    got = model.state_dict()
    before = params_from_jax(params, stats)
    moved = [k for k in want if not torch.equal(want[k], before[k])]
    assert moved and len(moved) < len(want)
    for k, v in want.items():
        assert torch.equal(got[k], v), k
