"""The port's twin of `tests/test_reference_configs.py` and
`tests/test_real_qm9_slice.py`, on the CPU.

* `build_dataset` resolves every dataset name the JAX CLI routes to the
  JAX package's class over the same cache.
* Every `configs_clean/*.yml` runs through the port's CLI on the synthetic
  caches the JAX test uses (`tests/test_reference_configs.py:23-40`,
  written here by the port's `write_synthetic_cache`), at tiny widths, for
  one epoch of one step (OGB sets: their scaffold split's train set in one
  batch), or raises the `NotImplementedError` of its ROADMAP queue 1 item
  (`RAISES`): the OT baseline stops at its trainer (item 8).  The
  distance-predictor and GraphCL baselines (`AGAINST_JAX`) also run
  through the JAX CLI from the same initial weights, and their first
  logged losses agree within 1e-5 relative.  `fingerprint_inference.yml`,
  a config of the inference CLI, serves the SMILES and checkpoint of
  `tests/fixtures/jax_serving` (the JAX CLI's fingerprints within 1e-5).
* A cache-served `pre-train_QM9.yml` then `tune_QM9_homo.yml` (2 epochs
  of 4 steps each, PNA 16x2, Net3D hidden 8, dataset `qm9` from the QM9
  cache, the fine-tune transferring from the port's pre-training, its
  warmup cut to [3, 3, 3]) through both CLIs
  from the same initial weights, held with `tests/test_torch_port_cli.py`'s
  witness bounds (`_metric_violations`: 4x the distance of runs from
  weights perturbed by 2^-20, plus 1e-3 relative) and its first-loss bound
  (1e-5 relative).
* The real QM9 slice (`tests/fixtures/qm9_slice`, 12 molecules) through
  the port's `preprocess_qm9`, `QM9Dataset` and a pre-train then
  fine-tune at tiny widths (the configs' own widths run on the card, in
  `chip_smoke.py` phase 19).
"""
import glob
import json
import os

import jax
import numpy as np
import pytest

from infomax3d_tpu.cli import train as jax_cli
from infomax3d_tpu.cli.config import load_config as jax_load_config
from infomax3d_tpu.cli.train import build_dataset as jax_build_dataset
from infomax3d_tpu.data.synthetic import \
    write_synthetic_cache as jax_write_cache
from infomax3d_tpu.losses import get_loss as jax_get_loss
from infomax3d_tpu.train import trainer as jax_trainer
from infomax3d_tpu_torch.cli.config import load_config
from infomax3d_tpu_torch.cli.inference import inference
from infomax3d_tpu_torch.cli.train import (GEOMOL_FINETUNE_SETS,
                                           build_dataset, train)
from infomax3d_tpu_torch.data.cached import HAR2EV, QM9Dataset
from infomax3d_tpu_torch.data.preprocess import preprocess_qm9
from infomax3d_tpu_torch.data.synthetic import write_synthetic_cache
from test_torch_port_cli import (FIRST_LOSS_TOL, _first_loss,
                                 _metric_violations, _run_jax, _run_port)
from test_torch_port_conformers import _jax_float64, _to64

CONFIG_DIR = "configs_clean"
FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures", "qm9_slice")
SERVING = os.path.join(os.path.dirname(__file__), "fixtures", "jax_serving")

# the JAX test's caches (tests/test_reference_configs.py:23-40)
CACHES = {
    "QM9": dict(num=300, num_targets=19, seed=1),
    "QMugs": dict(num=260, num_conformers=3, seed=2),
    "GEOM_Drugs": dict(num=260, num_conformers=5, seed=3),
    "file_loader_qm9": dict(num=80, num_conformers=10, seed=4, n_min=4,
                            n_max=12),
    "ogbg_molfreesolv": dict(num=140, num_targets=1, seed=5,
                             split="scaffold"),
    "bace_geomol": dict(num=120, num_targets=1, seed=6, float_features=True,
                        split="random"),
}

# configs that stop at a part the port has not ported: the ROADMAP queue 1
# item their NotImplementedError names, and what it names
RAISES = {}
# configs whose first step also runs through the JAX CLI from the same
# initial weights (and `configs/contrastive_training_Net3DAE.yml`, below).  The JAX CLI's first batch and weights give a loss in
# float64 (`_jax_first_loss64`); the port's first logged loss is held to
# it within FIRST_LOSS_TOL, and the JAX CLI's own (its jitted float32
# step) within JAX_CLI_TOL (reading 1.4e-5 for GraphCL, whose port reads
# 9e-7), which shows that both runs read that batch from those weights.
AGAINST_JAX = ("pre-train_distance_predictor_baseline.yml",
               "pre-train_graphCL_baseline.yml")
JAX_CLI_TOL = 1e-4


def _jax_first_loss64(config, overrides, init):
    """The loss of the JAX CLI's first training batch (its loader's second
    pass: the trainer draws an example batch first) at the initial weights
    `init`, through the loss_fn of the trainer the JAX CLI picks, in
    training mode, in float64 (`_jax_float64`)."""
    args = jax_load_config(config, dict(overrides, csr_buckets=False,
                                        dense_3d=True))
    jax_cli.resolve_collate(args)
    ds = jax_build_dataset(args)
    jax_cli.apply_dataset_protocol(args, ds)
    jax_cli.resolve_fast_paths(args)
    loader = jax_cli.make_loaders(args, ds)[0]
    next(iter(loader))
    batch = next(iter(loader))
    key = args["trainer"] if args.get("model3d_type") or args["trainer"] in (
        "graphcl_trainer", "distance_predictor") else "distance_predictor"
    cls = jax_trainer.TRAINER_REGISTRY[key]
    tr = cls.__new__(cls)
    tr.models = jax_cli.build_models(args, ds)
    tr.loss_name, tr.compute_dtype, tr.args, tr.mesh = \
        args["loss_func"], None, {}, None
    tr.loss_func = None if key == "distance_predictor" else jax_get_loss(
        args["loss_func"], **(args.get("loss_params") or {}))
    with _jax_float64():
        v = {k: _to64(init[k]) for k in init}
        loss = tr.loss_fn({k: x["params"] for k, x in v.items()},
                          {k: x["batch_stats"] for k, x in v.items()},
                          _to64(batch), 0, jax.random.key(0), True)[0]
        return float(loss)


def _step_against_jax(path, over, tmp_path):
    """`path` one step through the JAX CLI and through the port's from the
    JAX run's initial weights; holds both first logged losses to
    `_jax_first_loss64` (FIRST_LOSS_TOL, JAX_CLI_TOL) and returns the
    port's run."""
    ref = _run_jax(path, over, str(tmp_path / "jax"))
    run = _run_port(path, over, str(tmp_path / "port"), ref["init"])
    name = load_config(path, {})["loss_func"]
    want = _jax_first_loss64(path, dict(over, logdir=str(tmp_path)),
                             ref["init"])
    assert abs(_first_loss(run["records"], 1, name) - want) <= \
        FIRST_LOSS_TOL * abs(want)
    assert abs(_first_loss(ref["records"], 1, name) - want) <= \
        JAX_CLI_TOL * abs(want)
    return run


CONFIGS = sorted(os.path.basename(p)
                 for p in glob.glob(f"{CONFIG_DIR}/*.yml"))
TINY = dict(hidden_dim=16, propagation_depth=2, readout_hidden_dim=16)
TINY3D = dict(hidden_dim=8)


@pytest.fixture(scope="module")
def data_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("refdata")
    for name, kw in CACHES.items():
        write_synthetic_cache(str(root / name / "processed.npz"), **kw)
    return root


def test_caches_equal_the_jax_tests(data_root, tmp_path):
    for name, kw in CACHES.items():
        ref = jax_write_cache(str(tmp_path / name / "processed.npz"), **kw)
        a, b = np.load(str(data_root / name / "processed.npz")), np.load(ref)
        assert a.files == b.files
        for k in a.files:
            np.testing.assert_array_equal(a[k], b[k], err_msg=f"{name}/{k}")


def _one_step(config, logdir, path=None):
    """Overrides that cut `config` (at `path`, default under CONFIG_DIR)
    to tiny widths and one training step."""
    base = load_config(path or f"{CONFIG_DIR}/{config}", {})
    ov = dict(num_epochs=1, patience=1, use_tensorboard=False,
              eval_per_epochs=0, log_iterations=1, logdir=str(logdir),
              batch_size=8, num_train=8, multithreaded_seeds=[],
              pretrain_checkpoint=None)
    mp = dict(base.get("model_parameters") or {})
    ov["model_parameters"] = {k: TINY.get(k, v) for k, v in mp.items()}
    if "pna_args" in mp:         # the distance predictor's nested PNA
        ov["model_parameters"]["pna_args"] = {
            k: TINY.get(k, v) for k, v in mp["pna_args"].items()}
    if "hyperparams" in mp:      # the OT model: its backbone and conformers
        ov["model_parameters"]["gnn_params"] = {
            k: TINY.get(k, v) for k, v in mp["gnn_params"].items()}
        ov["model_parameters"]["hyperparams"] = dict(
            mp["hyperparams"], hidden_dim=TINY["hidden_dim"],
            n_model_confs=3, n_true_confs=3)
    if base.get("model3d_parameters"):
        ov["model3d_parameters"] = dict(base["model3d_parameters"], **TINY3D)
    if base["dataset"].startswith("ogbg"):
        ov["batch_size"] = 128       # the scaffold train set in one batch
    return ov


@pytest.mark.parametrize("config", CONFIGS)
def test_config_steps_or_names_its_item(config, data_root, tmp_path,
                                        monkeypatch):
    monkeypatch.setenv("INFOMAX3D_DATA", str(data_root))
    if config == "fingerprint_inference.yml":
        fp = inference(load_config(f"{CONFIG_DIR}/{config}", {
            "checkpoint": f"{SERVING}/best_checkpoint.pt",
            "smiles_txt_path": f"{SERVING}/smiles.txt",
            "output_dir": str(tmp_path)}), device="cpu")
        ref = np.load(f"{SERVING}/fingerprints.npy")
        assert fp.shape == ref.shape and np.isfinite(fp).all()
        assert np.abs(fp - ref).max() <= 1e-5 * np.abs(ref).max()
        np.testing.assert_array_equal(np.load(tmp_path / "fingerprints.npy"),
                                      fp)
        return
    if config in RAISES:
        item, what = RAISES[config]
        with pytest.raises(NotImplementedError,
                           match=rf"{what}.*ROADMAP queue 1, item {item}\)"):
            train(load_config(f"{CONFIG_DIR}/{config}",
                              _one_step(config, tmp_path)), device="cpu")
        return
    args = load_config(f"{CONFIG_DIR}/{config}", _one_step(config, tmp_path))
    if config in AGAINST_JAX:
        result = _step_against_jax(f"{CONFIG_DIR}/{config}",
                                   _one_step(config, tmp_path),
                                   tmp_path)["result"]
        tmp_path = tmp_path / "port"
    else:
        result = train(args, device="cpu")
    assert all(np.isfinite(v) for v in result.values()), result
    run_dir, = glob.glob(str(tmp_path / "*"))
    steps = [r for r in map(json.loads, open(f"{run_dir}/metrics.jsonl"))
             if r["split"] == "train"]
    assert [r["step"] for r in steps] == [1], steps
    if args["dataset"].startswith("ogbg"):
        assert args["main_metric"] == args["dataset"] in result


def test_net3d_ae_config_steps_against_jax(data_root, tmp_path,
                                           monkeypatch):
    """`configs/contrastive_training_Net3DAE.yml` (PNA + Net3DAE, the
    autoencoder trainer, NTXentAE) at tiny widths, one step through both
    CLIs from the same weights; the port logs both parts of the loss."""
    monkeypatch.setenv("INFOMAX3D_DATA", str(data_root))
    path = "configs/contrastive_training_Net3DAE.yml"
    over = dict(_one_step("contrastive_training_Net3DAE.yml", tmp_path,
                          path), model_parameters=dict(
        load_config(path, {})["model_parameters"], **TINY, target_dim=24))
    run = _step_against_jax(path, over, tmp_path)
    assert all(np.isfinite(v) for v in run["result"].values())
    first = next(r for r in run["records"] if r["split"] == "train")
    assert abs(first["contrastive_loss"] + first["reconstruction_loss"]
               - first["NTXentAE"]) <= 1e-6 * first["NTXentAE"]


# 300 molecules: model pool 240, test 30, validation 30 (one batch of 16)
# every dataset name the JAX CLI routes (infomax3d_tpu/cli/train.py:
# 113-201), with the cache directory it reads under $INFOMAX3D_DATA
ROUTED = {
    **{n: n for n in GEOMOL_FINETUNE_SETS},
    "qm9": "QM9", "qm9_rdkit": "QM9_rdkit", "qm9_neuralconf":
    "QM9_neuralconf", "qm9_geomol": "qm9_geomol", "qm9_geomol_feat":
    "qm9_geomol", "file_loader_qm9": "file_loader_qm9", "file_loader_drugs":
    "file_loader_drugs", "ot_pyg_geom_qm9": "ot_pyg_geom_qm9",
    "qmugs": "QMugs", "drugs": "GEOM_Drugs", "geom_qm9": "GEOM_QM9",
    "zinc": "ZINC", "ogbg-molhiv": "ogbg_molhiv", "molhiv": "ogbg_molhiv",
    "ogbg-molpcba": "ogbg_molpcba", "pcqm4m": "pcqm4m", "synthetic": None,
}


def test_build_dataset_routes_every_name(tmp_path, monkeypatch):
    """Each name resolves to the JAX package's class over the same cache,
    with the same length, conformer count and first item; each directory
    holds other molecules (its own seed), so a wrong directory shows."""
    for seed, sub in enumerate(sorted({d for d in ROUTED.values() if d})):
        write_synthetic_cache(str(tmp_path / sub / "processed.npz"),
                              num=20 + seed, num_targets=19,
                              num_conformers=2, seed=seed, split="random")
    monkeypatch.setenv("INFOMAX3D_DATA", str(tmp_path))
    for name in ROUTED:
        over = dict(dataset=name, dataset_params={"num": 20}
                    if name == "synthetic" else {})
        ds = build_dataset(load_config(None, over))
        ref = jax_build_dataset(jax_load_config(None, over))
        assert type(ds).__name__ == type(ref).__name__, name
        assert (len(ds), ds.num_conformers) == \
            (len(ref), ref.num_conformers), name
        a, b = ds[0], ref[0]
        assert a.keys() == b.keys(), name
        for k, v in a["graph2d"].items():
            np.testing.assert_array_equal(v, b["graph2d"][k], err_msg=name)
        np.testing.assert_array_equal(a["targets"], b["targets"])
    with pytest.raises(KeyError, match="unknown dataset"):
        build_dataset(load_config(None, dict(dataset="nope")))


QM9_OVERRIDES = dict(num_epochs=2, use_tensorboard=False, batch_size=16,
                     num_train=64, log_iterations=1)


def _qm9_widths(path):
    """The config's models at tiny widths."""
    base = load_config(path, {})
    ov = {"model_parameters": dict(base["model_parameters"], **TINY)}
    if base.get("model3d_parameters"):
        ov["model3d_parameters"] = dict(base["model3d_parameters"], **TINY3D)
    return ov


def _qm9_config(path):
    return dict(QM9_OVERRIDES, **_qm9_widths(path))


@pytest.fixture(scope="module")
def qm9_runs(data_root, tmp_path_factory):
    d = tmp_path_factory.mktemp("qm9cli")
    pre_cfg, tune_cfg = (f"{CONFIG_DIR}/pre-train_QM9.yml",
                         f"{CONFIG_DIR}/tune_QM9_homo.yml")
    pre = _qm9_config(pre_cfg)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("INFOMAX3D_DATA", str(data_root))
        out = {"jax_pre": _run_jax(pre_cfg, pre, str(d / "jax_pre"))}
        out["jax_pre_w"] = _run_jax(pre_cfg, pre, str(d / "jax_pre_w"), True)
        init = out["jax_pre"]["init"]
        out["port_pre"] = _run_port(pre_cfg, pre, str(d / "port_pre"), init)
        out["port_pre_w"] = _run_port(pre_cfg, pre, str(d / "port_pre_w"),
                                      init, True)
        # the warmup's three phases (batch_norm, new, transferred) cut
        # from [700, 700, 390] to [3, 3, 3], so each group unlocks in turn
        tune = dict(_qm9_config(tune_cfg),
                    pretrain_checkpoint=out["port_pre"]["best"],
                    lr_scheduler_params=dict(load_config(tune_cfg, {})[
                        "lr_scheduler_params"], warmup_steps=[3, 3, 3]))
        out["jax_tune"] = _run_jax(tune_cfg, tune, str(d / "jax_tune"))
        out["jax_tune_w"] = _run_jax(tune_cfg, tune, str(d / "jax_tune_w"),
                                     True)
        init = out["jax_tune"]["init"]
        out["port_tune"] = _run_port(tune_cfg, tune, str(d / "port_tune"),
                                     init)
        out["port_tune_w"] = _run_port(tune_cfg, tune,
                                       str(d / "port_tune_w"), init, True)
    return out


def test_qm9_cache_pretrain_against_jax(qm9_runs):
    assert qm9_runs["port_pre"]["result"].keys() >= {"NTXent"}
    want = _first_loss(qm9_runs["jax_pre"]["records"], 2, "NTXent")
    got = _first_loss(qm9_runs["port_pre"]["records"], 2, "NTXent")
    assert abs(got - want) <= FIRST_LOSS_TOL * abs(want)
    assert _metric_violations(qm9_runs, "pre") == []


def test_qm9_cache_tune_against_jax(qm9_runs):
    res = qm9_runs["port_tune"]["result"]
    assert {"mae_denormalized", "homo", "test_mae_denormalized"} <= set(res)
    want = _first_loss(qm9_runs["jax_tune"]["records"], 2, "L1Loss")
    got = _first_loss(qm9_runs["port_tune"]["records"], 2, "L1Loss")
    assert abs(got - want) <= FIRST_LOSS_TOL * abs(want)
    assert _metric_violations(qm9_runs, "tune") == []

    def count(text):
        line = next(x for x in text.splitlines()
                    if x.startswith("transferred "))
        return int(line.split()[1])
    assert count(qm9_runs["port_tune"]["text"]) == \
        count(qm9_runs["jax_tune"]["text"]) > 0


# ------------------------------------------------ the real QM9 slice

@pytest.fixture(scope="module")
def qm9_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("qm9real")
    preprocess_qm9(FIXTURE, str(root / "QM9" / "processed.npz"))
    return root


def test_real_slice_cache_layout(qm9_root):
    z = np.load(str(qm9_root / "QM9" / "processed.npz"))
    assert z["atom_slices"].shape == (13,)
    assert z["atom_slices"][1] == 5 and z["edge_slices"][1] == 8
    assert z["atom_features"].shape[1] == 9
    assert z["edge_features"].shape[1] == 3
    assert z["targets"].shape == (12, 19)
    c = z["coordinates"][:5]
    assert abs(np.linalg.norm(c[1] - c[0]) - 1.0902) < 1e-3
    af = z["atom_features"]
    assert af[0, 0] == 5 and af[0, 2] == 4 and af[0, 6] == 2
    a0 = int(z["atom_slices"][3])
    assert af[a0, 0] == 5 and af[a0, 6] == 0
    r0 = int(z["atom_slices"][11])
    assert af[r0, 8] == af[r0 + 1, 8] == af[r0 + 2, 8] == 1
    assert af[0, 8] == 0


def test_real_slice_units_and_normalization(qm9_root):
    ds = QM9Dataset(str(qm9_root / "QM9" / "processed.npz"),
                    target_tasks=["homo", "r2"], normalize=True)
    assert ds.ev2mev.tolist() == [1000.0, 1.0]
    denorm = ds.targets * ds.targets_std + ds.targets_mean
    np.testing.assert_allclose(denorm[0, 0], -0.3877 * HAR2EV, rtol=1e-5)
    np.testing.assert_allclose(denorm[0, 1], 35.36, rtol=1e-5)
    np.testing.assert_allclose(ds.targets.mean(axis=0), 0.0, atol=1e-5)
    np.testing.assert_allclose(ds.targets.std(axis=0), 1.0, atol=1e-4)


def test_real_slice_pretrain_and_finetune(qm9_root, tmp_path, monkeypatch):
    monkeypatch.setenv("INFOMAX3D_DATA", str(qm9_root))
    small = dict(num_epochs=1, patience=2, use_tensorboard=False,
                 eval_per_epochs=0, log_iterations=-1, batch_size=2,
                 num_train=8, num_val=2)
    pre, tune = (f"{CONFIG_DIR}/pre-train_QM9.yml",
                 f"{CONFIG_DIR}/tune_QM9_homo.yml")
    res = train(load_config(pre, dict(small, **_qm9_widths(pre),
                                      logdir=str(tmp_path / "pre"))),
                device="cpu")
    assert np.isfinite(res["NTXent"])
    ckpt, = glob.glob(str(tmp_path / "pre" / "*" / "best_checkpoint.pt"))
    res = train(load_config(tune, dict(small, **_qm9_widths(tune),
                                       logdir=str(tmp_path / "tune"),
                                       pretrain_checkpoint=ckpt)),
                device="cpu")
    ds = QM9Dataset(str(qm9_root / "QM9" / "processed.npz"),
                    target_tasks=["homo"])
    scale_mev = float(ds.targets_std[0]) * 1000.0
    assert np.isfinite(res["mae_denormalized"])
    assert 0.01 * scale_mev < res["mae_denormalized"] < 100 * scale_mev


@pytest.mark.parametrize("sampler", ["ConstantNumberAtomsCategorical",
                                     "ConstantNumberAtomsChunks"])
def test_train_sampler_batches_match_jax(sampler, data_root, monkeypatch):
    """`train_sampler` gives the train loader the JAX loader's batches;
    `bucket_ladder` leaves this contrastive config on its static bucket,
    as the JAX CLI builds no ladder for its collate."""
    from infomax3d_tpu.cli import train as jax_cli
    from infomax3d_tpu_torch.cli import train as port_cli
    monkeypatch.setenv("INFOMAX3D_DATA", str(data_root))
    over = dict(batch_size=16, num_train=64, train_sampler=sampler)
    args = load_config(f"{CONFIG_DIR}/pre-train_QM9.yml", over)
    ref_args = jax_load_config(f"{CONFIG_DIR}/pre-train_QM9.yml", over)
    ds, ref = build_dataset(args), jax_build_dataset(ref_args)
    port_cli.resolve_fast_paths(args)
    jax_cli.resolve_fast_paths(ref_args)
    tr = port_cli.make_loaders(args, ds)[0]
    ref_tr = jax_cli.make_loaders(ref_args, ref)[0]
    assert tr.batch_sampler is not None and len(tr) == len(ref_tr) == 4
    for _ in range(2):
        assert list(tr.batch_sampler) == list(ref_tr.batch_sampler)
    batch = next(iter(tr))
    assert batch["graph2d"]["graph_mask"].sum() == 16
    laddered = port_cli.make_loaders(dict(args, bucket_ladder=True), ds)[0]
    ref_laddered = jax_cli.make_loaders(dict(ref_args, bucket_ladder=True),
                                        ref)[0]
    assert laddered.ladder is None and ref_laddered.ladder is None
    assert laddered.bucket == tr.bucket
