"""BYOL on the CPU against the JAX package: `CosineSimilarityLoss` and its
gradient, the `BYOLWrapper` forward, two steps of the port's
`BYOLTrainer` (the teachers in train mode without autograd, the EMA after
each update, by default of the 2D teacher only, with `byol_ema_all` of
both) against a bare JAX `BYOLTrainer`'s `loss_fn`, `GroupedOptimizer`
and `_post_update`, a checkpoint round trip through the port's trainer
that restores the teachers, and the fine-tune transfer from a BYOL
checkpoint.  Small sizes: `configs/byol.yml`'s models at width 10 (PNA,
2 layers) and 8 (the flat Net3D, 1 layer), predictors of 2 layers with
BatchNorm, 8 synthetic QM9-like molecules (10 to 26 atoms); every input
from numpy seeds and `init_jax_variables`.  The JAX models read the JAX
collate's batches (no CSR: the XLA segment path), the port's its CSR
batches.

Tolerances (the worst reading on this data in brackets, port / JAX
float32, each against the JAX float64 step):

* the loss: 1e-6 relative to JAX's value, its gradient 1e-6 of its max;
* the wrapper's forward: 1e-5 of the output's max, both outputs [1.5e-6];
* the steps, float32, held to the same JAX steps evaluated in float64,
  as `test_torch_port_pretrain_baselines.py` holds its steps: each kind
  of reading (the loss; each model's live gradient leaves; each model's
  running statistics; each teacher's parameters; each teacher's running
  statistics), each relative to its own max, within twice the JAX
  float32 steps' own worst distance to float64 over that kind, at least
  1e-5 [loss 3.7e-7 / 1.1e-6, leaves 3.5e-4 / 3.2e-4, statistics 6.4e-3
  / 7.6e-3 (the PNA std's near-constant columns), teachers 1.6e-3 /
  1.9e-3 (Adam's first steps move a weight by lr times its gradient's
  sign, which rounding flips where the gradient is at rounding level),
  teacher statistics 6.4e-4 / 7.6e-4]; leaves whose float64 gradient is
  below 1e-6 of the model's largest within 1e-5 of it; the 3D teacher's
  parameters equal to their initial values where the EMA leaves it.  A
  planted fault (the teacher in eval mode, the EMA on both teachers by
  default, the loss pairing each prediction with its own side's
  projection) fails this check.
"""
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from infomax3d_tpu.losses import get_loss as jax_get_loss
from infomax3d_tpu.models import get_model_class as jax_model_class
from infomax3d_tpu.train import trainer as jax_trainer
from infomax3d_tpu.train.optim import GroupedOptimizer
from infomax3d_tpu.train.optim import label_params as jax_label_params
from infomax3d_tpu.train.state import TrainState
from infomax3d_tpu_torch.interop import (init_jax_variables, load_variables,
                                         params_from_jax)
from infomax3d_tpu_torch.losses import get_loss
from infomax3d_tpu_torch.models.registry import build_model
from infomax3d_tpu_torch.train import byol as port_byol
from infomax3d_tpu_torch.train import trainer as port_trainer
from infomax3d_tpu_torch.train.precision import forward_in
from test_torch_port_conformers import _jax_float64, _to64
from test_torch_port_egnn import _round_trip
from test_torch_port_ot import _jax_tree, _rel
from test_torch_port_pretrain_baselines import _items, _views

LR = 1e-3
DECAY = 0.9
STEPS = 2
STEP_FLOOR = 1e-5
# configs/byol.yml's wrappers at a small size (its predictor of one layer
# has no BatchNorm to run; two layers exercise it)
PNA = dict(target_dim=8, hidden_dim=10, mid_batch_norm=True,
           last_batch_norm=True, readout_batchnorm=True,
           batch_norm_momentum=0.96, readout_hidden_dim=10,
           readout_layers=0, dropout=0.0, propagation_depth=2,
           aggregators=["mean", "max", "min", "std"],
           scalers=["identity", "amplification", "attenuation"],
           readout_aggregators=["min", "max", "mean"], pretrans_layers=2,
           posttrans_layers=1, residual=True)
NET3D = dict(target_dim=8, hidden_dim=8,
             node_wise_output_layers=0, message_net_layers=1,
             update_net_layers=1, reduce_func="mean", fourier_encodings=4,
             propagation_depth=1, dropout=0.0, batch_norm=True,
             readout_batchnorm=True, batch_norm_momentum=0.96,
             readout_hidden_dim=8, readout_layers=1,
             readout_aggregators=["min", "max", "mean"])
PREDICTOR = dict(predictor_layers=2, predictor_hidden_size=12,
                 predictor_batchnorm=True, metric_dim=8, ma_decay=DECAY)
WRAPPERS = {"model": dict(PREDICTOR, model_type="PNA", model_parameters=PNA),
            "model3d": dict(PREDICTOR, model_type="Net3D",
                            model_parameters=NET3D)}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _wrapper_fields(mp):
    return {k: v for k, v in mp.items() if k != "ma_decay"}


def _variables():
    return {k: dict(zip(("params", "batch_stats"), init_jax_variables(
        mp, 5 + i, "BYOLwrapper"))) for i, (k, mp) in
        enumerate(WRAPPERS.items())}


def test_cosine_similarity_loss_matches_jax():
    """The loss and its gradient against JAX; and the loss with a zero
    row, whose norm clamps at 1e-12 (its gradient is NaN in JAX, where
    the norm's is 0 / 0, and 0 in torch, so only the value is held)."""
    rng = np.random.default_rng(0)
    z1 = rng.normal(size=(7, 5)).astype(np.float32)
    z2 = rng.normal(size=(7, 5)).astype(np.float32)
    jl = jax_get_loss("CosineSimilarityLoss")
    want, (g1, g2) = jax.value_and_grad(lambda a, b: jl(a, b), (0, 1))(
        jnp.asarray(z1), jnp.asarray(z2))
    t1, t2 = (torch.tensor(z, requires_grad=True) for z in (z1, z2))
    got = get_loss("CosineSimilarityLoss")(t1, t2)
    got.backward()
    assert abs(got.item() - float(want)) <= 1e-6 * abs(float(want))
    for t, g in ((t1, g1), (t2, g2)):
        assert _rel(t.grad.numpy(), np.asarray(g)) <= 1e-6
    z1[3] = 0.0
    want = float(jl(jnp.asarray(z1), jnp.asarray(z2)))
    got = get_loss("CosineSimilarityLoss")(torch.tensor(z1),
                                           torch.tensor(z2)).item()
    assert abs(got - want) <= 1e-6 * abs(want)


@pytest.fixture(scope="module")
def views():
    return _views("contrastive_collate", _items())


@pytest.mark.parametrize("key", sorted(WRAPPERS))
def test_wrapper_forward_matches_jax(views, key):
    """Both outputs of each wrapper (prediction, projection) in eval mode
    against the JAX `BYOLWrapper` from the same weights, whose tree has
    the JAX init's shapes; the state_dict through the JAX converter."""
    _, port, jview = views
    side = "graph2d" if key == "model" else "graph3d"
    mp = _wrapper_fields(WRAPPERS[key])
    var = _variables()[key]
    jm = jax_model_class("BYOLwrapper")(**mp)
    shapes = jax.eval_shape(jm.init, jax.random.key(0), jview[side])
    assert jax.tree_util.tree_map(np.shape, shapes["params"]) == \
        jax.tree_util.tree_map(np.shape, var["params"])
    model = load_variables(build_model("BYOLwrapper", mp), var).eval()
    _round_trip(model, var)
    with torch.no_grad():
        got = model(port[side])
    want = jm.apply({k: _jax_tree(v) for k, v in var.items()}, jview[side])
    for a, b in zip(got, want):
        assert _rel(a.numpy(), np.asarray(b)) <= 1e-5


def _jax_steps(jview, variables, ema_all):
    """`STEPS` steps of a bare JAX `BYOLTrainer`: its `loss_fn` under
    `value_and_grad`, a `GroupedOptimizer` Adam update, the teachers'
    statistics into `extra` and `_post_update`'s EMA, as its jitted step
    runs them.  Per step the readings named as the port's state_dicts:
    loss, gradients and running statistics ``<model>.<name>``, teachers
    ``teacher.<model>.<name>``."""
    tr = jax_trainer.BYOLTrainer.__new__(jax_trainer.BYOLTrainer)
    tr.models = {k: jax_model_class("BYOLwrapper")(**_wrapper_fields(mp))
                 for k, mp in WRAPPERS.items()}
    tr.loss_func = jax_get_loss("CosineSimilarityLoss")
    tr.compute_dtype, tr.args, tr.mesh = None, {}, None
    tr.ma_decay = DECAY
    tr.ema_keys = tr.MODEL_KEYS if ema_all else ("model",)
    tree = lambda t: jax.tree_util.tree_map(jnp.asarray, t)  # noqa: E731
    params = {k: tree(v["params"]) for k, v in variables.items()}
    stats = {k: tree(v["batch_stats"]) for k, v in variables.items()}
    labels, _ = jax_label_params(params)
    opt = GroupedOptimizer(labels, name="Adam", lr=LR)
    state = TrainState(params=params, batch_stats=stats,
                       opt_state=opt.init(params), step=jnp.zeros([],
                                                                  jnp.int32),
                       extra=tr._init_extra(params, stats))

    def lf(p, st, extra):
        tr._loss_fn_extra = extra
        loss, _, new_stats = tr.loss_fn(p, st, jview, 0, jax.random.key(0),
                                        True)
        return loss, new_stats
    grad_fn = jax.jit(jax.value_and_grad(lf, has_aux=True))
    np_ = lambda t: jax.tree_util.tree_map(  # noqa: E731
        lambda v: np.asarray(v, np.float32), t)
    out = []
    for _ in range(STEPS):
        (loss, new_stats), grads = grad_fn(state.params, state.batch_stats,
                                           state.extra)
        upd, opt_state = opt.update(grads, state.opt_state, state.params,
                                    np.array([LR, LR, LR, 0.0], np.float32))
        extra_upd = new_stats.pop("_extra")
        state = tr._post_update(state.replace(
            params=jax.tree_util.tree_map(lambda a, b: a + b, state.params,
                                          upd),
            opt_state=opt_state, batch_stats=new_stats, step=state.step + 1,
            extra={**state.extra, **extra_upd}))
        r = {"loss": float(loss)}
        for k in WRAPPERS:
            sd = params_from_jax(np_(grads[k]), np_(state.batch_stats[k]))
            r.update({f"{k}.{n}": v.numpy() for n, v in sd.items()
                      if "num_batches" not in n})
            teacher = params_from_jax(np_(state.extra["teacher"][k]),
                                      np_(state.extra["teacher_stats"][k]))
            r.update({f"teacher.{k}.{n[len('student.'):]}": v.numpy()
                      for n, v in teacher.items()
                      if "num_batches" not in n})
        out.append(r)
    return out


def _port_steps(view, variables, ema_all, tmp_path, fault=None):
    """`STEPS` steps of the port's `BYOLTrainer` (its `_train_step`, the
    EMA included), read as `_jax_steps` reads the JAX ones.  `fault`
    plants a fault into the trainer first."""
    models = {k: build_model("BYOLwrapper", mp) for k, mp in WRAPPERS.items()}
    tr = port_trainer.get_trainer_class("byol")(
        models, {"optimizer": "Adam", "optimizer_params": {"lr": LR},
                 "bf16_compute": False}, metrics={}, main_metric="loss",
        run_dir=str(tmp_path), loss_func=get_loss("CosineSimilarityLoss"),
        loss_name="CosineSimilarityLoss", device="cpu",
        use_tensorboard=False, init_variables=variables, ma_decay=DECAY,
        ema_all=ema_all)
    tr.init_state()
    if fault is not None:
        fault(tr.step)
    out = []
    for _ in range(STEPS):
        tr._write_lrs()
        loss, _ = tr._train_step(tr._prepare(view))
        r = {"loss": float(loss)}
        for k, m in models.items():
            assert all(p.grad is not None for p in m.parameters())
            r.update({f"{k}.{n}": p.grad.numpy().copy()
                      for n, p in m.named_parameters()})
            r.update({f"{k}.{n}": b.numpy().copy()
                      for n, b in m.named_buffers() if "running" in n})
            r.update({f"teacher.{k}.{n}": v.numpy().copy() for n, v in
                      tr.step.teachers[k].state_dict().items()
                      if "num_batches" not in n})
        out.append(r)
    tr.logger.close()
    return out, tr


def _rel64(got, ref):
    return float(np.abs(np.asarray(got, np.float64) - ref).max()
                 / max(np.abs(ref).max(), 1e-30))


def _violations(got, want, want64) -> list:
    """What the port's steps break of the step check (module docstring),
    step by step."""
    bad = []
    for step, (g, w, w64) in enumerate(zip(got, want, want64)):
        assert g.keys() == w.keys() == w64.keys()

        def held(keys, what):
            tol = max(2.0 * max(_rel64(w[k], w64[k]) for k in keys),
                      STEP_FLOOR)
            bad.extend(f"step {step} {what} {k}: {_rel64(g[k], w64[k]):.3g}"
                       f" > {tol:.3g}" for k in keys
                       if _rel64(g[k], w64[k]) > tol)
        held(["loss"], "loss")
        for side in WRAPPERS:
            own = [k for k in w if k.startswith(side + ".")]
            grads = [k for k in own if "running" not in k]
            gmax = max(np.abs(w64[k]).max() for k in grads)
            zero = {k for k in grads if np.abs(w64[k]).max() < 1e-6 * gmax}
            bad.extend(f"step {step} zero leaf {k}" for k in zero
                       if np.abs(g[k]).max() > STEP_FLOOR * gmax)
            held([k for k in grads if k not in zero], "leaf")
            held([k for k in own if "running" in k], "statistics")
            teacher = [k for k in w if k.startswith(f"teacher.{side}.")]
            held([k for k in teacher if "running" not in k], "teacher")
            held([k for k in teacher if "running" in k], "teacher statistics")
    return bad


@pytest.fixture(scope="module")
def jax_runs(views):
    """The JAX steps, float32 and float64, with the EMA on the 2D teacher
    alone (the default) and on both."""
    _, _, jview = views
    variables = _variables()
    out = {}
    for ema_all in (False, True):
        want = _jax_steps(jview, variables, ema_all)
        with _jax_float64():
            want64 = _jax_steps(_to64(jview), jax.tree_util.tree_map(
                lambda x: np.asarray(x, np.float64), variables), ema_all)
        out[ema_all] = (want, want64)
    return out


@pytest.mark.parametrize("ema_all", [False, True], ids=["ema_2d", "ema_all"])
def test_two_steps_match_jax(views, jax_runs, ema_all, tmp_path):
    """Two steps of the port's `BYOLTrainer` against the JAX trainer's
    (module docstring): loss, gradients, running statistics, teachers;
    the 3D teacher's parameters stay at their initial values unless
    `ema_all`, while its running statistics move."""
    view, _, _ = views
    want, want64 = jax_runs[ema_all]
    got, tr = _port_steps(view, _variables(), ema_all, tmp_path)
    assert _violations(got, want, want64) == []
    init = params_from_jax(_variables()["model3d"]["params"]["student"], {})
    teacher3 = tr.step.teachers["model3d"].state_dict()
    frozen = all(torch.equal(teacher3[n], v) for n, v in init.items())
    assert frozen is not ema_all
    stats = {n for n in teacher3 if "running_mean" in n}
    assert stats and all(not np.array_equal(
        got[0][f"teacher.model3d.{n}"], got[1][f"teacher.model3d.{n}"])
        for n in stats)


def _teacher_in_eval(step):
    def projections(g2, g3):
        with torch.no_grad():
            return [forward_in(step.teachers[k].eval(), step.compute_dtype,
                               g).float()
                    for k, g in (("model", g2), ("model3d", g3))]
    step.teacher_projections = projections


def _ema_on_both(step):
    step.ema_keys = ("model", "model3d")


def _own_side_pairing(step):
    def loss(self, g2, g3):
        pred2, _ = forward_in(self.model, self.compute_dtype, g2)
        pred3, _ = forward_in(self.model3d, self.compute_dtype, g3)
        proj2_t, proj3_t = self.teacher_projections(g2, g3)
        return (self.loss_fn(pred2, proj2_t) + self.loss_fn(proj3_t, pred3),
                (pred2, pred3))
    step.loss = types.MethodType(loss, step)


@pytest.mark.parametrize("fault", [_teacher_in_eval, _ema_on_both,
                                   _own_side_pairing],
                         ids=["teacher_eval", "ema_both", "own_side"])
def test_step_check_fails_planted_faults(views, jax_runs, fault, tmp_path):
    view, _, _ = views
    want, want64 = jax_runs[False]
    got, _ = _port_steps(view, _variables(), False, tmp_path, fault)
    assert _violations(got, want, want64)


# ------------------------------------------- checkpoints and the transfer

def _byol_args(tmp_path, **over):
    """`configs/byol.yml` at the small size, 2 epochs of 4 steps (100 synthetic
    molecules, 32 to train), batch 8, on the CPU."""
    from infomax3d_tpu_torch.cli.config import load_config
    args = load_config("configs/byol.yml", dict(
        dataset="synthetic", dataset_params={"num": 100, "n_min": 10,
                                             "n_max": 26},
        batch_size=8, num_epochs=2, log_iterations=1, num_train=32,
        logdir=str(tmp_path), use_tensorboard=False, device="cpu",
        model_parameters=WRAPPERS["model"],
        model3d_parameters=WRAPPERS["model3d"], **over))
    return args


@pytest.fixture(scope="module")
def byol_run(tmp_path_factory):
    """A 2-epoch BYOL run through the port's CLI: its run directory."""
    import glob
    from infomax3d_tpu_torch.cli.train import train
    tmp = tmp_path_factory.mktemp("byol_run")
    result = train(_byol_args(tmp))
    assert np.isfinite(result["CosineSimilarityLoss"])
    return glob.glob(str(tmp / "BYOLwrapper_*"))[0]


def test_checkpoint_carries_and_restores_the_teachers(byol_run, tmp_path):
    """`last_checkpoint.pt` holds each teacher under ``teacher.`` in its
    model's state_dict (parameters and running statistics); a run
    resumed from it restores the students, the teachers and the
    step count."""
    from infomax3d_tpu_torch.cli import train as cli
    from infomax3d_tpu_torch.train import checkpoint
    payload = checkpoint.load_checkpoint(f"{byol_run}/last_checkpoint.pt")
    for key in ("model_state_dict", "model3d_state_dict"):
        sd = payload[key]
        teacher = {n for n in sd if n.startswith("teacher.")}
        student = {n for n in sd if n.startswith("student.")}
        assert {"teacher." + n[len("student."):] for n in student} == teacher
        assert any("running_mean" in n for n in teacher)
    # the EMA leaves the 2D teacher apart from its student
    sd2 = payload["model_state_dict"]
    assert any(not torch.equal(sd2[n], sd2["student." + n[8:]])
               for n in sd2 if n.startswith("teacher.")
               and "running" not in n and "num_batches" not in n)
    args = _byol_args(tmp_path, checkpoint=f"{byol_run}/last_checkpoint.pt")
    cli.resolve_collate(args)
    cli.resolve_fast_paths(args)
    models = cli.build_models(args)
    tr = port_trainer.get_trainer_class("byol")(
        models, args, metrics={}, main_metric="loss", run_dir=str(tmp_path),
        loss_func=get_loss("CosineSimilarityLoss"),
        loss_name="CosineSimilarityLoss", device="cpu",
        use_tensorboard=False)
    tr.init_state()
    assert tr.start_epoch == 3 and tr.optim_steps == payload["optim_steps"]
    for key, pk in (("model", "model_state_dict"),
                    ("model3d", "model3d_state_dict")):
        for n, v in tr.step.teachers[key].state_dict().items():
            assert torch.equal(v, payload[pk]["teacher." + n]), n
        for n, v in models[key].state_dict().items():
            assert torch.equal(v, payload[pk][n]), n
    tr.logger.close()


def _jax_byol_checkpoint(path, variables, teachers):
    """A JAX `BYOLTrainer` checkpoint (flax msgpack of its TrainState) of
    the wrappers' `variables`, with `teachers` (wrapper trees without
    their predictors) in ``extra``."""
    from flax import serialization
    strip = lambda t: {k: v for k, v in t.items()  # noqa: E731
                       if k != "predictor"}
    path.write_bytes(serialization.msgpack_serialize({
        "params": {k: v["params"] for k, v in variables.items()},
        "batch_stats": {k: v["batch_stats"] for k, v in variables.items()},
        "opt_state": {}, "step": 0,
        "extra": {"teacher": {k: strip(v["params"])
                              for k, v in teachers.items()},
                  "teacher_stats": {k: strip(v["batch_stats"])
                                    for k, v in teachers.items()}}}))
    return str(path)


def test_teachers_from_a_jax_checkpoint(tmp_path):
    """`jax_teacher_variables` reads each teacher of a JAX BYOL
    checkpoint's ``extra`` into a `BYOLStep`'s teacher module strictly,
    parameters and running statistics."""
    from infomax3d_tpu_torch.train import torch_interop as ti
    variables = _variables()
    teachers = {k: dict(zip(("params", "batch_stats"), init_jax_variables(
        mp, 20 + i, "BYOLwrapper"))) for i, (k, mp) in
        enumerate(WRAPPERS.items())}
    tree = ti.load_jax_checkpoint(_jax_byol_checkpoint(
        tmp_path / "byol.msgpack", variables, teachers))
    step = port_byol.BYOLStep.from_modules(
        *(load_variables(build_model("BYOLwrapper", _wrapper_fields(mp)),
                         variables[k]) for k, mp in WRAPPERS.items()),
        "cpu", None, get_loss("CosineSimilarityLoss"))
    for k, teacher in step.teachers.items():
        load_variables(teacher, ti.jax_teacher_variables(tree, k))
        want = params_from_jax(teachers[k]["params"]["student"],
                               teachers[k]["batch_stats"]["student"])
        got = teacher.state_dict()
        assert got.keys() == want.keys()
        for n, v in want.items():
            assert torch.equal(got[n], v), n
    with pytest.raises(KeyError, match="no BYOL teacher"):
        ti.jax_teacher_variables({"extra": {}}, "model")


@pytest.mark.parametrize("fmt", ["pt", "msgpack"])
def test_finetune_transfer_from_a_byol_checkpoint(byol_run, fmt, tmp_path):
    """`transfer_pretrained` from a BYOL checkpoint into a plain PNA of
    the student's shape: the run's `.pt` (the students' ``student.``
    prefix stripped) or a JAX one (the ``student`` subtree unwrapped),
    every ``node_gnn`` tensor of the student copied, nothing of the
    teachers."""
    from infomax3d_tpu_torch.cli.train import transfer_pretrained
    from infomax3d_tpu_torch.train import checkpoint
    if fmt == "pt":
        path = f"{byol_run}/best_checkpoint.pt"
        sd = checkpoint.load_checkpoint(path)["model_state_dict"]
    else:
        variables = _variables()
        teachers = {k: dict(zip(("params", "batch_stats"),
                                init_jax_variables(mp, 30, "BYOLwrapper")))
                    for k, mp in WRAPPERS.items()}
        path = _jax_byol_checkpoint(tmp_path / "byol.msgpack", variables,
                                    teachers)
        sd = params_from_jax(variables["model"]["params"],
                             variables["model"]["batch_stats"])
    model = build_model("PNA", PNA)
    count = transfer_pretrained(types.SimpleNamespace(
        models={"model": model}), {"pretrain_checkpoint": path,
                                   "transfer_layers": ["node_gnn"],
                                   "exclude_from_transfer": []})
    got = model.state_dict()
    names = [n for n in got if n.startswith("node_gnn.")
             and "num_batches" not in n]
    assert count == len([n for n, _ in model.named_parameters()
                         if n.startswith("node_gnn.")])
    for n in names:
        assert torch.equal(got[n], sd["student." + n]), n


def test_chip_smoke_phase25_counts_the_configs_launches():
    """Phase 25's expected launches per bf16 step of (a) `byol.yml` and (b)
    `0.yml` (`_s18_launches`, read off the configs' depths) equal the
    kernel wrappers' dispatches of one bf16 step of each at the configs'
    widths, counted on the CPU (where each dispatch runs the plain
    version), on 4 molecules."""
    import collections
    import importlib.util
    from pathlib import Path
    from infomax3d_tpu_torch.ops.kernels import _build
    root = Path(__file__).resolve().parents[1]
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  root / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    calls = collections.Counter()
    real = _build.on_card

    def counting(t, name):
        calls[name] += 1
        return real(t, name)
    _build.on_card = counting
    try:
        for kind in ("a", "b"):
            g, _ = cs._s18_batch(kind, "cpu", 4)
            step = cs._s18_step(kind, True, "cpu")
            calls.clear()
            step.step(*step.prepare(*g))
            want = {n: c for n, c in cs._s18_launches(kind, True).items()
                    if c}
            assert dict(calls) == want, kind
    finally:
        _build.on_card = real
