"""The contrastive trainer's other flavours on the CPU against the JAX
package: two steps each of the port's `SelfSupervisedAlternatingTrainer`,
`NoisyNegativesTrainer` (`noised_distances_collate`,
`NTXentExtraNegatives`) and `PhilosophyTrainer` (`Critic`, `CriticLoss`,
three optimizers) against bare JAX trainers of the same classes (their
`loss_fn` under `value_and_grad` and a `GroupedOptimizer` Adam update,
or for philosophy its own jitted `_make_train_step`), a planted fault per
flavour that the check must catch, the noisy-negatives trainer's refusal
of several noised copies (the JAX trainer fails on them too), and two
CLI runs: a philosophy pre-training and `configs/
tune_from_ot_geomoL_feat.yml` (`GeomolGNNWrapper` on `qm9_geomol`'s float
features), first from scratch, then from the first run's checkpoint with
its ``gnn.`` transfer.  Small sizes: PNA 10 wide and the flat Net3D 8
wide, 2 and 1 layers, BatchNorm everywhere, 8 synthetic QM9-like
molecules; the JAX models read the JAX collate's batches, the port's its
CSR batches.

Each step's readings: the loss (and the philosophy step's philosopher
and critic losses), each within twice the JAX float32 step's own
distance from the JAX float64 step, at least 1e-5 of the loss; per
model, Adam's first moment (0.1 of the first step's gradient) and the
running statistics, each kind held to the JAX float64 step within twice
the JAX float32 step's worst distance from it over that kind, at least
1e-4 (the float32 sums over the edge rows run in another order in each
package, and the PNA std's ``E[x^2] - mean^2`` is ill-conditioned at
near-constant columns, as `test_torch_port_pna_original.py` found),
relative to each reading's max; a moment whose float64 value is below
1e-6 of its model's largest (a bias feeding a BatchNorm: its exact
gradient is 0) within 1e-5 of that largest instead.  The parameters
move by at most the learning rate per step, sign-like in Adam's first
steps (where a gradient is at rounding level its sign may differ): each
within 2 lr per step of the JAX float32 step's, and within 1e-6 where
the float64 first moment exceeds 1e-2 of its leaf's max.  The learning
rate is 1e-5, so that those sign steps move the weights too little to
make the second step's gradients differ beyond float32 rounding.  Every
parameter of the side a step does not train gets a zero gradient and an
Adam step (the step count is 2 after two steps everywhere).
"""
import glob
import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from infomax3d_tpu.data.loader import get_collate as jax_get_collate
from infomax3d_tpu.losses import get_loss as jax_get_loss
from infomax3d_tpu.models import get_model_class as jax_model_class
from infomax3d_tpu.train import trainer as jax_trainer
from infomax3d_tpu.train.optim import GroupedOptimizer
from infomax3d_tpu.train.optim import label_params as jax_label_params
from infomax3d_tpu.train.state import TrainState
from infomax3d_tpu_torch.data.loader import get_collate
from infomax3d_tpu_torch.interop import init_jax_variables, params_from_jax
from infomax3d_tpu_torch.losses import get_loss
from infomax3d_tpu_torch.models.registry import build_model
from infomax3d_tpu_torch.train import trainer as port_trainer
from test_torch_port_conformers import _jax_float64, _to64
from test_torch_port_pretrain_baselines import _buckets, _items, _views

LR = 1e-5
STEPS = 2
FLOOR = 1e-5
STATS_FLOOR = 1e-4
FIRM = 1e-2
PNA = dict(target_dim=8, hidden_dim=10, mid_batch_norm=True,
           last_batch_norm=True, readout_batchnorm=True,
           batch_norm_momentum=0.9, readout_hidden_dim=10, readout_layers=2,
           propagation_depth=2, aggregators=["mean", "max", "min", "std"],
           scalers=["identity", "amplification", "attenuation"],
           readout_aggregators=["min", "max", "mean"], pretrans_layers=2,
           posttrans_layers=1, residual=True)
NET3D = dict(target_dim=8, hidden_dim=8, node_wise_output_layers=1,
             message_net_layers=1, update_net_layers=1, reduce_func="mean",
             fourier_encodings=4, propagation_depth=1, batch_norm=True,
             readout_batchnorm=True, batch_norm_momentum=0.9,
             readout_hidden_dim=8, readout_layers=1,
             readout_aggregators=["min", "max", "mean"])
CRITIC = dict(metric_dim=8, hidden_dim=12, layers=2, repeats=3)
MODELS = {"model": ("PNA", PNA), "model3d": ("Net3D", NET3D),
          "critic": ("Critic", CRITIC)}
FLAVOURS = {
    "alternating": dict(collate="contrastive_collate", loss="NTXent",
                        loss_params={"tau": 0.2}),
    "noisy_negatives": dict(collate="noised_distances_collate",
                            loss="NTXentExtraNegatives",
                            loss_params={"tau": 0.2,
                                         "extra_negatives_weight": 0.8}),
    "philosophy": dict(collate="contrastive_collate", loss="NTXent",
                       loss_params={"tau": 0.2}),
}
JAX_CLASSES = {"alternating": jax_trainer.SelfSupervisedAlternatingTrainer,
               "noisy_negatives": jax_trainer.NoisyNegativesTrainer,
               "philosophy": jax_trainer.PhilosophyTrainer}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _keys(flavour):
    return ("model", "model3d", "critic") if flavour == "philosophy" \
        else ("model", "model3d")


def _variables(flavour):
    out = {}
    for i, key in enumerate(_keys(flavour)):
        t, mp = MODELS[key]
        mp = dict(mp, in_dim=NET3D["target_dim"]) if key == "critic" else mp
        out[key] = dict(zip(("params", "batch_stats"),
                            init_jax_variables(mp, 5 + i, t)))
    return out


def _np(tree):
    return jax.tree_util.tree_map(lambda v: np.asarray(v, np.float32), tree)


def _readings(keys, loss, extra, moments, stats, params):
    """A step's readings, named as the port's (module docstring)."""
    r = {"loss": float(loss)}
    r.update({k: float(v) for k, v in extra.items()})
    for key in keys:
        r.update({f"m.{key}.{n}": v.numpy() for n, v in
                  params_from_jax(moments[key], {}).items()})
        r.update({f"{key}.{n}": v.numpy() for n, v in params_from_jax(
            {}, stats.get(key, {})).items() if "num_batches" not in n})
        r.update({f"p.{key}.{n}": v.numpy() for n, v in
                  params_from_jax(params[key], {}).items()})
    return r


def _jax_steps(flavour, jview, variables):
    """`STEPS` steps of a bare JAX trainer of `flavour` (module
    docstring); the readings after each."""
    case = FLAVOURS[flavour]
    tr = JAX_CLASSES[flavour].__new__(JAX_CLASSES[flavour])
    keys = _keys(flavour)
    tr.models = {k: jax_model_class(MODELS[k][0])(**MODELS[k][1])
                 for k in keys}
    tr.loss_func = jax_get_loss(case["loss"], **case["loss_params"])
    tr.compute_dtype, tr.args, tr.mesh = None, {}, None
    tree = lambda t: jax.tree_util.tree_map(jnp.asarray, t)  # noqa: E731
    params = {k: tree(v["params"]) for k, v in variables.items()}
    stats = {k: tree(v["batch_stats"]) for k, v in variables.items()}
    lrs = np.array([LR, LR, LR, 0.0], np.float32)
    out = []
    if flavour == "philosophy":
        tr.critic_loss_func = jax_get_loss("CriticLoss")
        tr.optims = {k: GroupedOptimizer(jax_label_params({k: params[k]})[0],
                                         name="Adam", lr=LR) for k in keys}
        state = TrainState(params=params, batch_stats=stats,
                           opt_state={k: tr.optims[k].init({k: params[k]})
                                      for k in keys},
                           step=jnp.zeros([], jnp.int32), extra=None)
        step_fn = tr._make_train_step()
        for _ in range(STEPS):
            state, loss, aux = step_fn(state, jview, {k: lrs for k in keys},
                                       jax.random.key(0))
            moments = {k: _np(tr.optims[k]._unravel(state.opt_state[k].m)[k])
                       for k in keys}
            out.append(_readings(keys, loss, aux.extra_losses, moments,
                                 _np(state.batch_stats), _np(state.params)))
        return out
    opt = GroupedOptimizer(jax_label_params(params)[0], name="Adam", lr=LR)
    opt_state = opt.init(params)

    def lf(p, st, step):
        loss, _, new_stats = tr.loss_fn(p, st, jview, step,
                                        jax.random.key(0), True)
        return loss, new_stats
    grad_fn = jax.jit(jax.value_and_grad(lf, has_aux=True))
    for step in range(STEPS):
        (loss, stats), grads = grad_fn(params, stats, step)
        upd, opt_state = opt.update(grads, opt_state, params, lrs)
        params = jax.tree_util.tree_map(lambda a, b: a + b, params, upd)
        moments = _np(opt._unravel(opt_state.m))
        out.append(_readings(keys, loss, {}, moments, _np(stats),
                             _np(params)))
    return out


def _port_trainer(flavour, variables, tmp_path):
    case = FLAVOURS[flavour]
    keys = _keys(flavour)
    models = {k: build_model(*MODELS[k], **({"in_dim": NET3D["target_dim"]}
                                            if k == "critic" else {}))
              for k in keys}
    kw = {"critic_loss": get_loss("CriticLoss")} \
        if flavour == "philosophy" else {}
    tr = port_trainer.get_trainer_class(flavour)(
        models, {"optimizer": "Adam", "optimizer_params": {"lr": LR},
                 "bf16_compute": False}, metrics={}, main_metric="loss",
        run_dir=str(tmp_path), loss_func=get_loss(case["loss"],
                                                  **case["loss_params"]),
        loss_name=case["loss"], device="cpu", use_tensorboard=False,
        init_variables=variables, **kw)
    tr.init_state()
    return tr, models


def _port_steps(flavour, view, variables, tmp_path, fault=None):
    """`STEPS` steps through the port's trainer (`_train_step`, the step
    count advanced as `train_epoch` advances it), read as `_jax_steps`
    reads the JAX ones."""
    tr, models = _port_trainer(flavour, variables, tmp_path)
    if fault is not None:
        fault(tr)
    opt = tr.optimizer
    out = []
    for _ in range(STEPS):
        tr._write_lrs()
        loss, outs = tr._train_step(tr._prepare(view))
        tr.optim_steps += 1
        r = {"loss": float(loss)}
        r.update(tr._extra_losses(outs))
        for key, m in models.items():
            assert all(p.grad is not None for p in m.parameters())
            state = (opt.optimizers[key] if flavour == "philosophy"
                     else opt).state
            assert all(int(state[p]["step"]) == len(out) + 1
                       for p in m.parameters())
            r.update({f"m.{key}.{n}": state[p]["exp_avg"].numpy().copy()
                      for n, p in m.named_parameters()})
            r.update({f"{key}.{n}": b.numpy().copy()
                      for n, b in m.named_buffers() if "running" in n})
            r.update({f"p.{key}.{n}": p.detach().numpy().copy()
                      for n, p in m.named_parameters()})
        out.append(r)
    tr.logger.close()
    return out


def _rel64(got, ref):
    ref = np.asarray(ref, np.float64)
    return float(np.abs(np.asarray(got, np.float64) - ref).max()
                 / max(np.abs(ref).max(), 1e-30))


def _violations(got, want, want64) -> list:
    """What the port's steps break of the step check (module docstring)."""
    bad = []
    for step, (g, w, w64) in enumerate(zip(got, want, want64)):
        assert g.keys() == w.keys() == w64.keys(), \
            set(g) ^ set(w)

        def held(keys, what, floor=FLOOR):
            if not keys:
                return
            tol = max(2.0 * max(_rel64(w[k], w64[k]) for k in keys), floor)
            bad.extend(f"step {step} {what} {k}: {_rel64(g[k], w64[k]):.3g}"
                       f" > {tol:.3g}" for k in keys
                       if _rel64(g[k], w64[k]) > tol)
        # the philosopher loss is the peasant loss minus the critic loss:
        # each loss is read relative to the peasant loss's size
        scale = abs(w64["loss"])
        for k in (k for k in w if "." not in k):
            tol = max(2.0 * abs(w[k] - w64[k]), FLOOR * scale)
            if abs(g[k] - w64[k]) > tol:
                bad.append(f"step {step} loss {k}: {abs(g[k] - w64[k]):.3g}"
                           f" > {tol:.3g}")
        for side in ("model", "model3d", "critic"):
            moments = [k for k in w if k.startswith(f"m.{side}.")]
            if not moments:
                continue
            mmax = max(np.abs(w64[k]).max() for k in moments)
            # a bias feeding a BatchNorm: its exact gradient is 0, its
            # float32 one rounding noise (Adam moves it by up to lr)
            zero = {k for k in moments if np.abs(w64[k]).max() < 1e-6 * mmax}
            bad.extend(f"step {step} zero leaf {k}" for k in zero
                       if np.abs(g[k]).max() > FLOOR * mmax)
            held([k for k in moments if k not in zero], "moment",
                 STATS_FLOOR)
            held([k for k in w if k.startswith(f"{side}.")], "statistics",
                 STATS_FLOOR)
            for k in (k for k in w if k.startswith(f"p.{side}.")):
                diff = np.abs(g[k] - w[k])
                if diff.max() > 2 * LR * (step + 1) * (1 + 1e-3):
                    bad.append(f"step {step} parameter {k}")
                m64 = np.abs(np.asarray(w64["m" + k[1:]]))
                firm = m64 > FIRM * m64.max()
                if "m" + k[1:] not in zero and firm.any() and \
                        diff[firm].max() > 1e-6 * max(np.abs(w[k]).max(),
                                                      1.0):
                    bad.append(f"step {step} firm parameter {k}")
    return bad


@pytest.fixture(scope="module")
def runs():
    """Per flavour: the port's batches and the JAX steps in float32 and
    float64."""
    out = {}
    for flavour, case in FLAVOURS.items():
        view, _, jview = _views(case["collate"], _items())
        variables = _variables(flavour)
        want = _jax_steps(flavour, jview, variables)
        with _jax_float64():
            want64 = _jax_steps(flavour, _to64(jview),
                                jax.tree_util.tree_map(
                                    lambda x: np.asarray(x, np.float64),
                                    variables))
        out[flavour] = (view, variables, want, want64)
    return out


@pytest.mark.parametrize("flavour", sorted(FLAVOURS))
def test_two_steps_match_jax(runs, flavour, tmp_path):
    view, variables, want, want64 = runs[flavour]
    got = _port_steps(flavour, view, variables, tmp_path)
    assert _violations(got, want, want64) == []
    if flavour == "alternating":
        # the detached side's zero gradient: on the even step the 3D
        # model's first moment stays 0, on the odd step the 2D model's
        # moves by decay alone
        assert all(not np.any(got[0][k]) for k in got[0]
                   if k.startswith("m.model3d."))
    if flavour == "philosophy":
        assert {"philosopher_loss", "CriticLoss"} <= set(got[0])
        # one forward per step: the running statistics moved once
        for k in (k for k in got[0] if k.startswith("model3d.")
                  and "running_mean" in k):
            assert not np.array_equal(got[0][k], got[1][k])


def _swapped_parity(tr):
    tr.optim_steps = 1


def _philosopher_sign(tr):
    real = tr.step.loss

    def loss(self, *a, **kw):
        peasant, out = real(*a, **kw)
        cl = out[2]["CriticLoss"]
        out[2]["philosopher_loss"] = peasant + cl
        return peasant, out
    tr.step.loss = types.MethodType(loss, tr.step)


def _no_extra_negatives(tr):
    def loss(self, g2, g3, noisy, noise=None):
        z1, z2 = self.outputs(g2, g3, noise)
        return self.loss_fn(z1, z2), (z1, z2)
    tr.step.loss = types.MethodType(loss, tr.step)


FAULTS = {"alternating": _swapped_parity, "philosophy": _philosopher_sign,
          "noisy_negatives": _no_extra_negatives}


@pytest.mark.parametrize("flavour", sorted(FAULTS))
def test_step_check_fails_planted_fault(runs, flavour, tmp_path):
    """The alternation's parity swapped, the philosopher's sign flipped,
    the extra negatives dropped: each fails the check."""
    view, variables, want, want64 = runs[flavour]
    got = _port_steps(flavour, view, variables, tmp_path, FAULTS[flavour])
    assert _violations(got, want, want64)


def test_several_noised_copies_are_refused(tmp_path):
    """`num_noised` 2 makes `noisy3d` a list: the JAX trainer's 3D model
    cannot read it and the port's trainer refuses it."""
    case = FLAVOURS["noisy_negatives"]
    items = _items()
    b2, b3, jb2, jb3 = _buckets(items)
    view = get_collate(case["collate"])(items, b2, bucket3d=b3,
                                        num_noised=2)
    jview = jax_get_collate(case["collate"])(items, jb2, bucket3d=jb3,
                                             num_noised=2)
    assert isinstance(view["noisy3d"], list)
    tr = JAX_CLASSES["noisy_negatives"].__new__(
        JAX_CLASSES["noisy_negatives"])
    tr.models = {k: jax_model_class(MODELS[k][0])(**MODELS[k][1])
                 for k in _keys("noisy_negatives")}
    tr.loss_func = jax_get_loss(case["loss"], **case["loss_params"])
    tr.compute_dtype, tr.args, tr.mesh = None, {}, None
    variables = _variables("noisy_negatives")
    with pytest.raises(AttributeError):
        tr.loss_fn({k: v["params"] for k, v in variables.items()},
                   {k: v["batch_stats"] for k, v in variables.items()},
                   jview, 0, jax.random.key(0), True)
    port, _ = _port_trainer("noisy_negatives", variables, tmp_path)
    with pytest.raises(TypeError, match="num_noised"):
        port._prepare(view)
    port.logger.close()


# --- the CLI ------------------------------------------------------------------

def _cli_args(path, tmp_path, **over):
    from infomax3d_tpu_torch.cli.config import load_config
    return load_config(path, dict(
        logdir=str(tmp_path), use_tensorboard=False, device="cpu",
        num_epochs=1, log_iterations=1, **over))


def test_philosophy_cli_run(tmp_path):
    """`trainer: philosophy` with `critic_type: Critic` and `critic_loss:
    CriticLoss` through the port's CLI (configs_clean/pre-train_QM9.yml
    at the small widths): it trains, logs the three losses and writes
    the critic and the three optimizers into its checkpoint."""
    from infomax3d_tpu_torch.cli.train import train
    from infomax3d_tpu_torch.train import checkpoint
    args = _cli_args(
        "configs_clean/pre-train_QM9.yml", tmp_path, dataset="synthetic",
        dataset_params={"num": 80, "n_min": 10, "n_max": 20}, batch_size=8,
        num_train=32, trainer="philosophy", critic_type="Critic",
        critic_parameters=CRITIC, critic_loss="CriticLoss",
        critic_in_dim=NET3D["target_dim"], model_parameters=PNA,
        model3d_parameters=NET3D, eval_per_epochs=0)
    result = train(args)
    assert np.isfinite(result["NTXent"]) and "CriticLoss" in result
    run = glob.glob(str(tmp_path / "PNA_*"))[0]
    payload = checkpoint.load_checkpoint(f"{run}/last_checkpoint.pt")
    assert set(payload["optimizer_state_dict"]) == {"model", "model3d",
                                                    "critic"}
    assert any("mlp" in n for n in payload["critic_state_dict"])
    with open(f"{run}/metrics.jsonl") as f:
        text = f.read()
    assert "philosopher_loss" in text and "CriticLoss" in text


def test_geomol_feat_fine_tune_and_transfer(tmp_path, monkeypatch):
    """`configs/tune_from_ot_geomoL_feat.yml` on a synthetic `qm9_geomol`
    cache of float features (its `node_dim` / `edge_dim` read off the
    data), without its `pretrain_checkpoint`; then the transfer from the
    first run's checkpoint as the JAX CLI makes it: both rename the
    source's root ``gnn.`` to ``node_gnn.`` (the reference's rename, meant
    for a GeoMol generator's backbone), which `GeomolGNNWrapper` (whose
    GNN is ``gnn``) does not have, so neither package moves a weight."""
    from infomax3d_tpu.cli.train import transfer_pretrained as jax_transfer
    from infomax3d_tpu.train.state import TrainState as JaxState
    from infomax3d_tpu_torch.cli import train as cli
    from infomax3d_tpu_torch.data.synthetic import write_synthetic_cache
    from infomax3d_tpu_torch.interop import flax_paths
    root = tmp_path / "data"
    (root / "qm9_geomol").mkdir(parents=True)
    write_synthetic_cache(str(root / "qm9_geomol" / "processed.npz"),
                          num=160, num_targets=19, float_features=True)
    monkeypatch.setenv("INFOMAX3D_DATA", str(root))
    mp = dict(hidden_dim=12, readout_layers=2, readout_batchnorm=True,
              depth=2, n_layers=2)
    over = dict(batch_size=16, num_train=48, eval_on_test=False,
                model_parameters=mp, metrics=["pearsonr", "rsquared"])
    first = _cli_args("configs/tune_from_ot_geomoL_feat.yml",
                      tmp_path / "a", pretrain_checkpoint=None, **over)
    assert np.isfinite(cli.train(first)["L1Loss"])
    src = glob.glob(str(tmp_path / "a" / "GeomolGNNWrapper_*"))[0]
    second = _cli_args("configs/tune_from_ot_geomoL_feat.yml",
                       tmp_path / "b",
                       pretrain_checkpoint=f"{src}/best_checkpoint.pt",
                       **over)
    cli.resolve_collate(second)
    dataset = cli.build_dataset(second)
    cli.apply_dataset_protocol(second, dataset)
    cli.resolve_fast_paths(second)
    models = cli.build_models(second, dataset)
    g0 = dataset[0]["graph2d"]
    dims = dict(node_dim=g0["node_feat"].shape[1],
                edge_dim=g0["edge_feat"].shape[1])
    assert models["model"].gnn.node_init.Dense_0.in_features == \
        dims["node_dim"] + 10
    tr = port_trainer.get_trainer_class("default")(
        models, second, metrics={}, main_metric="loss",
        run_dir=str(tmp_path / "b"), loss_name="L1Loss", device="cpu",
        use_tensorboard=False)
    tr.init_state()
    before = {k: v.clone() for k, v in models["model"].state_dict().items()}
    assert cli.transfer_pretrained(tr, second) == 0
    assert all(torch.equal(v, before[k])
               for k, v in models["model"].state_dict().items())
    tr.logger.close()
    params, stats = init_jax_variables(dict(mp, **dims), 0,
                                       "GeomolGNNWrapper")
    tree = jax.tree_util.tree_map(jnp.asarray, {"model": params})
    state = JaxState(params=tree, batch_stats={"model": jax.tree_util.
                                               tree_map(jnp.asarray, stats)},
                     opt_state=None, step=0, extra=None)
    out = jax_transfer(state, second)
    assert all(np.array_equal(a, b) for a, b in zip(
        jax.tree_util.tree_leaves(out.params),
        jax.tree_util.tree_leaves(tree)))
    assert set(flax_paths(models["model"])) == set(before) - {
        k for k in before if "running" in k or "num_batches" in k}
