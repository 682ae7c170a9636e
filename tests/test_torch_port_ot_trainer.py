"""The OT trainer on the CPU: `OptimalTransportTrainer` over two epochs
against the JAX trainer, and the fine-tune's transfer from an OT
checkpoint, with the helpers that `tests/test_torch_port_ot_family.py`
(the backbones, the model's options, the cost pass) shares.  Small sizes:
hidden 8, 3 model and 3 true conformers, GIN 2 x 16 with a virtual node,
GeomolGNN 8 x 2, PNA 16 x 2; inputs from numpy seeds, weights from
`init_jax_variables`.

The JAX models draw from `jax.random.normal` / `uniform` (their 'random'
rng) and flax's `Dropout` from `jax.random.bernoulli` (its 'dropout'
rng).  `_Draws` patches those three functions while a JAX pass runs: a
call from the JAX model's own modules (or flax's `stochastic.py` for the
masks) gets a numpy draw, recorded per stream, or the next draw of a
stream it is given to replay; every other caller (flax's parameter shape
checks) gets the real function.  The port gets the same draws, per
stream, through `ReplayNoise` (the masks through its `fresh` source) or,
in the trainer, through a scripted `GeneratorNoise`.  Nothing in the JAX
package changes.

Tolerances: float32 on both sides, each reading relative to the max of
the reference (`_rel`).  The trainer: the plans within 1e-6 (readings
0), the losses 1e-5 relative (readings below 1.6e-6), the weights after
each epoch against a witness (the comment above its test).
"""
import os
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from infomax3d_tpu.data.loader import get_collate as jax_get_collate
from infomax3d_tpu.graphs.batch import BucketSpec as JaxBucket
from infomax3d_tpu.models import optimal_transport as jax_ot
from infomax3d_tpu_torch.data.loader import get_collate
from infomax3d_tpu_torch.graphs.batch import bucket_for
from infomax3d_tpu_torch.interop import (init_jax_variables, load_variables,
                                         params_from_jax)
from infomax3d_tpu_torch.models.noise import GeneratorNoise, ReplayNoise
from infomax3d_tpu_torch.models.optimal_transport import OptimalTransportModel
from infomax3d_tpu_torch.train.ot import OTStep
from test_torch_port_ot import _items, _jax_tree, _rel

H, C, T, RVD = 8, 3, 3, 4
HP = {"alpha_mlp": {"n_layers": 2}, "c_mlp": {"n_layers": 1},
      "coord_pred": {"n_layers": 2}, "d_mlp": {"n_layers": 1},
      "encoder": {"n_head": 2}, "global_transformer": False,
      "h_mol_mlp": {"n_layers": 1}, "loss_type": "ot_emd", "hidden_dim": H,
      "n_model_confs": C, "n_true_confs": T, "random_alpha": False,
      "random_vec_dim": RVD, "random_vec_std": 1.0, "teacher_force": False}
# (a) the edge-update PNA at H; (b) the virtual-node GIN 2 x 16 with
# dropout 0.5 and random_vec_std 5; (c) GeomolGNNOGBFeat 8 x 2 (the
# configs' shapes at small widths)
BASELINE = {"gnn_model": "PNAGNNRandomEdgeUpdate", "hyperparams": HP,
            "gnn_params": {"hidden_dim": H, "mid_batch_norm": False,
                           "last_batch_norm": False,
                           "readout_batchnorm": True,
                           "batch_norm_momentum": 0.1, "dropout": 0.0,
                           "propagation_depth": 2, "aggregators": ["sum"],
                           "scalers": ["identity"], "pretrans_layers": 2,
                           "posttrans_layers": 2, "residual": False}}
GIN = {"gnn_model": "GNN_node_VirtualnodeRandom",
       "hyperparams": dict(HP, random_vec_std=5.0),
       "gnn_params": {"num_layers": 2, "dropout": 0.5, "hidden_dim": 16}}
GEOMOL = {"gnn_model": "GeomolGNNOGBFeat", "use_two_gnns": True,
          "hyperparams": HP,
          "gnn_params": {"hidden_dim": H, "depth": 2, "n_layers": 2}}
B = 5


# --- the draws ---------------------------------------------------------------

_OWN = ("random_variants.py", "geomol_geometry.py", "optimal_transport.py",
        "pna_random.py", "geomol_mpnn.py")
_FLAX_DROPOUT = os.path.join("linen", "stochastic.py")


class _Draws:
    """While active, the JAX model's draws (module docstring): stream
    "random" (normal, uniform) and stream "dropout" (bernoulli).  A stream
    given in `replay` hands out its draws in order (kind and shape
    checked, all must be used); the others draw from numpy (seed `seed`)
    and record into `self.rec`."""

    def __init__(self, seed=0, replay=None, table=None):
        self.rng = np.random.default_rng(seed)
        self.replay = {k: list(v) for k, v in (replay or {}).items()}
        self.rec = {"random": [], "dropout": []}
        self.table = table
        if table is not None:
            table.traced = {"random": [], "dropout": []}

    def _draw(self, stream, kind, shape, p=0.5):
        if self.table is not None:
            return self.table.draw(stream, kind, shape)
        if stream in self.replay:
            k, v = self.replay[stream].pop(0)
            assert (k, v.shape) == (kind, tuple(shape)), (stream, k, kind)
        elif kind == "normal":
            v = self.rng.normal(size=shape).astype(np.float32)
        elif kind == "uniform":
            v = self.rng.random(shape).astype(np.float32)
        else:
            v = self.rng.random(shape) < p
        self.rec[stream].append((kind, v))
        return jnp.asarray(v)

    def _fake(self, kind, real):
        def fn(key, *args, **kwargs):
            caller = sys._getframe(1).f_code.co_filename
            if kind == "bernoulli" and caller.endswith(_FLAX_DROPOUT):
                p = kwargs.get("p", args[0] if args else 0.5)
                shape = kwargs.get("shape", args[1] if len(args) > 1 else ())
                return self._draw("dropout", kind, tuple(shape), float(p))
            if kind != "bernoulli" and caller.endswith(_OWN):
                shape = kwargs.get("shape", args[0] if args else ())
                return self._draw("random", kind, tuple(shape))
            return real(key, *args, **kwargs)
        return fn

    def __enter__(self):
        self.real = {k: getattr(jax.random, k)
                     for k in ("normal", "uniform", "bernoulli")}
        for k, f in self.real.items():
            setattr(jax.random, k, self._fake(k, f))
        return self

    def __exit__(self, *exc):
        for k, f in self.real.items():
            setattr(jax.random, k, f)
        if exc[0] is None:
            assert all(not v for v in self.replay.values()), "unused draws"


class _Table:
    """Draws for compiled JAX passes, handed out when they run: a draw
    traced under `_Draws(table=...)` becomes a `jax.pure_callback` that
    reads entry i of its stream in `current` (set before each run), so a
    pass compiles once for all the steps of one shape.  `traced` records
    each stream's (kind, shape) in the order of the trace under way (each
    `_Draws` starts it anew)."""

    def __init__(self):
        self.current = {"random": [], "dropout": []}
        self.traced = {"random": [], "dropout": []}

    def draw(self, stream, kind, shape):
        i = len(self.traced[stream])
        self.traced[stream].append((kind, tuple(shape)))
        dtype = np.bool_ if kind == "bernoulli" else np.float32

        def fetch(_):
            k, v = self.current[stream][i]
            assert (k, v.shape) == (kind, tuple(shape)), (stream, i)
            return np.asarray(v, dtype)
        return jax.pure_callback(fetch, jax.ShapeDtypeStruct(shape, dtype),
                                 np.int32(i))


def _torch_draws(stream):
    return [(k, torch.from_numpy(np.asarray(v))) for k, v in stream]


def _port_noise(rec):
    """The port's source for a recorded JAX pass: the random stream in
    order, the masks from their own stream."""
    return ReplayNoise(_torch_draws(rec["random"]),
                       fresh=ReplayNoise(_torch_draws(rec["dropout"])))


def _jax_apply(module, variables, *args, train=False, seed=0, replay=None,
               **kw):
    """`module.apply` on `variables` (numpy trees) under `_Draws`:
    deterministic (eval), or in training with the batch statistics
    mutable.  Returns (output, new batch_stats or None, the draws)."""
    v = {"params": _jax_tree(variables["params"]),
         "batch_stats": _jax_tree(variables.get("batch_stats", {}))}
    rngs = {"random": jax.random.key(0), "dropout": jax.random.key(1)}
    with _Draws(seed, replay) as d:
        if train:
            out, mut = jax.jit(lambda: module.apply(
                v, *args, deterministic=False, mutable=["batch_stats"],
                rngs=rngs, **kw))()
            stats = mut.get("batch_stats", {})
        else:
            out, stats = jax.jit(lambda: module.apply(
                v, *args, deterministic=True, rngs=rngs, **kw))(), None
    return out, stats, d.rec


def _stats_errors(module, jax_stats):
    """Each running statistic of the port `module` against the JAX
    update's, relative to its max."""
    want = params_from_jax({}, jax.tree_util.tree_map(np.asarray, jax_stats))
    sd = module.state_dict()
    errs = {n: _rel(sd[n], v) for n, v in want.items()
            if not n.endswith("num_batches_tracked")}
    assert errs and set(want) <= set(sd)
    return errs


# --- the OT model ------------------------------------------------------------

def _models(mp, seed=1):
    """(JAX model, port model, numpy variables) of OT `model_parameters`
    `mp`."""
    params, stats = init_jax_variables(mp, seed, "OptimalTransportModel")
    var = {"params": params, "batch_stats": stats}
    jm = jax_ot.OptimalTransportModel(
        hyperparams=mp["hyperparams"], gnn_params=mp["gnn_params"],
        gnn_model=mp["gnn_model"],
        use_transformer=mp.get("use_transformer", True),
        use_two_gnns=mp.get("use_two_gnns", True))
    return jm, load_variables(OptimalTransportModel.from_config(mp), var), var


# --- the trainer -------------------------------------------------------------

TRAINER_ARGS = {
    "num_epochs_local_only": 2, "log_iterations": 1, "seed": 0,
    "optimizer": "Adam", "optimizer_params": {"lr": 1e-3},
    "lr_scheduler": "WarmUpWrapper",
    "lr_scheduler_params": {"warmup_steps": [4], "interpolation": "linear",
                            "wrapped_scheduler": "ReduceLROnPlateau",
                            "factor": 0.7, "patience": 5, "min_lr": 1e-5,
                            "mode": "min"}}


def _equal_shape_groups(items, k=4, n=3):
    """`n` disjoint groups of `k` items with the same neighbourhood and
    dihedral-pair totals (so their OT batches share every shape and the
    JAX passes compile once): the first such key in combination order."""
    import itertools
    from infomax3d_tpu_torch.data.geomol_featurize import geomol_featurize
    sizes = []
    for it in items:
        f = geomol_featurize(it["graph2d"])
        sizes.append((len(f["nbh_center"]), len(f["dp"])))
    groups = {}
    for c in itertools.combinations(range(len(items)), k):
        groups.setdefault(tuple(np.sum([sizes[i] for i in c], 0)),
                          []).append(c)
    for cs in sorted(groups.values(), key=len, reverse=True):
        chosen = []
        for c in cs:
            if not any(set(c) & set(d) for d in chosen):
                chosen.append(c)
        if len(chosen) >= n:
            return [[items[i] for i in c] for c in chosen[:n]]
    raise AssertionError("no equal-shape groups")


@pytest.fixture(scope="module")
def trainer_batches():
    """Three OT batches of 4 other molecules each, of one shape, by both
    collates in one bucket: (port views ``{"graph": arrays}``, JAX
    `GraphBatch`es)."""
    from infomax3d_tpu_torch.graphs.batch import BucketSpec
    groups = _equal_shape_groups(_items(24, seed=21, n_max=12, confs=T))
    bs = [bucket_for([it["graph2d"] for it in g], 5) for g in groups]
    b = BucketSpec(5, max(x.n_nodes for x in bs), max(x.n_edges for x in bs),
                   max_deg=max(x.max_deg for x in bs), csr=True,
                   nmax=max(x.nmax for x in bs))
    views = [get_collate("ot_collate")(g, b, n_true_confs=T) for g in groups]
    jbs = [jax_get_collate("ot_collate")(g, JaxBucket(
        b.n_graphs, b.n_nodes, b.n_edges, max_deg=b.max_deg, csr=True,
        nmax=b.nmax), n_true_confs=T)["graph"] for g in groups]
    return views, jbs


class _ScriptedNoise(GeneratorNoise):
    """A `GeneratorNoise` whose draws come from numpy (one seed per
    instance, i.e. per batch) and are logged per stream in `LOG`."""
    LOG = []

    def __init__(self, generator):
        super().__init__(generator)
        self.rng = np.random.default_rng(1000 + len(self.LOG))
        self.LOG.append({"random": [], "dropout": []})

    def _draw(self, kind, shape, p=0.0):
        if kind == "normal":
            v = self.rng.normal(size=tuple(shape)).astype(np.float32)
        elif kind == "uniform":
            v = self.rng.random(tuple(shape)).astype(np.float32)
        else:
            v = self.rng.random(tuple(shape)) < p
        self.LOG[-1]["dropout" if kind == "bernoulli" else "random"].append(
            (kind, v))
        t = torch.from_numpy(v)
        self.draws.append((kind, t))
        return t


def _port_trainer_run(mp, var, views, tmp_path, monkeypatch):
    """Two epochs of the port's `OptimalTransportTrainer.train_epoch` over
    `views`: per step the plans, the loss, the group lrs and the noise;
    the weights and running statistics after each epoch."""
    from infomax3d_tpu_torch.train import ot as ot_mod
    from infomax3d_tpu_torch.train.trainer import OptimalTransportTrainer
    monkeypatch.setattr(_ScriptedNoise, "LOG", [])
    monkeypatch.setattr(ot_mod, "GeneratorNoise", _ScriptedNoise)
    steps = []
    real = OTStep.loss_and_grads

    def spy(self, batch, noise, plans=None):
        loss = real(self, batch, noise, plans)
        steps.append({"plans": plans.numpy().copy(), "loss": float(loss),
                      "ignore": self.ignore_neighbors,
                      "lrs": {g["name"]: g["lr"]
                              for g in self.optimizer.param_groups}})
        return loss
    monkeypatch.setattr(OTStep, "loss_and_grads", spy)
    model = OptimalTransportModel.from_config(mp)
    tr = OptimalTransportTrainer(
        {"model": model}, dict(TRAINER_ARGS, model_parameters=mp), {},
        "loss", str(tmp_path), loss_name="MSELoss",
        scheduler_step_per_batch=False, device="cpu",
        use_tensorboard=False, init_variables={"model": var})
    tr.init_state()
    assert tr.compute_dtype is None
    after = []
    for epoch in (1, 2):
        tr.train_epoch(views, epoch)
        after.append({n: v.detach().numpy().copy()
                      for n, v in model.state_dict().items()
                      if not n.endswith("num_batches_tracked")})
    for s, log in zip(steps, _ScriptedNoise.LOG):
        s["draws"] = log
    return steps, after, tr


def _jax_trainer_runs(mp, var, jbs, steps, perturbs=(0.0,)):
    """The JAX trainer's epochs over `jbs`, once per entry of `perturbs`,
    from the same weights scaled by 1 + perturb U(-1, 1) each (a witness):
    a bare `OptimalTransportTrainer` (`_epoch`, `args`), per step its
    `_attach_ot_plans` and `loss_fn` (the port's draws handed out by a
    `_Table`), the clip and `GroupedOptimizer` Adam at the port's group
    lrs.  Returns per run the per-step (plans, loss) and the weights and
    statistics after each epoch in the port's names.  Each pass compiles
    once per epoch for all runs: the batches share their shapes."""
    from infomax3d_tpu.train.optim import GROUP_ORDER, GroupedOptimizer
    from infomax3d_tpu.train.optim import label_params as jax_labels
    from infomax3d_tpu.train.trainer import OptimalTransportTrainer as JT
    tr = JT.__new__(JT)
    tr.models, tr.args = {"model": _models(mp)[0]}, dict(TRAINER_ARGS)
    key = jax.random.key(0)
    table = _Table()

    def lf(p, stats, batch):
        loss, _, new = tr.loss_fn(p, stats, batch, 0, key, True)
        return loss, new
    grad_fns = {e: jax.jit(jax.value_and_grad(lf, has_aux=True))
                for e in (1, 2)}
    runs = []
    for perturb in perturbs:
        rng = np.random.default_rng(9)
        params = {"model": _jax_tree(jax.tree_util.tree_map(
            lambda x: (x * (1 + perturb * rng.uniform(-1, 1, x.shape))
                       ).astype(np.float32), var["params"]))}
        stats = {"model": _jax_tree(var["batch_stats"])}
        labels, _ = jax_labels(params)
        opt = GroupedOptimizer(labels, name="Adam", lr=1e-3)
        opt_state = opt.init(params)
        out, after, k = [], [], 0
        for epoch in (1, 2):
            tr._epoch = epoch
            for jb in jbs:
                s = steps[k]
                assert s["ignore"] == tr._ignore_neighbors
                tr.state = types.SimpleNamespace(params=params,
                                                 batch_stats=stats)
                table.current = {"random": s["draws"]["random"],
                                 "dropout": []}
                with _Draws(table=table):
                    batch = tr._attach_ot_plans({"graph": jb}, key)
                table.current = s["draws"]
                with _Draws(table=table):
                    (loss, new), grads = grad_fns[epoch](params, stats,
                                                         batch)
                gnorm = jnp.sqrt(sum(jnp.sum(x * x) for x in
                                     jax.tree_util.tree_leaves(grads)))
                scale = jnp.minimum(1.0, tr.GRAD_CLIP / (gnorm + 1e-6))
                grads = jax.tree_util.tree_map(lambda x: x * scale, grads)
                lrs = np.zeros(len(GROUP_ORDER), np.float32)
                for name, lr in s["lrs"].items():
                    lrs[GROUP_ORDER.index(name)] = lr
                upd, opt_state = opt.update(grads, opt_state, params,
                                            jnp.asarray(lrs))
                params = jax.tree_util.tree_map(lambda p, u: p + u, params,
                                                upd)
                stats = new
                out.append((np.asarray(batch["_ot_plans"]), float(loss)))
                k += 1
            sd = params_from_jax(
                jax.tree_util.tree_map(np.asarray, params["model"]),
                jax.tree_util.tree_map(np.asarray, stats["model"]))
            after.append({n: v.numpy() for n, v in sd.items()
                          if not n.endswith("num_batches_tracked")})
        runs.append((out, after))
    return runs


# The weights after each epoch: the gradients agree to float32 rounding
# (the torsion head magnifies it, tests/test_torch_port_ot.py), and Adam's
# first steps move each weight by about lr whatever its gradient's size,
# so where a gradient is rounding noise (a bias before a BatchNorm, whose
# true gradient is 0) two float32 runs part by up to lr per step.  So each
# leaf is held to WITNESS_FACTOR times a witness, the JAX run's own move
# under weights perturbed by WITNESS_REL (8 float32 ulps), or WITNESS_FLOOR
# of its max where that is larger.
WITNESS_REL = 2.0 ** -20
WITNESS_FACTOR = 4.0
WITNESS_FLOOR = 1e-5


@pytest.mark.parametrize("case", ["gin"])
def test_trainer_epochs_match_jax(trainer_batches, tmp_path, monkeypatch,
                                  case):
    """Two epochs of three batches, the first local-only
    (`num_epochs_local_only: 2`: ``gnn2`` reaches no term of its cost, so
    its Adam moments start in epoch 2), with the WarmUpWrapper's first
    steps (lr 0, then a quarter, ...): each step's plans equal the JAX
    trainer's within 1e-6 and its loss within 1e-5 relative; the weights
    and (GIN) running statistics after each epoch as the comment above
    says."""
    views, jbs = trainer_batches
    mp = {"gin": GIN, "baseline": BASELINE}[case]
    var = _models(mp)[2]
    steps, after, tr = _port_trainer_run(mp, var, views, tmp_path,
                                         monkeypatch)
    assert [s["ignore"] for s in steps] == [True] * 3 + [False] * 3
    assert steps[0]["lrs"]["new"] == 0.0 < steps[1]["lrs"]["new"]
    assert tr.optim_steps == 6 and tr.timing["host_emd"] > 0
    (want, want_after), (_, witness) = _jax_trainer_runs(
        mp, var, jbs, steps, (0.0, WITNESS_REL))
    for s, (plans, loss) in zip(steps, want):
        np.testing.assert_allclose(s["plans"], plans, atol=1e-6)
        assert abs(s["loss"] - loss) <= 1e-5 * abs(loss), (s["loss"], loss)
    for got, ref, wit in zip(after, want_after, witness):
        assert set(got) == set(ref) == set(wit)
        errs = {n: (_rel(got[n], ref[n]), _rel(wit[n], ref[n])) for n in ref}
        bad = {n: e for n, e in errs.items()
               if e[0] > max(WITNESS_FACTOR * e[1], WITNESS_FLOOR)}
        assert not bad, bad


# --- the fine-tune from an OT checkpoint ---------------------------------------

def _ot_checkpoint(fmt, tmp_path):
    """An OT checkpoint of `configs/ot_pyg_in_memory.yml`'s model
    (GeomolGNNOGBFeat 50 x 3) from seeded weights: the port's `.pt` or the
    JAX package's flax msgpack TrainState."""
    from flax import serialization
    from infomax3d_tpu_torch.cli.config import load_config
    from infomax3d_tpu_torch.train import checkpoint
    mp = load_config("configs/ot_pyg_in_memory.yml", {})["model_parameters"]
    params, stats = init_jax_variables(mp, 5, "OptimalTransportModel")
    path = tmp_path / f"ot_{fmt}.pt"
    if fmt == "pt":
        model = load_variables(OptimalTransportModel.from_config(mp),
                               {"params": params, "batch_stats": stats})
        checkpoint.save_checkpoint(str(path), checkpoint.state_dicts(
            {"model": model}))
    else:
        path.write_bytes(serialization.msgpack_serialize({
            "params": {"model": params}, "batch_stats": {"model": stats},
            "opt_state": {}, "step": 0, "extra": {}}))
    return str(path)


# GeomolGNNOGBFeat's tensors: 12 encoder tables; node_init, edge_init and
# the edge model's MLP 3 Linears each; the edge model's edge Linear and two
# projections; the node model's two MLPs; the two epsilons
TUNE_TRANSFER = 12 + 3 * 2 * 3 + 4 + 2 * 3 * 2 + 2


def _jax_transfer(args, params, stats, capsys):
    """The JAX CLI's `transfer_pretrained` of `args` into the JAX model's
    trees: (its count, the resulting state in torch names)."""
    from infomax3d_tpu.cli.train import transfer_pretrained as jax_transfer
    from infomax3d_tpu.train.state import TrainState
    state = jax_transfer(TrainState(
        params={"model": params}, batch_stats={"model": stats},
        opt_state=None, step=0), args)
    count = int(capsys.readouterr().out.split("transferred ")[1].split()[0])
    return count, params_from_jax(jax.device_get(state.params["model"]),
                                  jax.device_get(state.batch_stats["model"]))


@pytest.mark.parametrize("fmt", ["pt", "msgpack"])
def test_transfer_into_geomol_finetune_matches_jax(fmt, tmp_path, capsys):
    """`configs/tune_from_ot_pna.yml` (GeomolGNNWrapperOGBFeat 50 x 3,
    `transfer_layers: [gnn.]`, `exclude_from_transfer: [batch_norm]`) from
    an OT checkpoint with the GeomolGNNOGBFeat 50 x 3 backbone, as the
    port's `.pt` and as the JAX CLI's msgpack: `transfer_pretrained`
    copies the tensors the JAX CLI copies from the msgpack (the OT model's
    ``gnn`` renamed ``node_gnn``): every one of the backbone's, nothing of
    the head.  The JAX CLI reading the port's `.pt` prints the same count,
    but its name table has no rule for a GeoMol MLP's ``Dense_{k}`` (which
    the port keeps), so it changes only the encoders, the edge model's
    three projections and the epsilons: each of those the port copies the
    same."""
    from infomax3d_tpu_torch.cli.config import load_config
    from infomax3d_tpu_torch.cli.train import transfer_pretrained
    from infomax3d_tpu_torch.models.registry import (adapt_model_params,
                                                     build_model)
    tune = load_config("configs/tune_from_ot_pna.yml", {})
    mp = adapt_model_params(tune["model_type"], tune["model_parameters"])
    params, stats = init_jax_variables(mp, 11, tune["model_type"])

    def args(f):
        return {"pretrain_checkpoint": _ot_checkpoint(f, tmp_path),
                "transfer_layers": tune["transfer_layers"],
                "exclude_from_transfer": tune["exclude_from_transfer"]}
    jax_count, want = _jax_transfer(args("msgpack"), params, stats, capsys)
    model = load_variables(build_model(tune["model_type"],
                                       tune["model_parameters"]),
                           {"params": params, "batch_stats": stats})
    count = transfer_pretrained(types.SimpleNamespace(
        models={"model": model}), args(fmt))
    assert count == jax_count == TUNE_TRANSFER
    got = model.state_dict()
    before = params_from_jax(params, stats)
    moved = [k for k in want if not torch.equal(want[k], before[k])]
    assert len(moved) == TUNE_TRANSFER
    assert all(k.startswith("node_gnn.") for k in moved)
    for k, v in want.items():
        assert torch.equal(got[k], v), k
    if fmt == "pt":
        n, from_pt = _jax_transfer(args("pt"), params, stats, capsys)
        moved_pt = [k for k in from_pt
                    if not torch.equal(from_pt[k], before[k])]
        assert n == TUNE_TRANSFER and len(moved_pt) == 12 + 4 + 2
        assert all(torch.equal(got[k], from_pt[k]) for k in moved_pt)


def test_chip_smoke_phase22_follows_the_configs():
    """Phase 22's launch expectations read the configs: 10 model
    conformers in (a), (b) and (c); (a)'s edge-update depth, (b)'s GIN
    depth and width; the fine-tune's transfer count is this file's, from
    the JAX CLI; (c)'s and (d)'s models run no kernel."""
    import importlib.util
    from pathlib import Path
    from infomax3d_tpu_torch.cli.config import load_config
    root = Path(__file__).resolve().parents[1]
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  root / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    mp = {k: load_config(str(root / p), {})["model_parameters"]
          for k, p in cs.OT_FAMILY.items()}
    assert {k: m["hyperparams"]["n_model_confs"] for k, m in mp.items()} \
        == dict.fromkeys("abc", cs.OT_CONFS)
    assert mp["a"]["gnn_params"]["propagation_depth"] == cs.OT_DEPTH
    assert mp["a"]["gnn_params"]["aggregators"] == ["sum"]
    assert mp["b"]["gnn_model"] == "GNN_node_VirtualnodeRandom"
    assert (mp["b"]["gnn_params"]["num_layers"],
            mp["b"]["gnn_params"]["hidden_dim"]) == (cs.GIN_OT_DEPTH,
                                                     cs.GIN_OT_WIDTH)
    assert mp["c"]["gnn_model"] == "GeomolGNNOGBFeat"
    assert cs.OT_TUNE_TRANSFER == TUNE_TRANSFER
    tune = load_config(str(root / cs.OT_TUNE), {})
    pre = load_config(str(root / cs.OT_TUNE_PRE), {})["model_parameters"]
    assert pre["gnn_model"] == "GeomolGNNOGBFeat"
    assert pre["gnn_params"]["hidden_dim"] == \
        tune["model_parameters"]["hidden_dim"]
    assert cs.OT_FAMILY_STEP["c"] == cs.OT_FAMILY_EVAL["c"] == cs.NONE
