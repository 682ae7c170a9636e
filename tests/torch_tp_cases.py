"""The cases of `tests/test_torch_port_tp.py`: tensor parallelism
(``model_shards``, `infomax3d_tpu_torch/parallel/tp.py`).  Each case builds
one step of the port from seeded numpy weights and batches
(`tests/torch_dp_cases.py`'s models and molecules), shards it over the
model group, runs it once and returns its loss, its WHOLE gradients (the
shards gathered), its running statistics and, for the trainers, its whole
parameters after the update, as numpy arrays; with the shapes each rank
holds for its sharded leaves and its master and moment bytes.

Run as a script, ``python tests/torch_tp_cases.py RANK WORLD DIR SUITE``
(rendezvous in a file store under DIR, results pickled to
DIR/rank{RANK}.pkl): suite "tp", two gloo ranks, ``model_shards: 2``
(`CASES`, `TRAINERS` and the planted `FAULTS`); suite "grid", four ranks,
``n_shards: 2`` x ``model_shards: 2`` (`GRID_CASES`), each rank also
running the same step as data parallelism alone over its data group.
`run(name, None)` is a case in one process on the whole batch.  Nothing
here imports JAX.
"""
import os
import pickle
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
sys.path.insert(0, str(Path(__file__).resolve().parent))

import torch_dp_cases as dp  # noqa: E402
from infomax3d_tpu_torch.data.loader import to_device  # noqa: E402
from infomax3d_tpu_torch.losses import get_loss  # noqa: E402
from infomax3d_tpu_torch.models.registry import build_model  # noqa: E402
from infomax3d_tpu_torch.parallel import (CrossDeviceLoss, close_group,  # noqa: E402
                                          make_group, make_tp_grid, tp,
                                          using_groups)
from infomax3d_tpu_torch.parallel import collectives  # noqa: E402
from infomax3d_tpu_torch.parallel.collectives import gather_leaves  # noqa: E402
from infomax3d_tpu_torch.train import supervised as supervised_mod  # noqa: E402
from infomax3d_tpu_torch.train import trainer as port_trainer  # noqa: E402
from infomax3d_tpu_torch.train.pretrain import PretrainStep  # noqa: E402
from infomax3d_tpu_torch.train.supervised import SupervisedStep  # noqa: E402

K = 2
# the supervised PNA of the JAX comparison: two targets, one of them NaN
SUP_PNA = dict(dp.PNA, target_dim=2)
CASES = ("contrastive", "supervised", "gin", "contrastive_remat")
CRITIC = dict(metric_dim=12, hidden_dim=12, layers=1, repeats=2,
              in_dim=dp.NET3D["target_dim"])
# the trainers the JAX package runs under `model_shards: 2`, one step each:
# the flavours of the data-parallel cases and the philosophy trainer
FLAVOURS = dict(dp.FLAVOURS, philosophy=(
    "philosophy", "contrastive_collate", {}, "NTXent", {"tau": 0.2},
    {"model": ("PNA", dp.PNA), "model3d": ("Net3D", dp.NET3D),
     "critic": ("Critic", CRITIC)}))
# and the optimal-transport trainer (its tiny edge-update PNA backbone,
# 4 molecules with 3 true conformers each)
TRAINERS = tuple(FLAVOURS) + ("optimal_transport",)
OT_HP = {"alpha_mlp": {"n_layers": 2}, "c_mlp": {"n_layers": 1},
         "coord_pred": {"n_layers": 2}, "d_mlp": {"n_layers": 1},
         "encoder": {"n_head": 2}, "global_transformer": False,
         "h_mol_mlp": {"n_layers": 1}, "loss_type": "ot_emd",
         "hidden_dim": 8, "n_model_confs": 3, "n_true_confs": 3,
         "random_alpha": False, "random_vec_dim": 4, "random_vec_std": 1.0,
         "teacher_force": False}
OT = {"gnn_model": "PNAGNNRandomEdgeUpdate", "hyperparams": OT_HP,
      "gnn_params": {"hidden_dim": 8, "mid_batch_norm": False,
                     "last_batch_norm": False, "readout_batchnorm": True,
                     "batch_norm_momentum": 0.1, "dropout": 0.0,
                     "propagation_depth": 2, "aggregators": ["sum"],
                     "scalers": ["identity"], "pretrans_layers": 2,
                     "posttrans_layers": 2, "residual": False}}
GRID_CASES = ("contrastive", "supervised")


def _whole(named, group, grads=True):
    """{name: whole numpy array} of each parameter's gradient (or value):
    a shard's gathered over the model `group`."""
    named = list(named)
    pick = (lambda p: p.grad) if grads else (lambda p: p.detach())
    out = {n: pick(p).detach().numpy().copy() for n, p in named
           if not tp.is_shard(p)}
    shards = [(n, p) for n, p in named if tp.is_shard(p)]
    if shards:
        full = gather_leaves([pick(p) for _, p in shards],
                             [p._tp.dim for _, p in shards], group)
        out.update({n: t.numpy().copy() for (n, _), t in zip(shards, full)})
    return out


def _record(loss, named, modules, group, optimizer, params=False):
    named = list(named)
    out = {"loss": float(loss)}
    out.update(_whole(named, group))
    if params:
        out.update({f"param.{n}": v for n, v in
                    _whole(named, group, grads=False).items()})
    for pre, m in modules.items():
        out.update({f"{pre}.{n}": v.detach().numpy().copy()
                    for n, v in m.named_buffers() if "running" in n})
    out["shapes"] = {n: tuple(p.shape) for n, p in named if tp.is_shard(p)}
    out["bytes"] = tp.master_bytes((p for _, p in named), optimizer)
    return out


def step_case(name, grid, tp_on=True):
    """Case `name` of `CASES` (one float32 `loss_and_grads`): on this
    rank's data shard under the grid (sharded when `tp_on`; without it the
    step of data parallelism alone over the grid's data group), or in one
    process on the whole batch for `grid` None."""
    n_data, d = (1, 0) if grid is None else (grid.n_data, grid.data_index)
    data = None if grid is None else grid.data
    if name.startswith("contrastive"):
        var = dp.variables({"model": ("PNA", dp.PNA),
                            "model3d": ("Net3D", dp.NET3D)})
        step = PretrainStep(dp.PNA, dp.NET3D, var, "cpu", None,
                            {"tau": 0.1}, {"lr": 1e-3}, "NTXent", "Net3D",
                            "PNA")
        if data is not None:
            step.loss_fn = CrossDeviceLoss(step.loss_fn, data)
        view = dp.loader("contrastive_collate", n_data, d)
        batches = step.prepare(to_device(view["graph2d"], "cpu"),
                               to_device(view["graph3d"], "cpu"))
        named = lambda: list(step.named_parameters())  # noqa: E731
        modules = {"model": step.model, "model3d": step.model3d}
    else:
        kind, mp = (("OGBGNN", dp.GIN) if name == "gin"
                    else ("PNA", SUP_PNA))
        var = dp.variables({"model": (kind, mp)})["model"]
        step = SupervisedStep(kind, mp, var, "cpu", None,
                              "BCEWithLogitsLoss" if name == "gin"
                              else "L1Loss", {"lr": 1e-3})
        batches = (step.prepare(to_device(
            dp.loader("graph_collate", n_data, d)["graph"], "cpu")),)
        named = lambda: [("model." + n, p) for n, p in  # noqa: E731
                         step.model.named_parameters()]
        modules = {"model": step.model}
    if grid is not None and tp_on:
        tp.shard_step(step, grid.k, grid.graph_index)
    step.remat = name.endswith("_remat")
    if grid is None:
        ctx = using_groups()
    elif tp_on:
        ctx = using_groups(data=data, model=grid.model)
    else:
        ctx = using_groups(data=data)
    with ctx:
        loss = step.loss_and_grads(*batches)
    group = None if grid is None or not tp_on else grid.model
    return _record(loss, named(), modules, group, step.optimizer)


def trainer_case(name, grid, run_dir):
    """One eval step, then one training step of the flavour's trainer
    (`FLAVOURS`) on the whole batch, under the
    tensor-parallel `grid` (or in one process): the eval loss, the loss,
    the whole gradients and the whole parameters after the update."""
    trainer, collate, ckw, loss_name, loss_params, models = FLAVOURS[name]
    mods = {key: build_model(t, {k: v for k, v in mp.items()
                                 if k != "in_dim"},
                             **({"in_dim": mp["in_dim"]} if "in_dim" in mp
                                else {}))
            for key, (t, mp) in models.items()}
    cls = port_trainer.get_trainer_class(trainer)
    kw = {"ma_decay": 0.9} if trainer == "byol" else {}
    if trainer == "philosophy":
        kw["critic_loss"] = get_loss("CriticLoss")
    tr = cls(mods, {"optimizer": "Adam", "optimizer_params": {"lr": 1e-3},
                    "bf16_compute": False}, metrics={}, main_metric="loss",
             run_dir=run_dir,
             loss_func=None if loss_name == "L1Loss"
             else get_loss(loss_name, **loss_params),
             loss_name=loss_name, device="cpu", use_tensorboard=False,
             init_variables=dp.variables(models), grid=grid, **kw)
    tr.init_state()
    batch = dp.loader(collate, 1, 0, **ckw)
    eval_loss, _ = tr._eval_step(tr._prepare(batch))
    tr._write_lrs()
    loss, _ = tr._train_step(tr._prepare(batch))
    mods_stats = dict(mods)
    for key, teacher in getattr(tr.step, "teachers", {}).items():
        mods_stats[f"teacher.{key}"] = teacher
    out = _record(loss, tr.named_parameters(), mods_stats,
                  None if grid is None else grid.model, tr.optimizer,
                  params=True)
    out["eval_loss"] = float(eval_loss)
    tr.logger.close()
    return out


def ot_case(grid, run_dir):
    """One training epoch of one batch of the optimal-transport trainer
    (cost pass, host plans, gradient pass, clip, Adam), then its
    validation loss on the batch: the whole gradients (clipped) and
    parameters after the update."""
    from infomax3d_tpu_torch.data.loader import get_collate
    from infomax3d_tpu_torch.data.synthetic import SyntheticMolecules
    from infomax3d_tpu_torch.graphs.batch import bucket_for
    from infomax3d_tpu_torch.interop import init_jax_variables
    from infomax3d_tpu_torch.models.optimal_transport import \
        OptimalTransportModel
    ds = SyntheticMolecules(4, seed=2, n_min=6, n_max=12, num_conformers=3)
    items = [{"graph2d": m, "conformers3d": [{"coords": c}
                                             for c in m["conformers"]]}
             for m in ds.mols]
    b = bucket_for([it["graph2d"] for it in items], 4)
    batch = get_collate("ot_collate")(items, b, n_true_confs=3)
    params, stats = init_jax_variables(OT, 1, "OptimalTransportModel")
    model = OptimalTransportModel.from_config(OT)
    tr = port_trainer.OptimalTransportTrainer(
        {"model": model}, {"optimizer": "Adam", "seed": 0,
                           "optimizer_params": {"lr": 1e-3},
                           "model_parameters": OT}, {}, "loss", run_dir,
        loss_name="MSELoss", device="cpu", use_tensorboard=False,
        init_variables={"model": {"params": params, "batch_stats": stats}},
        grid=grid)
    tr.init_state()
    tr._write_lrs()
    tr.train_epoch([batch], 1)
    loss = tr.evaluate_epoch([batch], 1)["MSELoss"]
    out = _record(loss, tr.named_parameters(), {"model": model},
                  None if grid is None else grid.model, tr.optimizer,
                  params=True)
    tr.logger.close()
    return out


def _summed_backward(ctx, *cts):
    """The shard gather's backward summing each cotangent over the model
    ranks before its slice (the data-parallel transpose; a planted
    fault)."""
    out = []
    for ct, d in zip(cts, ctx.dims):
        ct = collectives.all_reduce_(ct.contiguous().clone(), ctx.group)
        out.append(ct.chunk(ctx.k, d)[ctx.index].contiguous())
    return (None, None) + tuple(out)


def _reversed_gather(flat, group):
    """The shards gathered in reversed rank order (a planted fault)."""
    return _REAL_GATHER(flat, group).flip(0)


def _world():
    return torch.distributed.group.WORLD


_REAL_GATHER = collectives._gather_flat
# planted faults of the tensor-parallel step, each run on the contrastive
# case: the backward summing over the model ranks, the shards gathered in
# the wrong rank order, the gradient mean taken over the model ranks too
FAULTS = {
    "backward_summed": (collectives._GatherShards, "backward",
                        staticmethod(_summed_backward)),
    "rank_order": (collectives, "_gather_flat", _reversed_gather),
    "mean_over_model": (supervised_mod, "step_group", _world),
}


def run(name, grid, run_dir=""):
    torch.manual_seed(0)
    if name == "optimal_transport":
        return ot_case(grid, run_dir)
    if name in TRAINERS:
        return trainer_case(name, grid, run_dir)
    if name in FAULTS:
        obj, attr, plant = FAULTS[name]
        kept = obj.__dict__[attr]
        setattr(obj, attr, plant)
        try:
            return step_case("contrastive", grid)
        finally:
            setattr(obj, attr, kept)
    return step_case(name, grid)


def main(rank: int, world: int, out_dir: str, suite: str = "tp") -> None:
    torch.set_num_threads(1)
    make_group(world, rank, f"file://{out_dir}/store", "gloo", "cpu")
    try:
        if suite == "tp":
            grid = make_tp_grid(1, world)
            results = {name: run(name, grid, os.path.join(
                out_dir, f"run{rank}_{name}"))
                for name in CASES + TRAINERS + tuple(FAULTS)}
        else:
            grid = make_tp_grid(2, world // 2)
            results = {}
            for name in GRID_CASES:
                torch.manual_seed(0)
                results[name] = step_case(name, grid)
                results[f"dp_{name}"] = step_case(name, grid, tp_on=False)
    finally:
        close_group()
    with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(results, f)


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], *sys.argv[4:])
