"""The cases of `tests/test_torch_port_parallel.py`: each builds one step
of the port from seeded numpy weights and batches, runs it once and
returns its loss, gradients and running statistics as numpy arrays.

Every case runs twice: in two gloo ranks on the CPU (this file as a
script, ``python tests/torch_dp_cases.py RANK WORLD DIR [SUITE]``,
rendezvous in a file store under DIR, each rank's results pickled to
DIR/rank{RANK}.pkl),
each rank collating its shard (`GraphDataLoader(n_shards=2, shard=r)`),
and in one process on the whole batch (`run(name, None, 0, 1)`).  Nothing
here imports JAX: the ranks start in a few seconds.

The suites: "dp" (the default, `CASES` and `FAULTS`: data parallelism
over two ranks), "partition" (`PARTITION_CASES` and `PARTITION_FAULTS`
over two ranks: ``graph_shards: 2`` and ``node_shards: 2`` on the
non-CSR batch) and "grid" (`GRID_CASES` over four ranks: ``n_shards: 2``
x ``graph_shards: 2``).  A partition case's one-process counterpart is
`partition(name, None)`.
"""
import os
import pickle
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import dataclasses  # noqa: E402

from infomax3d_tpu_torch.data.loader import (GraphDataLoader,  # noqa: E402
                                             get_collate, partition_collate,
                                             to_device)
from infomax3d_tpu_torch.data.synthetic import SyntheticMolecules  # noqa: E402
from infomax3d_tpu_torch.graphs.batch import BucketSpec, bucket_for  # noqa: E402
from infomax3d_tpu_torch.interop import init_jax_variables  # noqa: E402
from infomax3d_tpu_torch.losses import get_loss  # noqa: E402
from infomax3d_tpu_torch.models import base  # noqa: E402
from infomax3d_tpu_torch.models.registry import build_model  # noqa: E402
from infomax3d_tpu_torch.parallel import (CrossDeviceLoss, close_group,  # noqa: E402
                                          make_grid, make_group,
                                          using_groups)
from infomax3d_tpu_torch.parallel import (edge_partition,  # noqa: E402
                                          node_partition)
from infomax3d_tpu_torch.parallel.edge_partition import \
    shard_batch_edges  # noqa: E402
from infomax3d_tpu_torch.parallel.collectives import all_reduce_  # noqa: E402
from infomax3d_tpu_torch.parallel.context import data_parallel_group  # noqa: E402
from infomax3d_tpu_torch.train import supervised as supervised_mod  # noqa: E402
from infomax3d_tpu_torch.train import trainer as port_trainer  # noqa: E402
from infomax3d_tpu_torch.train.pretrain import PretrainStep  # noqa: E402
from infomax3d_tpu_torch.train.supervised import SupervisedStep  # noqa: E402

K = 2            # ranks
B = 16           # the global batch: 8 molecules per rank
DATA = dict(seed=0, n_min=8, n_max=18)

# tests/test_parallel.py's small widths
PNA = dict(hidden_dim=16, target_dim=12,
           aggregators=["mean", "max", "min", "std"],
           scalers=["identity", "amplification", "attenuation"],
           readout_aggregators=["min", "max", "mean"],
           mid_batch_norm=True, last_batch_norm=True,
           readout_batchnorm=True, batch_norm_momentum=0.93,
           propagation_depth=2, readout_layers=1, pretrans_layers=1,
           posttrans_layers=1)
NET3D = dict(hidden_dim=12, target_dim=12,
             readout_aggregators=["min", "max", "mean"], batch_norm=True,
             readout_batchnorm=True, batch_norm_momentum=0.93,
             node_wise_output_layers=0, message_net_layers=1,
             update_net_layers=1, reduce_func="mean",
             fourier_encodings=4, propagation_depth=1, readout_layers=1)
GIN = dict(target_dim=2, num_layers=2, hidden_dim=16, emb_dim=16,
           dropout=0.0, virtual_node=False)
AE = dict(projection_dim=8, projection_layers=2, distance_net=True,
          hidden_dim=8, node_wise_encoder_layers=0,
          node_wise_output_layers=0, message_net_layers=1,
          update_net_layers=1, reduce_func="mean", fourier_encodings=4,
          encoder_depth=1, decoder_depth=0, dropout=0.0, batch_norm=True,
          batch_norm_momentum=0.93,
          readout_aggregators=["min", "max", "mean"])
DP = dict(target_dim=1, projection_dim=0, distance_net=True,
          projection_layers=1, transformer_layer=False,
          pna_args={k: v for k, v in PNA.items()
                    if k not in ("target_dim", "readout_aggregators",
                                 "readout_layers", "readout_batchnorm")})
PREDICTOR = dict(predictor_layers=2, predictor_hidden_size=12,
                 predictor_batchnorm=True, metric_dim=12, ma_decay=0.9)
BYOL = {"model": dict(PREDICTOR, model_type="PNA", model_parameters=PNA),
        "model3d": dict(PREDICTOR, model_type="Net3D",
                        model_parameters=NET3D)}

# each flavour of the trainers' base step machinery: trainer, collate and
# its arguments, loss and its arguments, models (type, parameters)
FLAVOURS = {
    "alternating": ("alternating", "contrastive_collate", {}, "NTXent",
                    {"tau": 0.2}, {"model": ("PNA", PNA),
                                   "model3d": ("Net3D", NET3D)}),
    "autoencoder": ("autoencoder", "contrastive_collate_ae", {}, "NTXentAE",
                    {"tau": 0.1, "reconstruction_reg": 1.0},
                    {"model": ("PNA", dict(PNA, target_dim=24)),
                     "model3d": ("Net3DAE", AE)}),
    # noise 0: a collate's augmentation draws from default_rng(0) over its
    # own items, so a shard's draws are not the whole batch's
    "noisy_negatives": ("noisy_negatives", "noised_distances_collate",
                        {"std": 0.0}, "NTXentExtraNegatives",
                        {"tau": 0.2, "extra_negatives_weight": 0.8},
                        {"model": ("PNA", PNA), "model3d": ("Net3D", NET3D)}),
    "graphcl": ("graphcl_trainer", "graphcl_collate", {"drop_ratio": 0.0},
                "NTXent", {"tau": 0.1}, {"model": ("PNA", PNA)}),
    "byol": ("byol", "contrastive_collate", {}, "CosineSimilarityLoss", {},
             {"model": ("BYOLwrapper", BYOL["model"]),
              "model3d": ("BYOLwrapper", BYOL["model3d"])}),
    "distance": ("distance_predictor", "pairwise_distance_collate", {},
                 "L1Loss", {}, {"model": ("DistancePredictor", DP)}),
}
CASES = ("contrastive", "supervised", "local") + tuple(FLAVOURS)


class Molecules:
    """B synthetic molecules (2D graph, 3D graph, two binary labels, one
    of them NaN) as item dicts."""

    def __init__(self):
        ds = SyntheticMolecules(B, num_targets=2, **DATA)
        labels = (ds.targets > 0).astype(np.float32)
        labels[3, 1] = np.nan
        self.items = [{"graph2d": ds.graph2d(i), "graph3d": ds.graph3d(i),
                       "targets": labels[i]} for i in range(B)]

    def __len__(self):
        return B

    def __getitem__(self, i):
        return self.items[i]


def buckets(items):
    """The whole batch's CSR buckets of the 2D graphs and of the complete
    graphs (on the 2D node count), each K times the larger shard's need,
    so that the K-way cut holds every shard."""
    out = []
    for key in ("graph2d", "graph3d"):
        per = [bucket_for([it[key] for it in items[s * B // K:
                                                   (s + 1) * B // K]],
                          B // K) for s in range(K)]
        whole = bucket_for([it[key] for it in items], B)
        out.append(BucketSpec(B, K * max(b.n_nodes for b in per),
                              K * max(b.n_edges for b in per),
                              whole.max_deg, True, whole.nmax))
    b2, b3 = out
    return b2, BucketSpec(B, b2.n_nodes, b3.n_edges, b3.max_deg, True,
                          b3.nmax)


def tight_buckets(items):
    """The whole batch's smallest buckets (`bucket_for`; the complete
    graphs on the 2D node count), so that a cut of the nodes in two
    halves falls inside the real nodes."""
    b2 = bucket_for([it["graph2d"] for it in items], B)
    b3 = bucket_for([it["graph3d"] for it in items], B)
    return b2, dataclasses.replace(b3, n_nodes=b2.n_nodes)


def loader(collate, n_shards, shard, csr=True, cut=None, tight=False,
           **kw):
    """The first batch of shard `shard` of `n_shards` (the whole batch
    for 1), unshuffled; with `csr` False in the non-CSR buckets (the
    partitioned modes' batch), `tight` in `tight_buckets`, each graph view
    passed through `cut`."""
    ds = Molecules()
    b2, b3 = (dataclasses.replace(b, csr=csr) for b in (
        tight_buckets(ds.items) if tight else buckets(ds.items)))
    if collate != "graphcl_collate" and collate != "graph_collate":
        kw["bucket3d"] = b3
    fn = get_collate(collate)
    if cut is not None:
        fn = partition_collate(fn, cut)
    return next(iter(GraphDataLoader(ds, B, fn, bucket=b2,
                                     shuffle=False, prefetch=0,
                                     collate_kwargs=kw, n_shards=n_shards,
                                     shard=shard)))


def variables(models, seed=1):
    """Seeded numpy weights in the flax layout for each model key."""
    return {k: dict(zip(("params", "batch_stats"),
                        init_jax_variables(mp, seed + i, name)))
            for i, (k, (name, mp)) in enumerate(sorted(models.items()))}


def _record(loss, named, modules, extra=None):
    out = {"loss": float(loss)}
    out.update({n: p.grad.detach().numpy().copy() for n, p in named})
    for pre, m in modules.items():
        out.update({f"{pre}.{n}": v.detach().numpy().copy()
                    for n, v in m.named_buffers() if "running" in n})
    out.update(extra or {})
    return out


def contrastive(group, rank, k):
    """PNA + the flat Net3D, NT-Xent (tau 0.1), one float32 step."""
    var = variables({"model": ("PNA", PNA), "model3d": ("Net3D", NET3D)})
    step = PretrainStep(PNA, NET3D, var, "cpu", None, {"tau": 0.1},
                        {"lr": 1e-3}, "NTXent", "Net3D", "PNA")
    if group is not None:
        step.loss_fn = CrossDeviceLoss(step.loss_fn, group)
    view = loader("contrastive_collate", k, rank)
    g2, g3 = step.prepare(to_device(view["graph2d"], "cpu"),
                          to_device(view["graph3d"], "cpu"))
    with using_groups(data=group):
        loss = step.loss_and_grads(g2, g3)
    return _record(loss, step.named_parameters(),
                   {"model": step.model, "model3d": step.model3d})


def supervised(group, rank, k):
    """OGBGNN (GIN), masked BCE over two labels with a NaN, one float32
    step."""
    var = variables({"model": ("OGBGNN", GIN)})["model"]
    step = SupervisedStep("OGBGNN", GIN, var, "cpu", None,
                          "BCEWithLogitsLoss", {"lr": 1e-3})
    g = step.prepare(to_device(loader("graph_collate", k, rank)["graph"],
                               "cpu"))
    with using_groups(data=group):
        loss = step.loss_and_grads(g)
    return _record(loss, (("model." + n, p) for n, p in
                          step.model.named_parameters()),
                   {"model": step.model})


LOCAL_N, LOCAL_G, LOCAL_D = 40, 8, 6


def local_inputs():
    """Node rows [N, D] (the last 3 of each half padding), graph rows
    [G, D], each real node's graph id (G/2 graphs per half), seeded."""
    rng = np.random.default_rng(5)
    zn = rng.normal(size=(LOCAL_N, LOCAL_D)).astype(np.float32)
    zg = rng.normal(size=(LOCAL_G, LOCAL_D)).astype(np.float32)
    half_n, half_g = LOCAL_N // K, LOCAL_G // K
    ids = np.sort(rng.integers(0, half_g, size=half_n)).astype(np.int32)
    mask = np.arange(half_n) < half_n - 3
    node_graph = np.concatenate([np.where(mask, ids, half_g)] * K)
    node_mask = np.concatenate([mask] * K)
    return zn, zg, node_graph, node_mask


def local(group, rank, k):
    """`NTXentLocalGlobal` through `CrossDeviceLoss` on each rank's half
    of seeded node and graph rows (local graph ids, `_n_graphs_local`),
    or the plain loss on the whole (ids offset by hand); the gradients
    of the node and graph rows."""
    zn, zg, node_graph, node_mask = local_inputs()
    loss_fn = get_loss("NTXentLocalGlobal", tau=0.3)
    if group is None:
        half_g = LOCAL_G // K
        off = np.repeat(np.arange(K) * half_g, LOCAL_N // K)
        node_graph = node_graph + off
        kw = {}
    else:
        n, g = LOCAL_N // k, LOCAL_G // k
        zn, zg = zn[rank * n:(rank + 1) * n], zg[rank * g:(rank + 1) * g]
        node_graph = node_graph[rank * n:(rank + 1) * n]
        node_mask = node_mask[rank * n:(rank + 1) * n]
        loss_fn = CrossDeviceLoss(loss_fn, group)
        kw = {"n_graphs_local": g}
    zn, zg = (torch.from_numpy(x).requires_grad_() for x in (zn, zg))
    loss = loss_fn(zn, zg, node_graph=torch.from_numpy(node_graph),
                   node_mask=torch.from_numpy(node_mask), **kw)
    loss.backward()
    return {"loss": float(loss.detach()), "zn": zn.grad.numpy().copy(),
            "zg": zg.grad.numpy().copy()}


def flavour(name, group, rank, k, run_dir):
    """One eval step, then one training step of the flavour's trainer
    (`_train_step`, the gradients read after the update) on the same
    batch: the eval loss and the rows the metrics read (`_rows`), the
    loss, gradients, running statistics and the logged parts of the loss;
    BYOL's teachers' running statistics and weights after their EMA."""
    trainer, collate, ckw, loss_name, loss_params, models = FLAVOURS[name]
    mods = {key: build_model(t, mp) for key, (t, mp) in models.items()}
    cls = port_trainer.get_trainer_class(trainer)
    kw = {"ma_decay": 0.9} if trainer == "byol" else {}
    tr = cls(mods, {"optimizer": "Adam", "optimizer_params": {"lr": 1e-3},
                    "bf16_compute": False}, metrics={}, main_metric="loss",
             run_dir=run_dir,
             loss_func=None if loss_name == "L1Loss"
             else get_loss(loss_name, **loss_params),
             loss_name=loss_name, device="cpu", use_tensorboard=False,
             init_variables=variables(models), group=group, **kw)
    tr.init_state()
    batch = loader(collate, k, rank, **ckw)
    eval_loss, eval_out = tr._eval_step(tr._prepare(batch))
    preds, targets = tr._rows(batch, eval_out)
    extra = dict(eval_loss=float(eval_loss), preds=preds, targets=targets)
    tr._write_lrs()
    loss, out = tr._train_step(tr._prepare(batch))
    extra.update({f"extra.{n}": v
                  for n, v in tr._extra_losses(out).items()})
    mods_stats = dict(mods)
    for key, teacher in getattr(tr.step, "teachers", {}).items():
        mods_stats[f"teacher.{key}"] = teacher
        extra.update({f"teacher.{key}.{n}": p.detach().numpy().copy()
                      for n, p in teacher.named_parameters()})
    tr.logger.close()
    return _record(loss, tr.named_parameters(), mods_stats, extra)


def _sum_over_ranks(tensors, group):
    """`mean_over_ranks` without the division (a planted fault)."""
    for t in tensors:
        all_reduce_(t, group)
    return list(tensors)


# planted faults of the data-parallel step, each run on the contrastive
# case: BatchNorm statistics left local, the loss on the local rows only,
# the gradients summed over the ranks instead of averaged
FAULTS = {
    "bn_local": (base, "step_group", lambda: None),
    "loss_local": (sys.modules[__name__], "CrossDeviceLoss",
                   lambda loss, group: loss),
    "grad_sum": (supervised_mod, "mean_over_ranks", _sum_over_ranks),
}


# the partitioned modes: (mode, case) on the non-CSR batch
PARTITION_CASES = {"edge_contrastive": ("edge", "contrastive"),
                   "node_contrastive": ("node", "contrastive"),
                   "edge_supervised": ("edge", "supervised"),
                   "node_supervised": ("node", "supervised"),
                   # the same step under remat: its recompute repeats the
                   # halo exchanges and the BatchNorm all-reduces
                   "node_contrastive_remat": ("node", "contrastive")}
GRID_CASES = {"grid_supervised": ("edge", "supervised")}


def _drop_ghost_cotangents(ctx, ct):
    """The halo exchange's backward without the ghosts' cotangents sent
    home (a planted fault)."""
    return (ct[:ctx.n_local].clone(), None) + (None,) * len(
        ctx.saved_tensors)


# planted faults of the partitioned steps: the edge shards' aggregations
# not completed, the halo exchange's backward dropping the ghost
# cotangents, the BatchNorm statistics not completed over the graph group
PARTITION_FAULTS = {
    "edge_no_completion": ("edge_contrastive", edge_partition,
                           "all_reduce_sum", lambda x, group: x),
    "halo_backward_dropped": ("node_contrastive",
                              node_partition._HaloExchange, "backward",
                              staticmethod(_drop_ghost_cotangents)),
    "bn_not_over_graph": ("node_contrastive", base, "step_group",
                          data_parallel_group),
}


def partition(name, grid):
    """Case `name` of `PARTITION_CASES` / `GRID_CASES` on this rank's part
    of its data shard's batch (`grid`), or, for None, in one process on
    the whole batch; one float32 step under the grid's groups.  One data
    shard takes `tight_buckets`, so each node shard holds real nodes and
    the cut splits a molecule."""
    mode, case = {**PARTITION_CASES, **GRID_CASES}[name]
    n_data, d = (1, 0) if grid is None else (grid.n_data, grid.data_index)
    cut = None
    if grid is not None and mode == "edge":
        def cut(v):
            return shard_batch_edges(v, grid.k, grid.graph_index)
    elif grid is not None:
        def cut(v):
            return node_partition.shard_graph_batch(v, grid.k,
                                                    grid.graph_index)
    ctx = using_groups() if grid is None else using_groups(
        data=grid.data, edge=grid.graph if mode == "edge" else None,
        node=grid.graph if mode == "node" else None, step=grid.step)
    if case == "contrastive":
        var = variables({"model": ("PNA", PNA), "model3d": ("Net3D", NET3D)})
        step = PretrainStep(PNA, NET3D, var, "cpu", None, {"tau": 0.1},
                            {"lr": 1e-3}, "NTXent", "Net3D", "PNA")
        if grid is not None and grid.data is not None:
            step.loss_fn = CrossDeviceLoss(step.loss_fn, grid.data)
        view = loader("contrastive_collate", n_data, d, csr=False, cut=cut,
                      tight=n_data == 1)
        batches = step.prepare(to_device(view["graph2d"], "cpu"),
                               to_device(view["graph3d"], "cpu"))
        named = list(step.named_parameters())
        modules = {"model": step.model, "model3d": step.model3d}
    else:
        var = variables({"model": ("OGBGNN", GIN)})["model"]
        step = SupervisedStep("OGBGNN", GIN, var, "cpu", None,
                              "BCEWithLogitsLoss", {"lr": 1e-3})
        view = loader("graph_collate", n_data, d, csr=False, cut=cut,
                      tight=n_data == 1)
        batches = (step.prepare(to_device(view["graph"], "cpu")),)
        named = [("model." + n, p) for n, p in step.model.named_parameters()]
        modules = {"model": step.model}
    step.remat = name.endswith("_remat")
    with ctx:
        loss = step.loss_and_grads(*batches)
    return _record(loss, named, modules)


def run_partition_suite(names, grid):
    """Every case of `names` and, on two ranks, each planted fault."""
    out = {}
    for name in names:
        torch.manual_seed(0)
        mode = {**PARTITION_CASES, **GRID_CASES}[name][0]
        out[name] = partition(name, dataclasses.replace(grid, mode=mode))
    if grid.n_data == 1:
        for fault, (name, module, attr, plant) in PARTITION_FAULTS.items():
            kept = module.__dict__[attr]
            setattr(module, attr, plant)
            try:
                mode = PARTITION_CASES[name][0]
                out[fault] = partition(name, dataclasses.replace(
                    grid, mode=mode))
            finally:
                setattr(module, attr, kept)
    return out


def run(name, group, rank, k, run_dir):
    torch.manual_seed(0)
    if name in FLAVOURS:
        return flavour(name, group, rank, k, run_dir)
    if name in FAULTS:
        module, attr, plant = FAULTS[name]
        kept = getattr(module, attr)
        setattr(module, attr, plant)
        try:
            return contrastive(group, rank, k)
        finally:
            setattr(module, attr, kept)
    return globals()[name](group, rank, k)


def main(rank: int, world: int, out_dir: str, suite: str = "dp") -> None:
    torch.set_num_threads(1)
    group, _ = make_group(world, rank, f"file://{out_dir}/store", "gloo",
                          "cpu")
    try:
        if suite == "dp":
            results = {name: run(name, group, rank, world,
                                 os.path.join(out_dir, f"run{rank}"))
                       for name in CASES + tuple(FAULTS)}
        elif suite == "partition":
            results = run_partition_suite(PARTITION_CASES,
                                          make_grid(1, world, "edge"))
        else:
            results = run_partition_suite(GRID_CASES,
                                          make_grid(2, world // 2, "edge"))
    finally:
        close_group()
    with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(results, f)


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], *sys.argv[4:])
