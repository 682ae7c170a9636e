"""The supervised training step (port of the JAX package's `Trainer` step,
`infomax3d_tpu/train/trainer.py`: `loss_fn`, `_apply` and the jitted
update, with `_elementwise_supervised_loss`) for any registered model on
a labelled batch (the CSR batch, or the transformer's dense one): the
forward, the loss masked to the real graphs' finite labels, the backward
and the update.  `supervised()` runs it at the architecture of
`configs/30.yml` by default: OGBGNN, GIN 5x300 without a virtual node,
sum pooling, masked `BCEWithLogitsLoss`, Adam at lr 1e-3, batches of 128.

Dropout: in training the step hands the model the noise source it is
given (the trainer's `noise.MasksOnly` over its generator: masks and no
noise, as the JAX trainer's ``dropout`` rng); eval draws nothing.  Every
supervised model's forward takes the source; those without dropout draw
nothing from it.

Precision follows the JAX package's recipe: float32 master parameters and
optimizer state, the forward on bf16 copies of the parameters and of the
batch's float fields, the model output cast to float32 for the loss.  The
labels reach the loss in float32 (the JAX trainer reads them from the
uncast batch).  Under a data-parallel group (`parallel.context`) the
masked loss sums its total and count over the ranks, and `TrainStep`
averages the gradients and the loss over them; under a model group
(tensor parallelism, `parallel/tp.py`) each rank's gradients are its
shards', and the replicated leaves' are model rank 0's.

`SupervisedStep` is the step of the supervised trainer
(`train/trainer.py::Trainer`, built there by `from_modules` over the
config's model and grouped optimizer).  `supervised()` runs a few steps on
one fixed labelled synthetic batch, on the CUDA card unless asked for the
CPU.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Mapping, Optional, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F

from infomax3d_tpu_torch.data.loader import (DENSE_COLLATES, san_collate,
                                             smp_collate, to_device)
from infomax3d_tpu_torch.data.synthetic import SyntheticMolecules
from infomax3d_tpu_torch.device import resolve_device
from infomax3d_tpu_torch.graphs.batch import (GraphBatch, batch_graphs,
                                              bucket_for, to_graph_batch)
from infomax3d_tpu_torch.graphs.dense import DenseBatch, to_dense_batch
from infomax3d_tpu_torch.interop import (flax_paths, init_jax_variables,
                                         load_variables)
from infomax3d_tpu_torch.models.noise import GeneratorNoise, MasksOnly
from infomax3d_tpu_torch.models.registry import build_model
from infomax3d_tpu_torch.parallel.collectives import (all_reduce_sum,
                                                      mean_over_ranks)
from infomax3d_tpu_torch.parallel import tp
from infomax3d_tpu_torch.parallel.context import (data_parallel_group,
                                                  model_group, step_group)
from infomax3d_tpu_torch.train.optim import build_adam, label_params
from infomax3d_tpu_torch.train.precision import (cast_batch, forward_in,
                                                 resolve_compute_dtype)
from infomax3d_tpu_torch.train.remat import using_remat
from infomax3d_tpu_torch.utils.spans import span


def supervised_loss(name: str, pred: torch.Tensor, target: torch.Tensor,
                    valid: torch.Tensor) -> torch.Tensor:
    """The mean of the per-element loss `name` over the entries where
    `valid` is true (padding graphs and NaN labels excluded), the JAX
    package's `_elementwise_supervised_loss`: under a data-parallel group
    the total and the count are summed over the ranks first."""
    t = torch.where(valid, target, torch.zeros((), device=target.device))
    if name in ("L1Loss", "MAE"):
        per = (pred - t).abs()
    elif name in ("MSELoss", "OGBNanLabelMSELoss"):
        per = (pred - t) ** 2
    elif name in ("BCEWithLogitsLoss", "OGBNanLabelBCEWithLogitsLoss"):
        per = F.relu(pred) - pred * t + torch.log1p(torch.exp(-pred.abs()))
    else:
        raise KeyError(f"unsupported supervised loss '{name}'")
    total = torch.where(valid, per, torch.zeros((), device=per.device)).sum()
    count = valid.sum()
    group = data_parallel_group()
    if group is not None:
        # data parallel: the global batch's total and count
        both = all_reduce_sum(torch.stack([total, count.to(total.dtype)]),
                              group)
        total, count = both[0], both[1]
    return total / count.clamp(min=1)


def detached(out):
    """`out` (a tensor, or a tuple or dict of them) detached."""
    if isinstance(out, torch.Tensor):
        return out.detach()
    if isinstance(out, dict):
        return {k: detached(v) for k, v in out.items()}
    return tuple(detached(v) for v in out)


class TrainStep:
    """Backward and update over a step's ``loss(*batches, **kw) -> (loss,
    outputs)`` on prepared batches; the steps set `optimizer`.  With
    `remat` (the config's ``remat: true``) the training forwards are
    recomputed in the backward (`train/remat.py`)."""

    remat = False

    def loss_and_grads(self, *batches, return_outputs: bool = False, **kw):
        """Forward and backward on prepared batches (`kw` to the step's
        `loss`): fills each master parameter's `.grad` (float32), updates
        the running statistics and returns the float32 loss (detached),
        with the outputs (detached) when `return_outputs`.  A parameter the
        loss does not reach (e.g. the last layer under "sum" jumping
        knowledge) gets a zero gradient (`fill_missing_grads`).  The spans
        ``step.forward`` (the step's `loss`) and ``step.backward`` (the
        rest) cover it (`utils/spans.py`)."""
        self.optimizer.zero_grad(set_to_none=True)
        with span("step.forward"), using_remat(self.remat):
            loss, out = self.loss(*batches, **kw)
        with span("step.backward"):
            loss.backward()
            grads = self.fill_missing_grads(
                p for group in self.optimizer.param_groups
                for p in group["params"])
            group = step_group()
            if group is not None:
                # the loss is already the global batch's on every rank, and
                # each collective's backward is its transpose (an all-reduce's
                # an all-reduce, an all-gather's the sum over ranks of the
                # cotangents of this rank's rows; the halo exchange's sends
                # the ghosts' cotangents home): each rank's gradient is then
                # that of the SUM over all the step's ranks of their equal
                # losses with respect to its own copy of the parameters.  The
                # copies are tied, so these gradients sum to (ranks) x
                # d(loss)/d(params), and one mean over every rank (data and
                # graph) is exact: on an edge shard the edge network's
                # gradient is k times its partial share and the node-space
                # parameters' is whole, and the mean over the k parts gives
                # the whole batch's gradient for both
                # (`parallel/collectives.py`).  Under tensor parallelism this
                # is the data group alone: the model ranks hold different
                # shards, each gradient already whole for its own
                mean_over_ranks(grads, group)
            model = model_group()
            if model is not None:
                tp.broadcast_replicated_grads(
                    (p for g in self.optimizer.param_groups
                     for p in g["params"]), model)
        if return_outputs:
            return loss.detach(), detached(out)
        return loss.detach()

    @staticmethod
    def fill_missing_grads(params) -> list:
        """Give each of `params` the loss did not reach a zero `.grad`, as
        `jax.grad` gives it one, so that Adam counts the step for it too
        and its bias correction stays the JAX optimizer's; returns the
        gradients in order."""
        grads = []
        for p in params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
            grads.append(p.grad)
        return grads

    def step(self, *batches, **kw) -> torch.Tensor:
        """One training step on prepared batches; returns the loss."""
        loss = self.loss_and_grads(*batches, **kw)
        with span("step.optimizer"):
            self.optimizer.step()
        return loss


class SupervisedStep(TrainStep):
    """Forward, masked loss, backward and Adam update of one model on one
    labelled batch.  `variables` holds the model's flax numpy trees
    (`interop.init_jax_variables` layout); `compute_dtype` bf16 runs the
    bf16 recipe, None float32.  Adam's groups are the JAX package's labels
    (`optim.label_params` on the flax paths).  This constructor builds a
    registered model; `from_modules` takes any module (the trainer's)."""

    def __init__(self, model_type: str, model_parameters: Mapping,
                 variables: Mapping, device: torch.device,
                 compute_dtype: Optional[torch.dtype] = None,
                 loss_func: str = "MSELoss",
                 optimizer_params: Optional[Mapping] = None):
        self._setup(load_variables(build_model(model_type, model_parameters),
                                   variables), device, compute_dtype,
                    loss_func)
        self.optimizer = build_adam(
            self.model.named_parameters(),
            labels=label_params(flax_paths(self.model))[0],
            **dict(optimizer_params or {}))

    @classmethod
    def from_modules(cls, model: torch.nn.Module, device: torch.device,
                     compute_dtype: Optional[torch.dtype], loss_func: str,
                     optimizer: Optional[torch.optim.Optimizer] = None
                     ) -> "SupervisedStep":
        """The step over a given module, loss name and optimizer (the
        trainer's); `optimizer` may be set later, before the first step."""
        step = cls.__new__(cls)
        step._setup(model, device, compute_dtype, loss_func)
        step.optimizer = optimizer
        return step

    def _setup(self, model, device, compute_dtype, loss_func):
        self.device = torch.device(device)
        self.compute_dtype = compute_dtype
        self.loss_func = loss_func
        self.model = model.to(self.device).train()

    def prepare(self, g: GraphBatch) -> GraphBatch:
        """The batch as the forward reads it: on the step's device, float
        fields in the compute dtype, the labels kept float32."""
        g = g.to(self.device)
        return dataclasses.replace(cast_batch(g, self.compute_dtype),
                                   targets=g.targets)

    def loss(self, g: GraphBatch, noise=None
             ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(masked loss, float32 predictions) on a prepared batch (a
        `GraphBatch` or a `DenseBatch`), under the recipe (training or
        eval, as the module is set); `noise` draws the dropout masks."""
        pred = forward_in(self.model, self.compute_dtype, g, noise=noise)
        valid = ~torch.isnan(g.targets) & g.graph_mask[:, None]
        return supervised_loss(self.loss_func, pred, g.targets, valid), pred


def labelled_batch(batch_size: int, num_targets: int = 1, seed: int = 0,
                   n_min: int = 10, n_max: int = 41, device="cpu",
                   dense: bool = False, max_nodes: int = 40,
                   smp_cutoff: Optional[float] = None
                   ) -> Tuple[Union[GraphBatch, DenseBatch], Dict[str, int]]:
    """`batch_size` synthetic molecules as a CSR batch with binary labels
    (their `targets` > 0, float32 0/1, [G, num_targets]), plus its sizes:
    graphs, real nodes and real edges.  With `dense`, the transformer's
    dense batch (`san_collate`, the larger of `max_nodes` and the largest
    molecule's slots per graph); with `smp_cutoff`, SMP's radius graphs
    and triplets (`smp_collate`, its smallest bucket; the sizes then count
    radius-graph edges and also the triplets).  The defaults are
    molhiv-like: 10 to 41 atoms, 25.5 on average."""
    ds = SyntheticMolecules(batch_size, seed=seed, n_min=n_min, n_max=n_max,
                            num_targets=num_targets)
    labels = (ds.targets > 0).astype(np.float32)
    mols = [dict(ds.graph2d(i), targets=labels[i]) for i in range(batch_size)]
    b = bucket_for(mols, batch_size)
    items = [{"graph2d": ds.graph2d(i), "targets": labels[i]}
             for i in range(batch_size)]
    sizes = {"graphs": batch_size,
             "nodes": sum(m["node_feat"].shape[0] for m in mols),
             "edges": sum(m["senders"].shape[0] for m in mols)}
    if smp_cutoff is not None:
        g = to_device(smp_collate(items, None, smp_cutoff)["graph"], device)
        sizes.update(edges=int(g.edge_mask.sum()),
                     triplets=int(g.tri_mask.sum()))
    elif dense:
        g = to_dense_batch(san_collate(items, b, max(max_nodes, b.nmax))[
            "graph"], device)
    else:
        g = to_graph_batch(batch_graphs(mols, b), b, device)
    return g, sizes


def build_supervised_step(args: Mapping[str, Any], device: torch.device
                          ) -> SupervisedStep:
    """`SupervisedStep` from a config-like dict with the YAML keys
    `model_type`, `model_parameters`, `loss_func`, `optimizer_params`,
    `bf16_compute` (default "auto"), `remat`, and seeded numpy weights in
    the flax layout (`seed`, default 0)."""
    mp = args["model_parameters"]
    params, stats = init_jax_variables(mp, args.get("seed", 0),
                                       args["model_type"])
    step = SupervisedStep(
        args["model_type"], mp, {"params": params, "batch_stats": stats},
        device, resolve_compute_dtype(args.get("bf16_compute", "auto"),
                                      device),
        args.get("loss_func", "MSELoss"), args.get("optimizer_params"))
    step.remat = bool(args.get("remat", False))
    return step


def masks_source(generator: torch.Generator) -> MasksOnly:
    """A training step's noise source: dropout masks from `generator`
    (on its device), no noise."""
    return MasksOnly(GeneratorNoise(generator))


def supervised(args: Dict[str, Any], steps: int = 1,
               device: Optional[str] = None) -> Dict[str, Any]:
    """Run `steps` supervised steps on one fixed labelled batch of
    `args["batch_size"]` (default 128) synthetic molecules
    (`args["dataset_params"]`: seed, n_min, n_max; `labelled_batch`'s
    molhiv-like defaults where absent), the dense batch where
    `args["collate_function"]` names a dense collate.  Each step draws its
    dropout masks on the device from one generator seeded with
    `args["seed"]`.  Runs on the CUDA card unless `device` says otherwise
    (and raises when there is none).  Returns the float32 losses, the step
    object and the batch sizes."""
    device = resolve_device(device)
    step = build_supervised_step(args, device)
    g, sizes = labelled_batch(
        args.get("batch_size", 128),
        args["model_parameters"].get("target_dim", 1), device=device,
        dense=args.get("collate_function") in DENSE_COLLATES,
        max_nodes=args.get("max_nodes", 40),
        smp_cutoff=(float(args["model_parameters"].get("cutoff", 5.0))
                    if args["model_type"] == "SMP" else None),
        **args.get("dataset_params", {}))
    g = step.prepare(g)
    gen = torch.Generator(device=device).manual_seed(int(args.get("seed",
                                                                  0)))
    losses = [step.step(g, noise=masks_source(gen)) for _ in range(steps)]
    return {"losses": [float(x) for x in losses], "step": step,
            "sizes": sizes}
