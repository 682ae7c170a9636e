"""The steps of the distance-supervised and GraphCL pre-training baselines
(the steps of the JAX package's `DistancePredictorTrainer`,
`SelfSupervisedAETrainer` and `GraphCLTrainer`, infomax3d_tpu/train/
trainer.py:771-826, 1043-1076):

* `DistanceStep`: a distance predictor on the 2D batch and its pair view
  (`pairwise_distance_collate`), the supervised loss of each real pair's
  prediction against its true distance;
* `AEStep`: the 2D model and `Net3DAE` on the contrastive batch, NT-Xent
  between the embeddings plus the reconstruction of the 3D view's
  distances (`NTXentAE`), the loss their sum;
* `GraphCLStep`: one model on two node-dropped views, the first then the
  second in training mode (so the BatchNorm running statistics move as
  the JAX ``s1 -> s2`` chain moves them), NT-Xent between the outputs.

Each follows the bf16 recipe of `train/precision.py` (float32 masters,
the forward on bf16 copies, outputs cast to float32).  As in the JAX
trainers, the targets stay float32: the pair view is not cast (only its
indices and mask reach the model) and the reconstruction reads the 3D
view's distances before the cast.  The trainers build these steps over
their models and grouped optimizer (`from_modules`); `build_baseline_step`
builds one from a config-like dict with seeded numpy weights, and
`baseline_batches` makes a fixed synthetic batch for it (the card checks
of `chip_smoke.py`).
"""
from __future__ import annotations

from typing import Any, Dict, Mapping, Optional, Tuple

import torch

from infomax3d_tpu_torch.data.loader import (COLLATE_ALIASES, get_collate,
                                              to_device)
from infomax3d_tpu_torch.data.synthetic import SyntheticMolecules
from infomax3d_tpu_torch.graphs.batch import (BucketSpec, GraphBatch,
                                              bucket_for)
from infomax3d_tpu_torch.interop import (flax_paths, init_jax_variables,
                                         load_variables)
from infomax3d_tpu_torch.losses import get_loss
from infomax3d_tpu_torch.models.registry import build_model
from infomax3d_tpu_torch.train.optim import build_adam, label_params
from infomax3d_tpu_torch.train.pretrain import PretrainStep, noise_kw
from infomax3d_tpu_torch.train.precision import (cast_batch, forward_in,
                                                 resolve_compute_dtype)
from infomax3d_tpu_torch.train.supervised import SupervisedStep, \
    supervised_loss


class DistanceStep(SupervisedStep):
    """Forward, masked loss, backward and update of a distance predictor
    (``model(g, pairs) -> [E, 1]``) on one batch and its pair view; the
    target is ``pairs.edge_dist[:, None]`` on ``pairs.edge_mask``."""

    def prepare(self, g: GraphBatch, pairs: GraphBatch
                ) -> Tuple[GraphBatch, GraphBatch]:
        """Both batches on the step's device; the graph's float fields in
        the compute dtype, the pair view as it is."""
        same = pairs is g
        g = g.to(self.device)
        pairs = g if same else pairs.to(self.device)
        return cast_batch(g, self.compute_dtype), pairs

    def loss(self, g: GraphBatch, pairs: GraphBatch, noise=None):
        """(masked loss, float32 predictions [E, 1]); `noise` draws the
        dropout masks."""
        pred = forward_in(self.model, self.compute_dtype, g, pairs,
                          **noise_kw(noise))
        target = pairs.edge_dist[:, None].float()
        valid = pairs.edge_mask[:, None]
        return supervised_loss(self.loss_func, pred, target, valid), pred



class AEStep(PretrainStep):
    """The contrastive step with distance reconstruction: ``model`` on the
    2D batch, ``model3d`` (`Net3DAE`) on the 3D complete graphs returning
    (embedding, distances), and ``loss_fn(z1, z2, distances=...,
    distance_pred=..., mask=...) -> (contrastive, reconstruction)``."""

    def prepare(self, g2: GraphBatch, g3: GraphBatch):
        """`PretrainStep.prepare`'s batches and the 3D view's float32
        distances (the reconstruction targets)."""
        dist = g3.edge_dist.to(self.device).float()
        return (*super().prepare(g2, g3), dist)

    def loss(self, g2, g3, dist, noise=None):
        """(contrastive + reconstruction, (z1, z2, {"contrastive_loss",
        "reconstruction_loss"})), float32; `noise` draws the dropout
        masks."""
        z1 = forward_in(self.model, self.compute_dtype, g2,
                        **noise_kw(noise))
        z2, pred = forward_in(self.model3d, self.compute_dtype, g3,
                              **noise_kw(noise))
        lc, lr = self.loss_fn(z1, z2, distances=dist, distance_pred=pred,
                              mask=g3.edge_mask)
        return lc + lr, (z1, z2, {"contrastive_loss": lc,
                                  "reconstruction_loss": lr})


class GraphCLStep(PretrainStep):
    """One model on two augmented views of the same molecules; the loss
    between its two outputs.  ``model3d`` is the same module, so
    `named_parameters` and `paths` list it once."""

    @classmethod
    def from_modules(cls, model: torch.nn.Module, device: torch.device,
                     compute_dtype: Optional[torch.dtype], loss_fn,
                     optimizer: Optional[torch.optim.Optimizer] = None
                     ) -> "GraphCLStep":
        return super().from_modules(model, model, device, compute_dtype,
                                    loss_fn, optimizer)

    def paths(self) -> Dict[str, str]:
        return {f"model.{n}": f"model/{p}"
                for n, p in flax_paths(self.model).items()}

    def named_parameters(self):
        for n, p in self.model.named_parameters():
            yield f"model.{n}", p

    def outputs(self, v1: GraphBatch, v2: GraphBatch, noise=None):
        """The model on `v1`, then on `v2` (float32 outputs)."""
        return (forward_in(self.model, self.compute_dtype, v1,
                           **noise_kw(noise)),
                forward_in(self.model, self.compute_dtype, v2,
                           **noise_kw(noise)))


def _variables(model_type: str, mp: Mapping, seed: int) -> Dict[str, Any]:
    params, stats = init_jax_variables(mp, seed, model_type)
    return {"params": params, "batch_stats": stats}


def build_baseline_step(args: Mapping[str, Any], device: torch.device):
    """The step of one baseline from a config-like dict with the YAML keys
    `trainer`, `model_type`, `model_parameters`, `model3d_type`,
    `model3d_parameters`, `loss_func`, `loss_params`, `optimizer_params`
    `bf16_compute` (default "auto") and `remat`: `GraphCLStep` for
    ``trainer: graphcl_trainer``, `AEStep` with a 3D model, else
    `DistanceStep`.  Weights are seeded numpy trees in the flax layout
    (`seed`, default 0; the 3D model takes `seed + 1`); Adam's groups are
    the JAX package's labels."""
    device = torch.device(device)
    seed = args.get("seed", 0)
    dtype = resolve_compute_dtype(args.get("bf16_compute", "auto"), device)
    loss_name = args["loss_func"]
    model = load_variables(
        build_model(args["model_type"], args["model_parameters"]),
        _variables(args["model_type"], args["model_parameters"], seed))
    if args.get("trainer") == "graphcl_trainer":
        step = GraphCLStep.from_modules(
            model, device, dtype,
            get_loss(loss_name, **dict(args.get("loss_params") or {})))
    elif args.get("model3d_type"):
        m3 = args["model3d_type"]
        model3d = load_variables(
            build_model(m3, args["model3d_parameters"]),
            _variables(m3, args["model3d_parameters"], seed + 1))
        step = AEStep.from_modules(
            model, model3d, device, dtype,
            get_loss(loss_name, **dict(args.get("loss_params") or {})))
    else:
        step = DistanceStep.from_modules(model, device, dtype, loss_name)
    if isinstance(step, PretrainStep):
        named, paths = list(step.named_parameters()), step.paths()
    else:
        named = [(f"model.{n}", p) for n, p in model.named_parameters()]
        paths = {f"model.{n}": f"model/{p}"
                 for n, p in flax_paths(model).items()}
    step.optimizer = build_adam(named, labels=label_params(paths)[0],
                                **dict(args.get("optimizer_params") or {}))
    step.remat = bool(args.get("remat", False))
    return step


def baseline_batches(args: Mapping[str, Any], batch_size: int,
                     seed: int = 0, n_min: int = 10, n_max: int = 26,
                     device="cpu") -> Tuple[tuple, Dict[str, int]]:
    """One fixed batch of `batch_size` synthetic molecules of `n_min` to
    `n_max` atoms through the config's collate (`collate_function`,
    `collate_params`), as the batches its step reads on `device`, plus
    their sizes: graphs, 2D edges and the pair view's or 3D view's edges.
    The 3D bucket holds the batch's complete graphs on the 2D bucket's
    node count."""
    ds = SyntheticMolecules(batch_size, seed=seed, n_min=n_min, n_max=n_max)
    items = [{"graph2d": ds.graph2d(i), "graph3d": ds.graph3d(i)}
             for i in range(batch_size)]
    b2 = bucket_for([it["graph2d"] for it in items], batch_size)
    b3 = bucket_for([it["graph3d"] for it in items], batch_size)
    b3 = BucketSpec(b3.n_graphs, b2.n_nodes, b3.n_edges, b3.max_deg, True,
                    b3.nmax)
    collate = COLLATE_ALIASES.get(args["collate_function"],
                                  args["collate_function"])
    kw = dict(args.get("collate_params") or {})
    if collate in ("pairwise_distance_collate", "contrastive_collate_ae"):
        kw["bucket3d"] = b3
    view = get_collate(collate)(items, b2, **kw)
    names = {"graphcl_collate": ("view1", "view2"),
             "pairwise_distance_collate": ("graph", "pairs")}.get(
                 collate, ("graph2d", "graph3d"))
    batches = tuple(to_device(view[k], device) for k in names)
    if view[names[0]] is view[names[1]]:
        batches = (batches[0], batches[0])
    sizes = {"graphs": batch_size,
             "edges_2d": int(batches[0].csr_row_ptr[-1]),
             "edges_pairs": int(batches[1].csr_row_ptr[-1])}
    return batches, sizes
