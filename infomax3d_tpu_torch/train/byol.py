"""The BYOL pre-training step (port of the JAX package's `BYOLTrainer`
step, `infomax3d_tpu/train/trainer.py:829-912`; reference
trainer/byol_trainer.py and trainer/byol_wrapper.py).

``model`` and ``model3d`` are `BYOLWrapper`s.  Each has a teacher: a copy
of its student made when the step is built, with that student's
BatchNorm running statistics, outside the optimizer and without
gradients.  In training the teachers run in train mode under
`torch.no_grad()`: they normalize with batch statistics and move their
own running statistics, as the reference's teacher under `no_grad` does;
in eval they read their running statistics and leave them alone.  The loss
is ``L(pred2_s, proj3_t) + L(proj2_t, pred3_s)``, each prediction against
the other side's teacher projection.  After each optimizer step the
teachers' float32 parameters move by EMA, ``t <- t * d + s * (1 - d)``
toward their students (`ma_decay` d): by default only the 2D teacher, as
the reference does (byol_trainer.py:24), both with `ema_all`.  The
outputs the metrics read are the students' predictions.

Precision is the contrastive step's: the bf16 recipe runs the students
and the teachers on bf16 copies of their float32 parameters.  Under
tensor parallelism (`parallel/tp.py`) a teacher is a copy of its sharded
student: its forward gathers like the student's, and the EMA runs shard
by shard, so it equals one process's.
"""
from __future__ import annotations

import copy
from typing import Any, Mapping, Optional

import torch

from infomax3d_tpu_torch.interop import init_jax_variables, load_variables
from infomax3d_tpu_torch.losses import get_loss
from infomax3d_tpu_torch.models.registry import build_model
from infomax3d_tpu_torch.train.optim import build_adam, label_params
from infomax3d_tpu_torch.train.precision import (forward_in,
                                                 resolve_compute_dtype)
from infomax3d_tpu_torch.train.pretrain import PretrainStep


def teacher_of(wrapper: torch.nn.Module) -> torch.nn.Module:
    """A copy of `wrapper`'s student, its parameters frozen."""
    teacher = copy.deepcopy(wrapper.student)
    teacher.requires_grad_(False)
    return teacher


class BYOLStep(PretrainStep):
    """`PretrainStep` over two `BYOLWrapper`s with their teachers
    (module docstring).  `teachers` maps ``model`` / ``model3d`` to the
    teacher modules; `step` runs the update and then the EMA."""

    @classmethod
    def from_modules(cls, model: torch.nn.Module, model3d: torch.nn.Module,
                     device: torch.device,
                     compute_dtype: Optional[torch.dtype], loss_fn,
                     optimizer: Optional[torch.optim.Optimizer] = None,
                     ma_decay: float = 0.99, ema_all: bool = False
                     ) -> "BYOLStep":
        step = super().from_modules(model, model3d, device, compute_dtype,
                                    loss_fn, optimizer)
        step.ma_decay = ma_decay
        step.ema_keys = ("model", "model3d") if ema_all else ("model",)
        step.teachers = {"model": teacher_of(step.model),
                         "model3d": teacher_of(step.model3d)}
        return step

    def teacher_projections(self, g2, g3):
        """Both teachers' float32 projections, without autograd, each in
        the mode of the students (train: batch statistics, its running
        statistics moved)."""
        out = []
        with torch.no_grad():
            for key, g in (("model", g2), ("model3d", g3)):
                teacher = self.teachers[key].train(self.model.training)
                out.append(forward_in(teacher, self.compute_dtype, g).float())
        return out

    def loss(self, g2, g3):
        """(float32 loss, the students' predictions) on prepared batches."""
        pred2, _ = forward_in(self.model, self.compute_dtype, g2)
        pred3, _ = forward_in(self.model3d, self.compute_dtype, g3)
        proj2_t, proj3_t = self.teacher_projections(g2, g3)
        loss = self.loss_fn(pred2, proj3_t) + self.loss_fn(proj2_t, pred3)
        return loss, (pred2, pred3)

    @torch.no_grad()
    def update_teachers(self):
        """The EMA of the teachers in `ema_keys` toward their students'
        float32 parameters: ``t * d + s * (1 - d)``, each product rounded,
        then the sum."""
        d = self.ma_decay
        for key in self.ema_keys:
            ts = list(self.teachers[key].parameters())
            ss = [p.detach() for p in getattr(self, key).student.parameters()]
            torch._foreach_mul_(ts, d)
            torch._foreach_add_(ts, torch._foreach_mul(ss, 1.0 - d))

    def step(self, *batches, **kw) -> torch.Tensor:
        loss = super().step(*batches, **kw)
        self.update_teachers()
        return loss


def build_byol_step(args: Mapping[str, Any], device: torch.device
                    ) -> BYOLStep:
    """`BYOLStep` from a config-like dict: `model_parameters` and
    `model3d_parameters` (each a BYOL wrapper's: its `model_type` and
    `model_parameters`, the predictor's fields), `loss_func` (default
    "CosineSimilarityLoss"), `loss_params`, `optimizer_params`,
    `bf16_compute` (default "auto"), `byol_ema_all`, `remat`, and seeded numpy
    weights in the flax layout (`seed`; the 3D wrapper takes `seed + 1`);
    the EMA's decay is the 2D wrapper's `ma_decay` (default 0.99), as the
    CLI reads it."""
    seed = args.get("seed", 0)
    models = {}
    for key, off in (("model", 0), ("model3d", 1)):
        mp = args[f"{key}_parameters"]
        params, stats = init_jax_variables(mp, seed + off, "BYOLwrapper")
        models[key] = load_variables(build_model("BYOLwrapper", mp),
                                     {"params": params, "batch_stats": stats})
    decay = args["model_parameters"].get("ma_decay", 0.99)
    step = BYOLStep.from_modules(
        models["model"], models["model3d"], device,
        resolve_compute_dtype(args.get("bf16_compute", "auto"), device),
        get_loss(args.get("loss_func", "CosineSimilarityLoss"),
                 **dict(args.get("loss_params") or {})),
        ma_decay=decay, ema_all=bool(args.get("byol_ema_all", False)))
    step.optimizer = build_adam(step.named_parameters(),
                                labels=label_params(step.paths())[0],
                                **dict(args.get("optimizer_params") or {}))
    step.remat = bool(args.get("remat", False))
    return step
