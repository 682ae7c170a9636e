"""The reference's training steps: the configuration's models, loss and
learning-rate schedule, each a file of its own found by name
(`reference/models/<model_type>.py`, `reference/losses/<loss_func>.py`,
`reference/schedules/<lr_scheduler>.py`, see `Parts`), and Adam, on
float32 parameters with TF32 off, from the weights it is given.

A model file gives ``shape(params)`` (its widths and layouts, from the
configuration's ``<key>_parameters``), ``spec(shape)`` (every tensor,
named as the published state dict names it, with its shape and
initializer), ``view(shape, mols, device)`` (the batch it reads, built
from the raw molecules) and ``forward(shape, layers, batch)``.  A loss
file gives ``loss(params, outputs, batch)``: the models' outputs by key,
and the step's batch (each model's view by key, and ``targets`` [B, T]
where the molecules carry them), to a scalar.  A schedule file gives
``learning_rates(lr, params, steps)``; without a scheduler the rate is
constant.

`ReferenceRun.record` gives what the benchmark compares: the loss of each
step, the models' outputs at the first step, each leaf's first gradient
norm and each leaf's change after the steps (the BatchNorm running
statistics counted as leaves of the change)."""
from __future__ import annotations

import math
from typing import Callable, Dict, List, Mapping, Sequence

import numpy as np
import torch

from bench_port.reference.nn import Layers, Spec, identity

# the models a configuration may name, in the trainer's order
MODEL_KEYS = ("model", "model3d")
BUFFER_SUFFIXES = ("running_mean", "running_var", "num_batches_tracked")


def model_keys(config: Mapping) -> tuple:
    """``model``, and ``model3d`` where the configuration names a 3D model:
    the keys of the trainer's `MODEL_KEYS`."""
    return tuple(k for k in MODEL_KEYS if config.get(f"{k}_type"))


class Parts:
    """The reference's files of a configuration, found by `find(kind,
    name)` (the harness's `manifest.reference_file`): a model file per
    model key with its shape, the loss file, and the schedule file or
    None."""

    def __init__(self, config: Mapping, find: Callable):
        self.keys = model_keys(config)
        self.models = {k: find("models", config[f"{k}_type"])
                       for k in self.keys}
        self.shapes = {k: self.models[k].shape(config[f"{k}_parameters"])
                       for k in self.keys}
        self.loss = find("losses", config["loss_func"])
        sched = config.get("lr_scheduler")
        self.schedule = find("schedules", sched) if sched else None


def parameter_spec(parts: Parts) -> Spec:
    """Every tensor of the models (parameters and BatchNorm state), named
    ``<key>.<name>`` as the published state dicts name them, with its
    shape and initializer."""
    return [(f"{key}.{name}",) + tuple(rest) for key in parts.keys
            for name, *rest in parts.models[key].spec(parts.shapes[key])]


def is_buffer(name: str) -> bool:
    return name.endswith(BUFFER_SUFFIXES)


def learning_rates(config: Mapping, parts: Parts, steps: int) -> List[float]:
    """The learning rate of each of the first `steps` steps: the
    optimizer's lr, under the schedule file where the configuration names
    a scheduler."""
    lr = float((config.get("optimizer_params") or {}).get("lr", 1e-3))
    if parts.schedule is None:
        return [lr] * steps
    return parts.schedule.learning_rates(
        lr, config.get("lr_scheduler_params") or {}, steps)


class ReferenceRun:
    """The reference trained from `weights` (``<key>.*`` tensors,
    parameters and BatchNorm state) under the configuration's models, loss
    and schedule (`parts`) and Adam; `q` rounds the matrix products'
    operands (`nn.fp8` for the control)."""

    def __init__(self, config: Mapping, weights: Mapping[str, torch.Tensor],
                 parts: Parts, q: Callable = identity):
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        self.config = config
        self.parts = parts
        self.q = q
        op = dict(config.get("optimizer_params") or {})
        if float(op.get("weight_decay", 0.0)) or config.get(
                "optimizer", "Adam") != "Adam":
            raise NotImplementedError("the reference runs Adam without "
                                      "weight decay")
        self.betas = tuple(op.get("betas", (0.9, 0.999)))
        self.eps = float(op.get("eps", 1e-8))
        self.P = {k: {} for k in parts.keys}
        self.S = {k: {} for k in parts.keys}
        for name, w in weights.items():
            key, local = name.split(".", 1)
            if is_buffer(local):
                self.S[key][local] = w.detach().clone()
            else:
                self.P[key][local] = w.detach().float().clone() \
                    .requires_grad_(True)
        self.start = {n: t.detach().clone() for n, t in self.leaves()}
        self.m = {n: torch.zeros_like(t) for n, t in self.params()}
        self.v = {n: torch.zeros_like(t) for n, t in self.params()}
        self.t = 0
        self.losses: List[float] = []
        self.first_grad: Dict[str, float] = {}
        self.outputs = None

    def batch(self, mols: Sequence[Mapping[str, np.ndarray]], device) -> Dict:
        """One step's batch of the raw molecules: each model's view by key,
        and ``targets`` [B, T] float32 where the molecules carry them."""
        out = {k: self.parts.models[k].view(self.parts.shapes[k], mols,
                                            device)
               for k in self.parts.keys}
        if "targets" in mols[0]:
            out["targets"] = torch.as_tensor(
                np.stack([m["targets"] for m in mols]), dtype=torch.float32,
                device=device)
        return out

    def params(self):
        for key in self.parts.keys:
            for n, p in self.P[key].items():
                yield f"{key}.{n}", p

    def leaves(self):
        """Parameters and the float BatchNorm statistics, by name."""
        yield from self.params()
        for key in self.parts.keys:
            for n, b in self.S[key].items():
                if b.is_floating_point():
                    yield f"{key}.{n}", b

    def loss(self, batch: Mapping) -> torch.Tensor:
        outputs = {}
        for key in self.parts.keys:
            mp = self.config[f"{key}_parameters"]
            layers = Layers(self.P[key], self.S[key],
                            float(mp.get("batch_norm_momentum", 0.1)), self.q)
            outputs[key] = self.parts.models[key].forward(
                self.parts.shapes[key], layers, batch[key])
        if self.outputs is None:
            self.outputs = [z.detach().cpu().numpy()
                            for z in outputs.values()]
        return self.parts.loss.loss(self.config.get("loss_params") or {},
                                    outputs, batch)

    def step(self, batch: Mapping, lr: float) -> float:
        names, params = zip(*self.params())
        loss = self.loss(batch)
        grads = torch.autograd.grad(loss, params, allow_unused=True)
        self.t += 1
        b1, b2 = self.betas
        bc1, bc2 = 1 - b1 ** self.t, 1 - b2 ** self.t
        with torch.no_grad():
            for n, p, g in zip(names, params, grads):
                g = torch.zeros_like(p) if g is None else g
                if self.t == 1:
                    self.first_grad[n] = float(torch.linalg.vector_norm(g))
                self.m[n].mul_(b1).add_(g, alpha=1 - b1)
                self.v[n].mul_(b2).addcmul_(g, g, value=1 - b2)
                denom = (self.v[n].sqrt() / math.sqrt(bc2)).add_(self.eps)
                p.addcdiv_(self.m[n], denom, value=-lr / bc1)
        self.losses.append(float(loss.detach()))
        return self.losses[-1]

    def run(self, batches: Sequence[Mapping]) -> Dict:
        """The steps on `batches` (`batch`'s, one a step) at the config's
        learning rates; returns `record`."""
        lrs = learning_rates(self.config, self.parts, len(batches))
        for batch, lr in zip(batches, lrs):
            self.step(batch, lr)
        return self.record()

    def record(self) -> Dict:
        change = {n: float(torch.linalg.vector_norm(t.detach() -
                                                     self.start[n]))
                  for n, t in self.leaves()}
        return {"losses": list(self.losses), "grad": dict(self.first_grad),
                "change": change, "outputs": self.outputs}
