"""Grouped optimizers (port of `infomax3d_tpu/train/optim.py`:
`label_params` and `GroupedOptimizer`).

Parameters fall into the JAX package's ordered groups

    0. batch_norm   (weight decay forced to 0)
    1. new
    2. transferred  (optional, its own ``transferred_lr``)
    3. frozen       (optional, lr 0)

by the substring rules of `label_params`, read on each parameter's flax
path (`interop.flax_paths`, under its model's key: ``model/node_gnn/...``)
so the port's groups equal the JAX package's: a GINConv's
``MaskedBatchNorm_0`` is ``batch_norm``, the GIN node stack's
``batch_norm_{i}`` are ``new``.  Each label present becomes one torch param
group, in `GROUP_ORDER`, carrying its label as `name`; the trainer writes
each group's `lr` before a step, as the JAX package passes `group_lrs` to
`update`.  The group order is the unlock order of the `WarmUpController`.

The update rules are the JAX package's: Adam with weight decay coupled
into the gradient before the moments (`torch.optim.Adam`), AdamW with it
decoupled (`torch.optim.AdamW`), SGD with momentum (`torch.optim.SGD`),
torch's bias correction.  A frozen group runs at lr 0: its moments still
update, its parameters do not move.  `OptimizerSet` holds one optimizer
per model key where a trainer steps the models on different losses.
"""
from __future__ import annotations

from typing import (Any, Dict, Iterable, List, Mapping, Optional, Sequence,
                    Tuple)

import torch

GROUP_ORDER = ("batch_norm", "new", "transferred", "frozen")


def label_params(paths: Mapping[str, str],
                 transfer_layers: Sequence[str] = (),
                 exclude_from_transfer: Sequence[str] = (),
                 frozen_layers: Sequence[str] = (),
                 batch_norm_token: str = "BatchNorm"
                 ) -> Tuple[Dict[str, str], List[str]]:
    """(torch name -> group label, the labels present in `GROUP_ORDER`)
    from `paths` (torch name -> '/'-joined flax path).  Config tokens are
    substrings of torch's dot-joined names ('gnn.', 'batch_norm'); the flax
    paths join with '/' and spell BatchNorm 'MaskedBatchNorm', so both
    spellings are matched, as in the JAX package."""
    transfer = [t.replace(".", "/") for t in transfer_layers]
    exclude = [t.replace(".", "/") for t in exclude_from_transfer]
    frozen = [t.replace(".", "/") for t in frozen_layers]

    def classify(path: str) -> str:
        s = path + "|" + path.replace("MaskedBatchNorm", "batch_norm")
        if any(f in s for f in frozen):
            return "frozen"
        if any(t in s for t in transfer) and not any(x in s for x in exclude):
            return "transferred"
        if batch_norm_token in s:
            return "batch_norm"
        return "new"

    labels = {n: classify(p) for n, p in paths.items()}
    present = set(labels.values())
    return labels, [g for g in GROUP_ORDER if g in present]


def build_optimizer(named_params: Iterable[Tuple[str, torch.nn.Parameter]],
                    labels: Mapping[str, str], name: str = "Adam",
                    lr: float = 1e-3, weight_decay: float = 0.0,
                    betas: Tuple[float, float] = (0.9, 0.999),
                    eps: float = 1e-8, momentum: float = 0.0,
                    transferred_lr: Optional[float] = None, **_ignored
                    ) -> torch.optim.Optimizer:
    """The optimizer `name` (Adam, AdamW, SGD) with one param group per
    label present, in `GROUP_ORDER`; each group records its `name` and
    starts at its start lr (`group_start_lr`).  `foreach` updates all
    tensors of a group in a few kernels."""
    kind = name.lower()
    if kind not in ("adam", "adamw", "sgd"):
        raise KeyError(f"unknown optimizer '{name}'")
    named = list(named_params)
    groups = []
    for label in GROUP_ORDER:
        params = [p for n, p in named if labels[n] == label]
        if params:
            groups.append({"params": params, "name": label,
                           "lr": group_start_lr(label, lr, transferred_lr),
                           "weight_decay": (0.0 if label == "batch_norm"
                                            else weight_decay)})
    if kind == "sgd":
        return torch.optim.SGD(groups, lr=lr, momentum=momentum,
                               foreach=True)
    cls = torch.optim.AdamW if kind == "adamw" else torch.optim.Adam
    return cls(groups, lr=lr, betas=tuple(betas), eps=eps, foreach=True)


def group_start_lr(label: str, lr: float,
                   transferred_lr: Optional[float] = None) -> float:
    """A group's start lr: `lr`, `transferred_lr` for the transferred group
    (when given), 0 for the frozen one."""
    if label == "frozen":
        return 0.0
    if label == "transferred" and transferred_lr is not None:
        return transferred_lr
    return lr


def build_adam(named_params: Iterable[Tuple[str, torch.nn.Parameter]],
               lr: float = 1e-3, weight_decay: float = 0.0,
               betas: Tuple[float, float] = (0.9, 0.999), eps: float = 1e-8,
               labels: Optional[Mapping[str, str]] = None
               ) -> torch.optim.Adam:
    """Adam over `named_params` grouped by `labels` (torch name -> label);
    without `labels`, a name containing ``batch_norm`` is ``batch_norm``
    and every other ``new``."""
    named = list(named_params)
    if labels is None:
        labels = {n: "batch_norm" if "batch_norm" in n else "new"
                  for n, _ in named}
    return build_optimizer(named, labels, "Adam", lr=lr,
                           weight_decay=weight_decay, betas=betas, eps=eps)


class OptimizerSet:
    """Optimizers by model key, used as one (the philosophy trainer's three,
    the JAX package's one `GroupedOptimizer` per key): `param_groups` lists
    every group in key order, `zero_grad` and `step` act on all, and the
    state dict maps each key to its optimizer's."""

    def __init__(self, optimizers: Mapping[str, torch.optim.Optimizer]):
        self.optimizers = dict(optimizers)

    @property
    def param_groups(self) -> list:
        return [g for opt in self.optimizers.values()
                for g in opt.param_groups]

    def zero_grad(self, set_to_none: bool = True) -> None:
        for opt in self.optimizers.values():
            opt.zero_grad(set_to_none=set_to_none)

    def step(self) -> None:
        for opt in self.optimizers.values():
            opt.step()

    def state_dict(self) -> Dict[str, Any]:
        return {k: opt.state_dict() for k, opt in self.optimizers.items()}

    def load_state_dict(self, state: Mapping[str, Any]) -> None:
        for k, opt in self.optimizers.items():
            opt.load_state_dict(state[k])
