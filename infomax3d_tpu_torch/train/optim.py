"""Grouped Adam (port of the Adam semantics of `infomax3d_tpu/train/
optim.py`: `label_params` and `GroupedOptimizer`).

Parameters are labeled by their torch name in the JAX package's group
order: ``batch_norm`` (weight decay forced to 0) and ``new``; each label
present becomes one param group of `torch.optim.Adam`, whose semantics are
the JAX package's: weight decay coupled into the gradient before the
moments, torch's bias correction, betas (0.9, 0.999), eps 1e-8.  Each group
carries its label as `name`, so a caller sets the group's `lr` before a
step, as the JAX package passes `group_lrs` to `update`.  The transferred
and frozen groups and the schedulers come with the trainer.
"""
from __future__ import annotations

from typing import Dict, Iterable, Tuple

import torch

GROUP_ORDER = ("batch_norm", "new")


def label_params(names: Iterable[str]) -> Dict[str, str]:
    """Torch parameter name -> group label (the JAX package's substring
    rule: a name containing ``batch_norm`` is ``batch_norm``)."""
    return {n: "batch_norm" if "batch_norm" in n else "new" for n in names}


def build_adam(named_params: Iterable[Tuple[str, torch.nn.Parameter]],
               lr: float = 1e-3, weight_decay: float = 0.0,
               betas: Tuple[float, float] = (0.9, 0.999), eps: float = 1e-8
               ) -> torch.optim.Adam:
    """Adam with one param group per label present, in `GROUP_ORDER`; each
    group records its `name`.  `foreach` updates all tensors of a group in
    a few kernels."""
    named = list(named_params)
    labels = label_params(n for n, _ in named)
    groups = []
    for label in GROUP_ORDER:
        params = [p for n, p in named if labels[n] == label]
        if params:
            groups.append({"params": params, "name": label, "lr": lr,
                           "weight_decay": (0.0 if label == "batch_norm"
                                            else weight_decay)})
    return torch.optim.Adam(groups, lr=lr, betas=betas, eps=eps,
                            foreach=True)

