"""Learning-rate control (port of `infomax3d_tpu/train/schedulers.py`):
host-side schedulers that compute one float per parameter group, which the
trainer writes into each torch param group's `lr` before every step.

`WarmUpController` is the reference's `WarmUpWrapper`
(trainer/lr_schedulers.py:5-78): per-param-group ORDERED warmup —
`warmup_steps` is a list; group i only starts moving once phase i is
reached (used to warm a new head before transferred layers) — with linear
or cosine interpolation, then delegation to a wrapped scheduler (typically
torch's `ReduceLROnPlateau`, re-implemented here with identical
semantics).  Plain Python: the lr sequences equal the JAX package's.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Sequence


class ReduceLROnPlateau:
    """torch.optim.lr_scheduler.ReduceLROnPlateau semantics (mode/factor/
    patience/threshold/threshold_mode/cooldown/min_lr/eps) operating on a list
    of group LRs."""

    def __init__(self, lrs: Sequence[float], mode="min", factor=0.1, patience=10,
                 threshold=1e-4, threshold_mode="rel", cooldown=0, min_lr=0.0,
                 eps=1e-8, verbose=False):
        if factor >= 1.0:
            raise ValueError("Factor should be < 1.0.")
        self.lrs = list(lrs)
        self.mode = mode
        self.factor = factor
        self.patience = patience
        self.threshold = threshold
        self.threshold_mode = threshold_mode
        self.cooldown = cooldown
        self.cooldown_counter = 0
        self.min_lrs = [min_lr] * len(self.lrs) if not isinstance(min_lr, (list, tuple)) \
            else list(min_lr)
        self.eps = eps
        self.best = math.inf if mode == "min" else -math.inf
        self.num_bad_epochs = 0
        self.last_epoch = 0

    def _is_better(self, a, best):
        if self.mode == "min" and self.threshold_mode == "rel":
            return a < best * (1.0 - self.threshold)
        if self.mode == "min" and self.threshold_mode == "abs":
            return a < best - self.threshold
        if self.mode == "max" and self.threshold_mode == "rel":
            return a > best * (self.threshold + 1.0)
        return a > best + self.threshold

    def step(self, metrics=None):
        self.last_epoch += 1
        if metrics is None:
            return
        current = float(metrics)
        if self._is_better(current, self.best):
            self.best = current
            self.num_bad_epochs = 0
        else:
            self.num_bad_epochs += 1
        if self.cooldown_counter > 0:
            self.cooldown_counter -= 1
            self.num_bad_epochs = 0
        if self.num_bad_epochs > self.patience:
            for i, lr in enumerate(self.lrs):
                new_lr = max(lr * self.factor, self.min_lrs[i])
                if lr - new_lr > self.eps:
                    self.lrs[i] = new_lr
            self.cooldown_counter = self.cooldown
            self.num_bad_epochs = 0

    def state_dict(self):
        return {k: v for k, v in self.__dict__.items()}

    def load_state_dict(self, sd):
        self.__dict__.update(sd)


class CosineAnnealingLR:
    """torch CosineAnnealingLR on group LRs (closed form)."""

    def __init__(self, lrs: Sequence[float], T_max: int, eta_min: float = 0.0):
        self.base_lrs = list(lrs)
        self.lrs = list(lrs)
        self.T_max = T_max
        self.eta_min = eta_min
        self.last_epoch = 0

    def step(self, metrics=None):
        self.last_epoch += 1
        self.lrs = [self.eta_min + (b - self.eta_min) *
                    (1 + math.cos(math.pi * self.last_epoch / self.T_max)) / 2
                    for b in self.base_lrs]

    def state_dict(self):
        return dict(self.__dict__)

    def load_state_dict(self, sd):
        self.__dict__.update(sd)


class StepLR:
    def __init__(self, lrs: Sequence[float], step_size: int, gamma: float = 0.1):
        self.base_lrs = list(lrs)
        self.lrs = list(lrs)
        self.step_size = step_size
        self.gamma = gamma
        self.last_epoch = 0

    def step(self, metrics=None):
        self.last_epoch += 1
        self.lrs = [b * self.gamma ** (self.last_epoch // self.step_size)
                    for b in self.base_lrs]

    def state_dict(self):
        return dict(self.__dict__)

    def load_state_dict(self, sd):
        self.__dict__.update(sd)


class ExponentialLR:
    def __init__(self, lrs: Sequence[float], gamma: float):
        self.lrs = list(lrs)
        self.gamma = gamma
        self.last_epoch = 0

    def step(self, metrics=None):
        self.last_epoch += 1
        self.lrs = [lr * self.gamma for lr in self.lrs]

    def state_dict(self):
        return dict(self.__dict__)

    def load_state_dict(self, sd):
        self.__dict__.update(sd)


class OneCycleLR:
    """torch.optim.lr_scheduler.OneCycleLR semantics (wrapped inside
    WarmUpWrapper by configs/transformer.yml): warm from max_lr/div_factor
    to max_lr over pct_start of total_steps, then anneal to
    initial_lr/final_div_factor over the remainder, 'cos' or 'linear'.
    Momentum cycling is not replicated (the LR controller feeds Adam LRs
    only — matching how the reference's per-batch stepping consumes it)."""

    def __init__(self, lrs: Sequence[float], max_lr, epochs=None,
                 steps_per_epoch=None, total_steps=None, pct_start=0.3,
                 anneal_strategy="cos", div_factor=25.0,
                 final_div_factor=1e4, verbose=False, **_ignored):
        n = len(lrs)
        if total_steps is None:
            total_steps = int(epochs) * int(steps_per_epoch)
        self.total_steps = int(total_steps)
        self.max_lrs = list(max_lr) if isinstance(max_lr, (list, tuple)) \
            else [float(max_lr)] * n
        self.initial_lrs = [m / div_factor for m in self.max_lrs]
        self.min_lrs = [i / final_div_factor for i in self.initial_lrs]
        self.pct_start = float(pct_start)
        self.anneal_strategy = anneal_strategy
        self.last_epoch = 0
        self.lrs = list(self.initial_lrs)

    def _anneal(self, start, end, pct):
        if self.anneal_strategy == "linear":
            return start + (end - start) * pct
        return end + (start - end) / 2.0 * (1.0 + math.cos(math.pi * pct))

    def step(self, metrics=None):
        self.last_epoch += 1
        # torch's phase boundaries: up ends at pct_start*total - 1, the
        # cycle at total - 1 (lr_scheduler.py OneCycleLR._schedule_phases)
        t = min(self.last_epoch, self.total_steps - 1)
        up_end = float(self.pct_start * self.total_steps) - 1.0
        if t <= up_end:
            pct = t / max(up_end, 1e-12)
            self.lrs = [self._anneal(i, m, pct)
                        for i, m in zip(self.initial_lrs, self.max_lrs)]
        else:
            pct = (t - up_end) / max(self.total_steps - 1.0 - up_end, 1e-12)
            self.lrs = [self._anneal(m, mn, pct)
                        for m, mn in zip(self.max_lrs, self.min_lrs)]

    def state_dict(self):
        return dict(self.__dict__)

    def load_state_dict(self, sd):
        self.__dict__.update(sd)


WRAPPED_SCHEDULERS = {
    "ReduceLROnPlateau": ReduceLROnPlateau,
    "CosineAnnealingLR": CosineAnnealingLR,
    "StepLR": StepLR,
    "ExponentialLR": ExponentialLR,
    "OneCycleLR": OneCycleLR,
}


class WarmUpController:
    """Reference `WarmUpWrapper` (trainer/lr_schedulers.py:5-78), exactly:

    - `warmup_steps`: list (a single number is one phase); its cumsum
      defines warmup phases.  During warmup, group i only updates when
      `i <= current_phase` (or a single entry updates all groups),
      interpolating 0 -> start_lr linearly or cosine.
    - Groups NOT yet unlocked stay at 0 (reference sets every lr to 0 at
      construction).
    - After `sum(warmup_steps)` total steps, delegates to the wrapped
      scheduler.
    """

    def __init__(self, start_lrs: Sequence[float], warmup_steps: Sequence[float],
                 wrapped_scheduler: str = "ReduceLROnPlateau",
                 interpolation: str = "linear", **wrapped_params):
        self.start_lrs = list(start_lrs)
        if isinstance(warmup_steps, (int, float)):
            # configs/0.yml gives one number where the others give a list;
            # the reference's sum() and the JAX package's loop both fail
            # on it, its evident intent is one warmup phase
            warmup_steps = [warmup_steps]
        self.warmup_steps = [int(w) for w in warmup_steps]
        self.total_warmup_steps = sum(self.warmup_steps)
        self.interpolation = interpolation
        self._step = 0
        self.lrs = [0.0] * len(self.start_lrs)
        wrapped_params.pop("verbose", None)
        self.wrapped = WRAPPED_SCHEDULERS[wrapped_scheduler](
            list(self.start_lrs), **wrapped_params)

    def _cumsum(self):
        out, acc = [], 0
        for w in self.warmup_steps:
            acc += w
            out.append(acc)
        return out

    def step(self, metrics=None):
        if self._step < self.total_warmup_steps:
            cums = self._cumsum()
            phase = sum(1 for s in cums if self._step >= s)
            interp_val = self._step - ([0] + cums)[phase] + 1
            for i in range(len(self.lrs)):
                if i <= phase or len(self.warmup_steps) == 1:
                    w = self.warmup_steps[phase]
                    if w == 0:
                        self.lrs[i] = self.start_lrs[i]
                    elif self.interpolation == "linear":
                        self.lrs[i] = self.start_lrs[i] * (interp_val / w)
                    elif self.interpolation == "cosine":
                        self.lrs[i] = self.start_lrs[i] * (
                            (-math.cos(math.pi * interp_val / w) + 1) * 0.5)
                    else:
                        raise ValueError(
                            f"interpolation not implemented: {self.interpolation}")
        else:
            self.wrapped.step(metrics=metrics)
            self.lrs = list(self.wrapped.lrs)
        self._step += 1

    @property
    def in_warmup(self):
        return self._step < self.total_warmup_steps

    def state_dict(self):
        sd = {k: v for k, v in self.__dict__.items() if k != "wrapped"}
        sd["wrapped"] = self.wrapped.state_dict()
        return sd

    def load_state_dict(self, sd):
        wrapped_sd = sd.pop("wrapped")
        self.wrapped.load_state_dict(wrapped_sd)
        self.__dict__.update(sd)


class LRController:
    """Builds the scheduler named in the config (`lr_scheduler` +
    `lr_scheduler_params`, reference train.py/trainer.py:246-250) and exposes
    the current per-group LRs.

    `step_per_batch` mirrors reference trainer.py:170-172: step every batch
    if configured, OR during the warmup period of a WarmUpWrapper; otherwise
    step per epoch with the validation metric.
    """

    def __init__(self, start_lrs: Sequence[float], scheduler: Optional[str],
                 scheduler_params: Optional[Dict] = None,
                 step_per_batch: bool = True):
        self.step_per_batch = step_per_batch
        params = dict(scheduler_params or {})
        if scheduler is None:
            self.sched = None
            self.lrs = list(start_lrs)
        elif scheduler == "WarmUpWrapper":
            self.sched = WarmUpController(start_lrs, **params)
            self.lrs = self.sched.lrs
        elif scheduler in WRAPPED_SCHEDULERS:
            self.sched = WRAPPED_SCHEDULERS[scheduler](list(start_lrs), **params)
            self.lrs = self.sched.lrs
        else:
            raise KeyError(f"unknown lr_scheduler '{scheduler}'")

    def after_optim_step(self):
        """Call after every optimizer step (reference after_optim_step)."""
        if self.sched is None:
            return
        if self.step_per_batch or (isinstance(self.sched, WarmUpController)
                                   and self.sched.in_warmup):
            self.sched.step()
            self.lrs = self.sched.lrs

    def after_epoch(self, val_metric: float):
        """Call once per epoch with the main validation metric."""
        if self.sched is None or self.step_per_batch:
            return
        self.sched.step(metrics=val_metric)
        self.lrs = self.sched.lrs

    def state_dict(self):
        return None if self.sched is None else self.sched.state_dict()

    def load_state_dict(self, sd):
        if self.sched is not None and sd is not None:
            self.sched.load_state_dict(sd)
            self.lrs = self.sched.lrs
