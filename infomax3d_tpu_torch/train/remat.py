"""`remat: true`: the training forward recomputed in the backward (port of
the JAX trainer's `jax.checkpoint` around its training `apply`,
`infomax3d_tpu/train/trainer.py:278-285`).

A step that runs with `using_remat(True)` runs each model's training
forward (`train/precision.py::forward_in`, the OT step's model call)
under `torch.utils.checkpoint.checkpoint(..., use_reentrant=False)`: the
activations are not kept, and the backward runs the forward again to get
them.  The loss, the gradients and the running statistics are those of the
step without it, bit for bit; only what the forward saves changes.  Three
things would differ in a bare recompute, and each is handled here:

* **Noise.**  Dropout masks and noise columns come from an explicit
  source (`models/noise.py`), not from torch's global generator, so
  checkpoint's `preserve_rng_state` does not cover them: the first pass
  records the source's draws (`_Recording`) and the recompute gets them
  again through `ReplayNoise`, which raises on a draw of another kind or
  shape.
* **Running statistics.**  `MaskedBatchNorm` moves its running mean and
  variance and `num_batches_tracked` in place; it reads `recomputing()`
  and leaves them alone in the recompute.
* **Collectives and context.**  The recompute runs in the backward,
  possibly on another thread, so it runs inside a copy of the context the
  forward ran in (`contextvars`): the data-parallel, partition and model
  groups are the forward's, and every rank recomputes, so the BatchNorm
  all-reduces, the aggregations' completions, the halo exchanges and the
  tensor-parallel shard gathers of the recompute stay matched across
  ranks.  Early stopping of the recompute is off, so each rank runs the
  whole forward again.

Kernel launch counters count the recompute's launches too.
"""
from __future__ import annotations

import contextlib
import contextvars
from contextvars import ContextVar
from typing import Callable

import torch
from torch.utils.checkpoint import checkpoint, set_checkpoint_early_stop

_ACTIVE: ContextVar[bool] = ContextVar("remat", default=False)
_RECOMPUTING: ContextVar[bool] = ContextVar("remat_recomputing",
                                            default=False)


def recomputing() -> bool:
    """Whether the running forward is a remat recompute."""
    return _RECOMPUTING.get()


@contextlib.contextmanager
def using_remat(on: bool):
    """Recompute the training forwards of the block's steps (`on`)."""
    token = _ACTIVE.set(bool(on))
    try:
        yield
    finally:
        _ACTIVE.reset(token)


class _Recording:
    """The first pass's noise source: `source`'s draws, kept as
    ``(kind, tensor)`` for `replay`."""

    def __init__(self, source):
        self.source = source
        self.gives_noise = getattr(source, "gives_noise", True)
        self.draws = []

    def replay(self):
        """The recompute's source: the recorded draws handed out again in
        order by `ReplayNoise` (a draw of another kind or shape raises),
        with no noise where `source` gives none."""
        # here, not at the top: `models.base` imports this module
        from infomax3d_tpu_torch.models.noise import MasksOnly, ReplayNoise
        replay = ReplayNoise(self.draws)
        return replay if self.gives_noise else MasksOnly(replay)

    def _draw(self, kind: str, *args):
        t = getattr(self.source, kind)(*args)
        self.draws.append((kind, t))
        return t

    def normal(self, shape):
        return self._draw("normal", shape)

    def uniform(self, shape):
        return self._draw("uniform", shape)

    def bernoulli(self, p: float, shape):
        return self._draw("bernoulli", p, shape)


def rematerialized(fn: Callable, *args, **kwargs):
    """``fn(*args, **kwargs)``, under remat when the running step asked for
    it (`using_remat`) and autograd records: checkpointed, its noise
    source (keyword `noise`) recorded and replayed, the recompute marked
    (`recomputing`) and run in the forward's context."""
    if not _ACTIVE.get() or not torch.is_grad_enabled():
        return fn(*args, **kwargs)
    rec = None
    if kwargs.get("noise") is not None:
        rec = _Recording(kwargs["noise"])
    ctx = contextvars.copy_context()
    first = [True]

    def recompute(kw, *a):
        token = _RECOMPUTING.set(True)
        try:
            return fn(*a, **kw)
        finally:
            _RECOMPUTING.reset(token)

    def body(*a):
        if first[0]:
            first[0] = False
            return fn(*a, **(kwargs if rec is None else
                             dict(kwargs, noise=rec)))
        return ctx.run(recompute, kwargs if rec is None else
                       dict(kwargs, noise=rec.replay()), *a)

    with set_checkpoint_early_stop(False):
        return checkpoint(body, *args, use_reentrant=False)
