"""Faults planted in the port for the check that `correct` catches them
(`tests/test_bench_port_faults.py`, `calibrate.py --fault`).  The
benchmark's own runs plant none.

- ``unchanged_state``: the optimizer's step does nothing, so the step
  returns its parameters and Adam state unchanged.
- ``half_batch``: the loss reads the first half of the molecules, its
  mean taken over them alone (the pre-training step's and the supervised
  step's)."""
from __future__ import annotations

from contextlib import contextmanager

FAULTS = ("unchanged_state", "half_batch")


@contextmanager
def planted(name: str):
    """The fault `name` in the port for the duration of the block."""
    import torch
    from infomax3d_tpu_torch.train.precision import forward_in
    from infomax3d_tpu_torch.train.pretrain import PretrainStep
    from infomax3d_tpu_torch.train.supervised import (SupervisedStep,
                                                      supervised_loss)

    def half_loss(self, g2, g3, noise=None):
        z1, z2 = self.outputs(g2, g3, noise)
        half = z1.shape[0] // 2
        per = z2.shape[0] // z1.shape[0]
        return self.loss_fn(z1[:half], z2[:half * per]), (z1, z2)

    def half_supervised_loss(self, g, noise=None):
        # the real graphs come first: the second half of them is left out
        pred = forward_in(self.model, self.compute_dtype, g, noise=noise)
        valid = ~torch.isnan(g.targets) & g.graph_mask[:, None]
        valid[int(g.graph_mask.sum()) // 2:] = False
        return supervised_loss(self.loss_func, pred, g.targets, valid), pred

    patches = {
        "unchanged_state": [(torch.optim.Adam, "step",
                             lambda self, closure=None: None)],
        "half_batch": [(PretrainStep, "loss", half_loss),
                       (SupervisedStep, "loss", half_supervised_loss)]}
    if name not in patches:
        raise KeyError(f"unknown fault {name!r}; known: {FAULTS}")
    saved = [(owner, attr, owner.__dict__[attr])
             for owner, attr, _ in patches[name]]
    for owner, attr, new in patches[name]:
        setattr(owner, attr, new)
    try:
        yield
    finally:
        for owner, attr, old in saved:
            setattr(owner, attr, old)
