"""Faults planted in the port for the check that `correct` catches them
(`tests/test_bench_port_faults.py`, `calibrate.py --fault`).  The
benchmark's own runs plant none.

- ``unchanged_state``: the optimizer's step does nothing, so the step
  returns its parameters and Adam state unchanged.
- ``half_batch``: the loss reads the first half of the molecules, its
  mean taken over them alone."""
from __future__ import annotations

from contextlib import contextmanager

FAULTS = ("unchanged_state", "half_batch")


@contextmanager
def planted(name: str):
    """The fault `name` in the port for the duration of the block."""
    import torch
    from infomax3d_tpu_torch.train.pretrain import PretrainStep

    def half_loss(self, g2, g3, noise=None):
        z1, z2 = self.outputs(g2, g3, noise)
        half = z1.shape[0] // 2
        per = z2.shape[0] // z1.shape[0]
        return self.loss_fn(z1[:half], z2[:half * per]), (z1, z2)

    patches = {
        "unchanged_state": [(torch.optim.Adam, "step",
                             lambda self, closure=None: None)],
        "half_batch": [(PretrainStep, "loss", half_loss)]}
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
