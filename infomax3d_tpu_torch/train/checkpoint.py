"""Checkpoints (the port's own format: the reference's `.pt` payload,
trainer/trainer.py:252-280, which `infomax3d_tpu/train/torch_interop.py`
documents and reads).

`best_checkpoint.pt` / `last_checkpoint.pt` hold ``model_state_dict``
(``model3d_state_dict`` for a second model, ``critic_state_dict`` for
the philosophy trainer's critic: torch names, running statistics
included, on the CPU), ``optimizer_state_dict`` (keyed by model where
each model has its own optimizer),
``scheduler_state_dict``, ``epoch``, ``best_val_score`` and
``optim_steps``.  Written with `torch.save` (atomically: a reader never
sees a partial file) and read with ``weights_only=True``, so a checkpoint
holds only tensors and plain containers.  A tensor-parallel model's
entries are whole tensors too (`parallel/tp.py`): its shards gathered on
the way out, cut to the rank's part on the way in.
"""
from __future__ import annotations

import os
from typing import Any, Dict, Mapping

import torch

from infomax3d_tpu_torch.parallel import tp

# payload key of each model key
STATE_DICT_KEYS = {"model": "model_state_dict",
                   "model3d": "model3d_state_dict",
                   "critic": "critic_state_dict"}


def state_dicts(models: Mapping[str, torch.nn.Module], group=None
                ) -> Dict[str, Dict[str, torch.Tensor]]:
    """Each model's state_dict on the CPU, under its payload key; a
    tensor-parallel model's shards gathered whole over the model `group`
    (every model rank calls it)."""
    return {STATE_DICT_KEYS[k]: {n: t.detach().cpu() for n, t in
                                 tp.full_state_dict(m, group).items()}
            for k, m in models.items()}


def load_state_dicts(models: Mapping[str, torch.nn.Module],
                     payload: Mapping[str, Any]) -> None:
    """Load each model's state_dict from `payload`, strictly (every
    parameter and running statistic must be there), each sharded leaf of
    a tensor-parallel model cut to this rank's part."""
    for k, m in models.items():
        m.load_state_dict(tp.shard_state_dict(m, payload[STATE_DICT_KEYS[k]]),
                          strict=True)


def save_checkpoint(path: str, payload: Dict[str, Any]) -> None:
    tmp = path + ".tmp"
    torch.save(payload, tmp)
    os.replace(tmp, path)


def load_checkpoint(path: str, map_location="cpu") -> Dict[str, Any]:
    return torch.load(path, map_location=map_location, weights_only=True)
