"""Reading checkpoints of every origin (port of the checkpoint-reading half
of `infomax3d_tpu/train/torch_interop.py`).

* torch `.pt` files (a zip archive or a legacy pickle): the port's own
  checkpoints and the reference repository's, one payload
  (``model_state_dict``, ``model3d_state_dict``, ...; trainer/trainer.py:
  252-280) whose tensors carry the reference's names, which the port's
  modules use.  Read by `train/checkpoint.py::load_checkpoint` (on the
  CPU, ``weights_only=True``).
* the JAX package's checkpoints: flax msgpack of its
  ``TrainState(params, batch_stats, opt_state, step, extra)`` (with
  ``params`` / ``batch_stats`` keyed by model name), written under the
  same file names; read by the port's own `flax_msgpack` reader and
  turned into torch names by `interop.params_from_jax` (serving) or onto
  a model's flax paths (`flax_transfer_source`, the fine-tune transfer);
  a BYOL run's teachers from its ``extra`` (`jax_teacher_variables`).

Nothing here reshapes a tensor to fit: a missing tensor or a shape that
differs raises in `load_state_dict(strict=True)` (serving), and the
transfer copies only tensors of equal shape, as the JAX CLI does.
"""
from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch

from infomax3d_tpu_torch.interop import _flatten
from infomax3d_tpu_torch.train.flax_msgpack import read_msgpack


def is_torch_checkpoint(path: str) -> bool:
    """True for a torch `.pt` (zip archive or legacy pickle), False for
    the JAX package's flax msgpack checkpoints."""
    with open(path, "rb") as f:
        head = f.read(4)
    return head == b"PK\x03\x04" or head[:2] == b"\x80\x02"


def rename_torch_keys(sd: Mapping[str, Any]) -> Dict[str, Any]:
    """The reference's transfer renames (train.py:216-226) on torch names:
    BYOL 'student.' prefixes stripped, the root 'gnn.' / 'gnn2.' ->
    'node_gnn.' (anchored at the root: a nested 'gnn' keeps its name)."""
    out = {}
    for k, v in sd.items():
        if k.startswith("student."):
            k = k[len("student."):]
        if k.startswith("gnn.") or k.startswith("gnn2."):
            k = "node_gnn." + k.split(".", 1)[1]
        out[k] = v
    return out


def load_jax_checkpoint(path: str) -> Dict[str, Any]:
    """The JAX package's checkpoint at `path` as the tree flax's
    `msgpack_restore` returns: ``params``, ``batch_stats``, ``opt_state``,
    ``step``, ``extra``."""
    tree = read_msgpack(path)
    if not isinstance(tree, dict) or "params" not in tree:
        raise ValueError(f"{path} is not a JAX TrainState checkpoint")
    return tree


def jax_model_variables(tree: Mapping[str, Any], key: str = "model"
                        ) -> Dict[str, Any]:
    """One model's ``{"params", "batch_stats"}`` numpy trees from a JAX
    checkpoint tree, for `interop.params_from_jax`."""
    if key not in tree["params"]:
        raise KeyError(f"the checkpoint holds no parameters of {key!r}; it "
                       f"has {sorted(tree['params'])}")
    return {"params": tree["params"][key],
            "batch_stats": (tree.get("batch_stats") or {}).get(key, {})}


def jax_teacher_variables(tree: Mapping[str, Any], key: str = "model"
                          ) -> Dict[str, Any]:
    """The BYOL teacher of model `key` from a JAX `BYOLTrainer`
    checkpoint's ``extra`` (``teacher`` and ``teacher_stats``, each the
    wrapper's tree without its predictor) as ``{"params",
    "batch_stats"}`` numpy trees of the student alone, for
    `interop.load_variables` into a `BYOLStep`'s teacher."""
    extra = tree.get("extra") or {}
    if "teacher" not in extra or key not in extra["teacher"]:
        raise KeyError(f"the checkpoint holds no BYOL teacher of {key!r}")
    return {"params": extra["teacher"][key]["student"],
            "batch_stats": ((extra.get("teacher_stats") or {}).get(key)
                            or {}).get("student", {})}


def flax_transfer_source(tree: Mapping[str, Any], key: str,
                         paths: Mapping[str, str]) -> Dict[str, torch.Tensor]:
    """The JAX CLI's transfer source (`infomax3d_tpu/cli/train.py:393-440`)
    as tensors under a destination model's torch names: model `key`'s
    ``params`` and ``batch_stats``, a BYOL ``student`` subtree unwrapped, a
    root ``gnn`` / ``gnn2`` renamed ``node_gnn``; each destination tensor
    (`paths`: torch name -> '/'-joined flax path,
    `interop.flax_paths(model, running_stats=True)`) that the source holds,
    a ``kernel`` transposed to torch's [out, in].  Shapes are left to the
    caller's check."""
    flat: Dict[tuple, Any] = {}
    for coll in ("params", "batch_stats"):
        sub = (tree.get(coll) or {}).get(key, {})
        if "student" in sub:
            sub = sub["student"]
        for path, value in _flatten(sub):
            if path[0] in ("gnn", "gnn2"):
                path = ("node_gnn",) + path[1:]
            flat[(coll, "/".join(path))] = value
    out = {}
    for name, fpath in paths.items():
        stat = name.endswith(("running_mean", "running_var"))
        coll = "batch_stats" if stat else "params"
        if (coll, fpath) in flat:
            v = np.asarray(flat[(coll, fpath)], np.float32)
            if fpath.rsplit("/", 1)[-1] == "kernel":
                v = v.T
            out[name] = torch.from_numpy(np.ascontiguousarray(v))
    return out
