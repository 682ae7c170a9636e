"""bf16 compute (port of `infomax3d_tpu/train/precision.py`).

The recipe: parameters are cast to bf16, BatchNorm running statistics stay
float32, integer inputs (atom and bond codes) stay integers.  Config key
``bf16_compute: auto|true|false``; ``auto`` is bf16 on the card and float32
on the CPU.

Serving casts the module's parameters in place (`cast_parameters`).
Training keeps float32 master parameters and runs the forward on bf16
copies made inside the differentiated function (`compute_params` with
`torch.func.functional_call`), so the gradients reach the masters through
the cast, as the JAX package's `cast_floats` around `apply` does; the batch's
float fields are cast too (`cast_batch`).  A training forward under
`remat` (`train/remat.py`) is recomputed in the backward, the casts with
it.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch
from torch import nn
from torch.func import functional_call

from infomax3d_tpu_torch.parallel import tp
from infomax3d_tpu_torch.parallel.context import model_group
from infomax3d_tpu_torch.train.remat import rematerialized


def cast_parameters(module: nn.Module, dtype: Optional[torch.dtype]
                    ) -> nn.Module:
    """The bf16 recipe on a module (the counterpart of the JAX package's
    `cast_floats` on the parameter tree): float32 parameters -> `dtype`,
    buffers (the BatchNorm running statistics) untouched.  `None` keeps
    float32."""
    if dtype is not None:
        for p in module.parameters():
            if p.dtype == torch.float32:
                p.data = p.data.to(dtype)
    return module


def resolve_compute_dtype(setting, device: torch.device
                          ) -> Optional[torch.dtype]:
    """'auto' -> bf16 on CUDA, float32 (None) on the CPU; True / 'bf16' /
    'bfloat16' -> bf16; False / None -> float32."""
    if setting == "auto":
        return torch.bfloat16 if torch.device(device).type == "cuda" else None
    if setting is True or setting in ("bf16", "bfloat16"):
        return torch.bfloat16
    return None


def compute_params(module: nn.Module, dtype: Optional[torch.dtype]
                   ) -> Dict[str, torch.Tensor]:
    """The module's parameters as the forward should see them: float32
    ones cast to `dtype` (differentiably, so gradients flow back to the
    float32 masters), the others as they are; a tensor-parallel module's
    shards then gathered whole over the model group (differentiably: the
    gradient of each shard is its slice of the whole leaf's).  For
    `torch.func.functional_call`; the buffers stay the module's own, so the
    BatchNorm running statistics stay float32 and update in place."""
    params = {n: (p.to(dtype) if dtype is not None
                  and p.dtype == torch.float32 else p)
              for n, p in module.named_parameters()}
    if not tp.is_sharded(module):
        return params
    group = model_group()
    if group is None:
        raise RuntimeError("a tensor-parallel module runs under its model "
                           "group (parallel.context.using_groups(model=...))")
    return tp.full_parameters(module, params, group)


def call_model(model: nn.Module, dtype: Optional[torch.dtype], *inputs,
               **kwargs):
    """`model(*inputs, **kwargs)` on its compute parameters
    (`compute_params`): with `dtype` (bf16) the output (a tensor or a
    tuple of them) cast to float32; a float32 module that is not
    tensor-parallel runs as it is."""
    if dtype is None and not tp.is_sharded(model):
        return model(*inputs, **kwargs)
    out = functional_call(model, compute_params(model, dtype), inputs,
                          kwargs)
    if dtype is None:
        return out
    if isinstance(out, tuple):
        return tuple(o.float() for o in out)
    return out.float()


def forward_in(model: nn.Module, dtype: Optional[torch.dtype], *inputs,
               **kwargs):
    """`model(*inputs, **kwargs)` under the training recipe (`call_model`):
    with `dtype` (bf16) on copies of the float32 master parameters cast to
    it, the output cast to float32 for the loss; `None` runs float32 (on
    the gathered parameters under tensor parallelism).  The keyword
    arguments (a model's noise source) pass through as they are.  A model
    in training mode runs under the step's `remat` setting
    (`train/remat.py::rematerialized`): its recompute gathers again, in
    the same order on every rank."""
    def run(*inputs, **kwargs):
        return call_model(model, dtype, *inputs, **kwargs)
    if model.training:
        return rematerialized(run, *inputs, **kwargs)
    return run(*inputs, **kwargs)


def cast_batch(batch, dtype: Optional[torch.dtype]):
    """A batch dataclass with its float32 tensor fields cast to `dtype`
    (integer and bool fields untouched); `None` keeps float32."""
    if dtype is None:
        return batch
    return dataclasses.replace(batch, **{
        f.name: getattr(batch, f.name).to(dtype)
        for f in dataclasses.fields(batch)
        if isinstance(getattr(batch, f.name), torch.Tensor)
        and getattr(batch, f.name).dtype == torch.float32})
