"""bf16 compute (port of `infomax3d_tpu/train/precision.py`).

The recipe: parameters are cast to bf16, BatchNorm running statistics stay
float32, integer inputs (atom and bond codes) stay integers.  Config key
``bf16_compute: auto|true|false``; ``auto`` is bf16 on the card and float32
on the CPU.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn


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
