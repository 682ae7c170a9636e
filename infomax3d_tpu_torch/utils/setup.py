"""Runtime setup (port of `infomax3d_tpu/utils/setup.py`'s `seed_all`;
the JAX compile cache has no counterpart here)."""
from __future__ import annotations

import random

import numpy as np
import torch


def seed_all(seed: int) -> np.random.Generator:
    """Seed numpy's and Python's global generators and torch's CPU and
    CUDA generators (reference commons/utils.py:15-28)."""
    seed = seed or 0
    np.random.seed(seed)
    random.seed(seed)
    torch.manual_seed(seed)          # seeds every CUDA device's generator too
    return np.random.default_rng(seed)
