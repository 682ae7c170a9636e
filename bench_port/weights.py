"""The weights of a run, made from its seed: every tensor the reference's
`parameter_spec` names (each model file's spec, in the order of the
configuration's model keys), drawn on the device with one `torch.Generator` in
two calls (one uniform, one normal draw) in float32, then scaled per
tensor.  The program loads them into its modules (`load_state_dict`,
strict); the reference makes them again from the same seed."""
from __future__ import annotations

import math
from typing import Dict, Mapping

import numpy as np
import torch

from bench_port import manifest
from bench_port.reference.run import parameter_spec


def weight_seed(seed: int) -> int:
    """The generator seed of a run's weights, apart from its data's."""
    return int(np.random.SeedSequence((int(seed), 2)).generate_state(
        1, np.uint64)[0] & (2 ** 63 - 1))


def make_weights(config: Mapping, seed: int, device) -> Dict[str, torch.Tensor]:
    """``<key>.<name>`` -> tensor on `device`, each as its model file's
    spec says: linear layers uniform in +-1/sqrt(fan_in), embeddings
    uniform in +-sqrt(6 / (vocab + width)), Net3D's node embedding standard
    normal, BatchNorm weight 1, bias 0, running mean 0, running variance
    1."""
    spec = parameter_spec(manifest.reference_parts(config))
    sizes = {k: sum(math.prod(s) for _, s, kind, _ in spec if kind == k)
             for k in ("uniform", "normal")}
    gen = torch.Generator(device=device).manual_seed(weight_seed(seed))
    draws = {"uniform": torch.rand(sizes["uniform"], generator=gen,
                                   device=device) * 2 - 1,
             "normal": torch.randn(sizes["normal"], generator=gen,
                                   device=device)}
    at = {"uniform": 0, "normal": 0}
    out = {}
    for name, shape, kind, scale in spec:
        if kind in draws:
            n = math.prod(shape)
            out[name] = draws[kind][at[kind]:at[kind] + n].view(shape) * scale
            at[kind] += n
        elif kind == "count":
            out[name] = torch.zeros(shape, dtype=torch.long, device=device)
        else:
            fill = 1.0 if kind == "ones" else 0.0
            out[name] = torch.full(shape, fill, device=device)
    return out


def model_state(weights: Mapping[str, torch.Tensor], key: str
                ) -> Dict[str, torch.Tensor]:
    """The state dict of model `key` (``model``, ``model3d``)."""
    return {n[len(key) + 1:]: t for n, t in weights.items()
            if n.startswith(key + ".")}
