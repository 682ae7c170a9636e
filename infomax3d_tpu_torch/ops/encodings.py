"""Distance encodings (port of `infomax3d_tpu/ops/encodings.py`)."""
from __future__ import annotations

import torch


def fourier_encode_dist(x: torch.Tensor, num_encodings: int = 4,
                        include_self: bool = True) -> torch.Tensor:
    """Sin / cos of the distances at dyadic scales ``x / 2**k`` for k in
    [0, num_encodings), then the raw distance: [...] (or [..., 1]) ->
    [..., 2 * num_encodings (+ 1)], in x's dtype."""
    if x.shape[-1] != 1:
        x = x[..., None]
    scales = (2.0 ** torch.arange(num_encodings, dtype=torch.float32,
                                  device=x.device)).to(x.dtype)
    scaled = x / scales
    out = torch.cat([torch.sin(scaled), torch.cos(scaled)], dim=-1)
    if include_self:
        out = torch.cat([out, x], dim=-1)
    return out
