"""The GeoMol MLP (port of `GeomolMLP`, infomax3d_tpu/models/
geomol_mpnn.py, the reference's `models/geomol_mpnn.py:12-45`)."""
from __future__ import annotations

import torch.nn.functional as F
from torch import nn

from infomax3d_tpu_torch.models.base import PromotingLinear


class GeomolMLP(nn.Module):
    """`num_layers` blocks ``Linear -> relu`` of hidden width ``in_dim``
    when ``out_dim < 10``, else ``out_dim``, then a final Linear.  The
    Linears are named as flax names the JAX module's auto-numbered
    `Dense`s: ``Dense_0`` ... ``Dense_{num_layers}``; they promote their
    input as flax `Dense` does (float32 noise columns meet bf16 weights in
    PNAOriginalSimpleRandom's ``node_init``).  The layer / batch
    norm options are not used by the ported models and are not ported."""

    def __init__(self, in_dim: int, out_dim: int, num_layers: int):
        super().__init__()
        h_dim = in_dim if out_dim < 10 else out_dim
        dims = [in_dim] + [h_dim] * num_layers + [out_dim]
        self.num_layers = num_layers
        for k in range(num_layers + 1):
            self.add_module(f"Dense_{k}",
                            PromotingLinear(dims[k], dims[k + 1]))

    def forward(self, x):
        for k in range(self.num_layers):
            x = F.relu(getattr(self, f"Dense_{k}")(x))
        return getattr(self, f"Dense_{self.num_layers}")(x)
