"""The BYOL wrapper (port of `infomax3d_tpu/models/byol.py::BYOLWrapper`,
reference trainer/byol_wrapper.py:12-53).

The module holds the student (any registered model, ``student``) and the
predictor MLP (``predictor``, omitted when `predictor_layers` is 0) and
returns ``(prediction, projection)``: the predictor's output and the
student's.  The teacher is not part of the module, as in the JAX package:
the BYOL step (`train/byol.py`) keeps a copy of the student for each
wrapper, moves it by EMA and runs it without autograd.
"""
from __future__ import annotations

from typing import Any, Mapping, Optional

from torch import nn

from infomax3d_tpu_torch.models.base import MLP


class BYOLWrapper(nn.Module):
    """Keyword arguments are the JAX module's fields: the inner
    `model_type` and its `model_parameters`, and the predictor's
    `predictor_layers`, `predictor_hidden_size`, `predictor_batchnorm` and
    `metric_dim`.  The predictor reads the student's output, whose width is
    the inner model's `target_dim`."""

    FIELDS = ("model_type", "model_parameters", "predictor_layers",
              "predictor_hidden_size", "predictor_batchnorm", "metric_dim")

    def __init__(self, model_type: str, model_parameters: Mapping[str, Any],
                 predictor_layers: int = 1, predictor_hidden_size: int = 256,
                 predictor_batchnorm: bool = False, metric_dim: int = 256):
        super().__init__()
        from infomax3d_tpu_torch.models.registry import build_model
        self.student = build_model(model_type, model_parameters)
        self.predictor: Optional[MLP] = None
        if predictor_layers > 0:
            self.predictor = MLP(model_parameters["target_dim"], metric_dim,
                                 predictor_layers,
                                 hidden_size=predictor_hidden_size,
                                 mid_batch_norm=predictor_batchnorm)

    def forward(self, g, noise=None):
        projection = self.student(g, noise=noise)
        if self.predictor is None:
            return projection, projection
        return self.predictor(projection, noise=noise), projection
