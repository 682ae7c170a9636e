"""The BYOL wrapper and the philosophy trainer's critic (port of
`infomax3d_tpu/models/byol.py::BYOLWrapper` and `Critic`, reference
trainer/byol_wrapper.py:12-53).

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


class Critic(nn.Module):
    """The adversarial reconstruction player of the philosophy trainer
    (the JAX `Critic`, registered as ``Critic`` and ``BasicCritic``): the
    ``mlp`` (`layers` FCLayers of width `hidden_dim`, `dropout`) maps the
    3D embedding [B, in_dim] to `repeats` reconstructions, returned as
    [B, metric_dim, repeats] for `CriticLoss`.  flax infers the input
    width at init; here it is `in_dim`, which the trainer sets from the
    config's ``critic_in_dim`` (default 256, the JAX trainer's)."""

    FIELDS = ("metric_dim", "hidden_dim", "layers", "repeats", "dropout")

    def __init__(self, metric_dim: int = 256, hidden_dim: int = 256,
                 layers: int = 2, repeats: int = 4, dropout: float = 0.0,
                 in_dim: int = 256):
        super().__init__()
        self.metric_dim, self.repeats = metric_dim, repeats
        self.mlp = MLP(in_dim, metric_dim * repeats, layers,
                       hidden_size=hidden_dim, dropout=dropout)

    def forward(self, z, noise=None):
        return self.mlp(z, noise=noise).reshape(z.shape[0], self.metric_dim,
                                                self.repeats)
