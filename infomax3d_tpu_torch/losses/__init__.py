"""Losses by their config name (port of `infomax3d_tpu/losses`'s
`get_loss`): NT-Xent, NT-Xent with distance reconstruction (`NTXentAE`),
BYOL's `CosineSimilarityLoss`, the multiple-positive (conformer) family and the five supervised names.
The other losses of the JAX package's `LOSS_REGISTRY` are ROADMAP queue
1, item 6, and raise."""
from __future__ import annotations

import torch

from infomax3d_tpu_torch.losses.contrastive import (MULTI_POSITIVE_LOSSES,
                                                    CosineSimilarityLoss,
                                                    NTXent, NTXentAE)

SUPERVISED_LOSSES = ("L1Loss", "MSELoss", "BCEWithLogitsLoss",
                     "OGBNanLabelBCEWithLogitsLoss", "OGBNanLabelMSELoss")


class SupervisedLoss:
    """`loss(pred, target)` of a supervised name: the mean over every entry
    (L1Loss, MSELoss, BCEWithLogitsLoss) or over the labelled ones (the
    OGBNanLabel losses), as the JAX package's loss classes compute it."""

    def __init__(self, name: str):
        self.name = name

    def __call__(self, pred: torch.Tensor, target: torch.Tensor
                 ) -> torch.Tensor:
        from infomax3d_tpu_torch.train.supervised import supervised_loss
        valid = (~torch.isnan(target) if self.name.startswith("OGBNan")
                 else torch.ones_like(target, dtype=torch.bool))
        return supervised_loss(self.name, pred, target, valid)


LOSS_REGISTRY = {"NTXent": NTXent, "NTXentAE": NTXentAE,
                 "CosineSimilarityLoss": CosineSimilarityLoss,
                 **{cls.__name__: cls for cls in MULTI_POSITIVE_LOSSES}}


def get_loss(name: str, **params):
    if name in SUPERVISED_LOSSES:
        return SupervisedLoss(name)
    if name not in LOSS_REGISTRY:
        raise NotImplementedError(
            f"loss_func '{name}' is not ported yet (ROADMAP queue 1, item 6)")
    return LOSS_REGISTRY[name](**params)


__all__ = ["CosineSimilarityLoss", "LOSS_REGISTRY", "NTXent", "NTXentAE", "SUPERVISED_LOSSES",
           "SupervisedLoss", "get_loss"]
