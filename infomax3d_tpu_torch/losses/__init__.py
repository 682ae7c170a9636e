"""Losses by their config name (port of `infomax3d_tpu/losses`'s
`get_loss`): every name of the JAX package's `LOSS_REGISTRY`: NT-Xent and
its variants (distance reconstruction, hard negatives, shuffled, extra
negatives, local-global), InfoNCE, BYOL's `CosineSimilarityLoss`, Barlow
Twins, the VICReg-style `RegularizationLoss`, the philosophy trainer's
`CriticLoss`, the JSE family, `SampleLossWrapper`, the multiple-positive
(conformer) family and the five supervised names.  An unknown name
raises `KeyError`, as in the JAX package."""
from __future__ import annotations

import torch

from infomax3d_tpu_torch.losses.contrastive import (MULTI_POSITIVE_LOSSES,
                                                    OTHER_LOSSES,
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

    def __call__(self, pred: torch.Tensor, target: torch.Tensor, **kw
                 ) -> torch.Tensor:
        from infomax3d_tpu_torch.train.supervised import supervised_loss
        if not self.name.startswith("OGBNan"):
            # the JAX classes' plain mean, over the broadcast shape (the
            # philosophy trainer's default critic loss meets a [B, D]
            # embedding and a [B, D, R] reconstruction)
            pred, target = torch.broadcast_tensors(pred, target)
        valid = (~torch.isnan(target) if self.name.startswith("OGBNan")
                 else torch.ones_like(target, dtype=torch.bool))
        return supervised_loss(self.name, pred, target, valid)


LOSS_REGISTRY = {"NTXent": NTXent, "NTXentAE": NTXentAE,
                 "CosineSimilarityLoss": CosineSimilarityLoss,
                 **{cls.__name__: cls for cls in MULTI_POSITIVE_LOSSES},
                 **{cls.__name__: cls for cls in OTHER_LOSSES}}


def get_loss(name: str, **params):
    if name in SUPERVISED_LOSSES:
        return SupervisedLoss(name)
    if name not in LOSS_REGISTRY:
        raise KeyError(f"unknown loss_func '{name}'; known: "
                       f"{sorted(set(LOSS_REGISTRY) | set(SUPERVISED_LOSSES))}")
    return LOSS_REGISTRY[name](**params)


__all__ = ["CosineSimilarityLoss", "LOSS_REGISTRY", "NTXent", "NTXentAE", "SUPERVISED_LOSSES",
           "SupervisedLoss", "get_loss"]
