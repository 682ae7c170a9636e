"""The reference of loss NTXentMultiplePositives (`reference/loss.py`):
the 2D model's [B, D] against the 3D model's [B * C, D], at the loss
parameters' tau (0.5 where none is given)."""
from bench_port.reference.loss import ntxent_multiple_positives


def loss(params, outputs, batch):
    return ntxent_multiple_positives(outputs["model"], outputs["model3d"],
                                     float(params.get("tau", 0.5)))
