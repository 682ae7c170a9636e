"""NT-Xent with several positives (the 3D Infomax repository's
`NTXentMultiplePositives`): the cosine similarity of each molecule's 2D
embedding with each of the C conformer embeddings of every molecule, its
exponential at temperature tau summed over the conformers, and the mean
over molecules of ``-log(positive / (row sum - positive))``."""
from __future__ import annotations

import torch


def ntxent_multiple_positives(z1: torch.Tensor, z2: torch.Tensor,
                              tau: float) -> torch.Tensor:
    """z1 [B, D], z2 [B * C, D] (molecule-major) -> the loss."""
    B = z1.shape[0]
    z2 = z2.reshape(B, -1, z2.shape[-1])
    a = z1 / torch.linalg.vector_norm(z1, dim=-1, keepdim=True)
    b = z2 / torch.linalg.vector_norm(z2, dim=-1, keepdim=True)
    sim = torch.exp(torch.einsum("ik,juk->iju", a, b) / tau).sum(dim=2)
    pos = torch.diagonal(sim)
    return -torch.log(pos / (sim.sum(dim=1) - pos)).mean()
