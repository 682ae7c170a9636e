"""Contrastive losses (port of `infomax3d_tpu/losses/contrastive.py`):
NT-Xent with the shared uniformity / variance / covariance regularizers."""
from __future__ import annotations

import torch
import torch.nn.functional as F


def uniformity_loss(x1: torch.Tensor, x2: torch.Tensor,
                    t: float = 2.0) -> torch.Tensor:
    def _u(x):
        x = x.reshape(x.shape[0], -1)
        sq = ((x[:, None, :] - x[None, :, :]) ** 2).sum(dim=-1)
        iu = torch.triu_indices(x.shape[0], x.shape[0], offset=1,
                                device=x.device)
        return torch.log(torch.exp(-t * sq[iu[0], iu[1]]).mean())
    return (_u(x1) + _u(x2)) / 2.0


def cov_loss(x: torch.Tensor) -> torch.Tensor:
    x = x.reshape(-1, x.shape[-1])
    b, d = x.shape
    xc = x - x.mean(dim=0)
    cov = (xc.T @ xc) / (b - 1)
    off = cov - torch.diag(torch.diag(cov))
    return (off ** 2).sum() / d


def std_loss(x: torch.Tensor) -> torch.Tensor:
    x = x.reshape(-1, x.shape[-1])
    std = torch.sqrt(x.var(dim=0, unbiased=True) + 1e-4)
    return F.relu(1.0 - std).mean()


class _Regularized:
    """The regularizer tail shared by the NT-Xent family."""

    def __init__(self, uniformity_reg=0.0, variance_reg=0.0,
                 covariance_reg=0.0):
        self.uniformity_reg = uniformity_reg
        self.variance_reg = variance_reg
        self.covariance_reg = covariance_reg

    def _reg(self, loss, z1, z2):
        if self.variance_reg > 0:
            loss = loss + self.variance_reg * (std_loss(z1) + std_loss(z2))
        if self.covariance_reg > 0:
            loss = loss + self.covariance_reg * (cov_loss(z1) + cov_loss(z2))
        if self.uniformity_reg > 0:
            loss = loss + self.uniformity_reg * uniformity_loss(z1, z2)
        return loss


def cosine_sim_matrix(z1: torch.Tensor, z2: torch.Tensor, norm: bool,
                      eps: float = 1e-8) -> torch.Tensor:
    sim = z1 @ z2.T
    if norm:
        n1 = torch.linalg.vector_norm(z1, dim=1)
        n2 = torch.linalg.vector_norm(z2, dim=1)
        sim = sim / (n1[:, None] * n2[None, :] + eps)
    return sim


class NTXent(_Regularized):
    """SimCLR NT-Xent: ``-mean(log(pos / (rowsum - pos)))`` over
    exp(similarity / tau), the positives on the diagonal."""

    def __init__(self, norm: bool = True, tau: float = 0.5, **kw):
        super().__init__(**kw)
        self.norm = norm
        self.tau = tau

    def __call__(self, z1: torch.Tensor, z2: torch.Tensor) -> torch.Tensor:
        sim = torch.exp(cosine_sim_matrix(z1, z2, self.norm) / self.tau)
        pos = torch.diagonal(sim)
        loss = -torch.log(pos / (sim.sum(dim=1) - pos)).mean()
        return self._reg(loss, z1, z2)
