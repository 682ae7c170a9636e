"""Contrastive losses (port of `infomax3d_tpu/losses/contrastive.py`):
NT-Xent, BYOL's cosine loss and the multiple-positive (conformer) family with the shared
uniformity / variance / covariance regularizers.

The multi-positive losses take the 3D side as [B * C, D], C conformers per
molecule packed molecule-major (`data/loader.py::conformer_collate`), and
reshape it to [B, C, D].  The Separate2D losses read a [B, C * D] 2D head
the same way; the probabilistic ones (KL, JSD, likelihood) a [B, 2 * D]
head, mean then log-variance."""
from __future__ import annotations

import math

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


class NTXentAE(NTXent):
    """NT-Xent and the weighted distance-reconstruction MSE, returned as
    the pair ``(contrastive, reconstruction_reg * mse)`` (reference
    losses.py:165-204, the autoencoder trainer's loss); the MSE is the mean
    over the pairs `mask` selects, or over all without one."""

    def __init__(self, norm: bool = True, tau: float = 0.5,
                 reconstruction_reg: float = 1.0, **kw):
        super().__init__(norm=norm, tau=tau, **kw)
        self.reconstruction_reg = reconstruction_reg

    def __call__(self, z1: torch.Tensor, z2: torch.Tensor,
                 distances: torch.Tensor = None,
                 distance_pred: torch.Tensor = None,
                 mask: torch.Tensor = None):
        base = NTXent.__call__(self, z1, z2)
        se = (distances - distance_pred) ** 2
        if mask is None:
            rec = se.mean()
        else:
            rec = torch.where(mask, se, torch.zeros(
                (), dtype=se.dtype, device=se.device)).sum() \
                / mask.sum().clamp(min=1)
        return base, self.reconstruction_reg * rec


class CosineSimilarityLoss(_Regularized):
    """BYOL's symmetric loss ``2 - 2 cos``: the mean over rows of
    ``||x̂ - ŷ||²``, each row normalized with its norm clamped at 1e-12
    (reference losses.py:76-95), plus the regularizer tail."""

    def __call__(self, z1: torch.Tensor, z2: torch.Tensor) -> torch.Tensor:
        x = z1 / torch.linalg.vector_norm(z1, dim=-1,
                                          keepdim=True).clamp(min=1e-12)
        y = z2 / torch.linalg.vector_norm(z2, dim=-1,
                                          keepdim=True).clamp(min=1e-12)
        loss = ((x - y) ** 2).sum(dim=-1).mean()
        return self._reg(loss, z1, z2)


def _norms(x: torch.Tensor, dim: int) -> torch.Tensor:
    return torch.linalg.vector_norm(x, dim=dim)


def _unit(x: torch.Tensor) -> torch.Tensor:
    return x / _norms(x, 2)[..., None]


def _ntxent_of(sim: torch.Tensor) -> torch.Tensor:
    """``-mean(log(pos / (rowsum - pos)))`` of a [B, B] similarity with the
    positives on the diagonal."""
    pos = torch.diagonal(sim)
    return -torch.log(pos / (sim.sum(dim=1) - pos)).mean()


def _conformer_std_reg(z2: torch.Tensor) -> torch.Tensor:
    """mean(relu(1 - std)) of each molecule's conformer embeddings."""
    return F.relu(1 - torch.sqrt(z2.var(dim=1, unbiased=True) + 1e-4)).mean()


class _MultiPositive(_Regularized):
    """The family's shared options (`norm`, `tau`)."""

    def __init__(self, norm: bool = True, tau: float = 0.5, **kw):
        super().__init__(**kw)
        self.norm = norm
        self.tau = tau

    @staticmethod
    def _views(z1, z2, split_2d: bool):
        """(z1, z2) as [B, D] (or [B, C, D] with `split_2d`) and
        [B, C, D]."""
        b, d = z1.shape[0], z2.shape[-1]
        return (z1.reshape(b, -1, d) if split_2d else z1,
                z2.reshape(b, -1, d))

    def _pair_sim(self, z1, z2):
        """[B, B, C1, C2] cosine (or dot) similarity of every conformer
        pair of every molecule pair."""
        sim = torch.einsum("ilk,juk->ijlu", z1, z2)
        if self.norm:
            sim = sim / torch.einsum("il,ju->ijlu", _norms(z1, 2),
                                     _norms(z2, 2))
        return sim


class NTXentMultiplePositives(_MultiPositive):
    """z2 holds C conformers per molecule: the similarities are summed over
    the conformers before the softmax ratio (losses.py:206-258)."""

    def __init__(self, norm=True, tau=0.5, conformer_variance_reg=0.0, **kw):
        super().__init__(norm, tau, **kw)
        self.conformer_variance_reg = conformer_variance_reg

    def __call__(self, z1, z2):
        z1, z2 = self._views(z1, z2, False)
        sim = torch.einsum("ik,juk->iju", z1, z2)
        if self.norm:
            sim = sim / (_norms(z1, 1)[:, None, None]
                         * _norms(z2, 2)[None, :, :])
        loss = _ntxent_of(torch.exp(sim / self.tau).sum(dim=2))
        if self.conformer_variance_reg > 0:
            loss = loss + self.conformer_variance_reg * _conformer_std_reg(z2)
        return self._reg(loss, z1, z2)


class NTXentMultiplePositivesV2(_MultiPositive):
    """Positives from all C conformers, negatives only against conformer 0
    (losses.py:598-643)."""

    def __call__(self, z1, z2):
        z1, z2 = self._views(z1, z2, False)
        pos = (z1[:, None, :] * z2).sum(dim=2)             # [B, C]
        sim = z1 @ z2[:, 0, :].T
        if self.norm:
            n1, n2 = _norms(z1, 1), _norms(z2, 2)
            pos = pos / (n1[:, None] * n2)
            sim = sim / (n1[:, None] * n2[None, :, 0])
        sim = torch.exp(sim / self.tau)
        pos = torch.exp(pos / self.tau).sum(dim=1)
        loss = -torch.log(pos / (sim.sum(dim=1) - torch.diagonal(sim))).mean()
        return self._reg(loss, z1, z2)


class NTXentMultiplePositivesV3(_MultiPositive):
    """Each conformer an independent positive term (losses.py:646-689)."""

    def __call__(self, z1, z2):
        z1, z2 = self._views(z1, z2, False)
        sim = torch.einsum("ik,juk->iju", z1, z2)
        if self.norm:
            sim = sim / (_norms(z1, 1)[:, None, None]
                         * _norms(z2, 2)[None, :, :])
        sim = torch.exp(sim / self.tau)                    # [B, B, C]
        idx = torch.arange(sim.shape[0], device=sim.device)
        pos = sim[idx, idx, :]                             # [B, C]
        loss = -torch.log(pos / (sim.sum(dim=1) - pos)).mean()
        return self._reg(loss, z1, z2)


class NTXentMultiplePositivesSeparate2D(_MultiPositive):
    """The 2D side per conformer too; the 4-D similarity summed over the
    conformer pairs (losses.py:692-744)."""

    def __call__(self, z1, z2):
        z1, z2 = self._views(z1, z2, True)
        b = z1.shape[0]
        pos = (z1 * z2).sum(dim=2)                         # [B, C]
        if self.norm:
            pos = pos / (_norms(z1, 2) * _norms(z2, 2))
        sim = torch.exp(self._pair_sim(z1, z2) / self.tau)
        pos = torch.exp(pos / self.tau).sum(dim=1)
        sim = sim.reshape(b, b, -1).sum(dim=2)
        loss = -torch.log(pos / (sim.sum(dim=1) - torch.diagonal(sim))).mean()
        return self._reg(loss, z1, z2)


class NTXentMinimumMatching(_MultiPositive):
    """The best positive conformer pair against the worst negative pairs
    (losses.py:747-794)."""

    def __call__(self, z1, z2):
        z1, z2 = self._views(z1, z2, True)
        sim = torch.exp(self._pair_sim(z1, z2) / self.tau)
        # reference quirk (losses.py:782): the "positive" is the max over
        # the conformer diagonal of all molecule pairs, max_{j,l}
        # sim[i, j, l, l]
        pos = torch.diagonal(sim, dim1=2, dim2=3).amax(dim=(1, 2))
        min_sim = sim.amin(dim=(2, 3))                     # [B, B]
        loss = -torch.log(pos / (min_sim.sum(dim=1)
                                 - torch.diagonal(min_sim))).mean()
        return self._reg(loss, z1, z2)


class MaximumSimilarityMSE(_MultiPositive):
    """The least MSE over conformer pairs (losses.py:797-837)."""

    def __call__(self, z1, z2):
        z1, z2 = self._views(z1, z2, True)
        diff = ((z1[:, :, None, :] - z2[:, None, :, :]) ** 2).mean(dim=-1)
        return self._reg(diff.amin(dim=(1, 2)).mean(), z1, z2)


class NTXentMaximumSimilarity(_MultiPositive):
    """The most similar conformer pair as each molecule pair's similarity
    (losses.py:839-886)."""

    def __call__(self, z1, z2):
        z1, z2 = self._views(z1, z2, True)
        sim = torch.exp(self._pair_sim(z1, z2).amax(dim=(2, 3)) / self.tau)
        return self._reg(_ntxent_of(sim), z1, z2)


class _Probabilistic(_MultiPositive):
    """The 2D head as a diagonal Gaussian: [B, 2 * D] -> mean and
    log-variance, each [B, D]; z2 as [B, C, D]."""

    @staticmethod
    def _views(z1, z2, split_2d: bool = False):
        b, d = z1.shape[0], z2.shape[-1]
        return z1.reshape(b, 2, d), z2.reshape(b, -1, d)


class KLDivergenceMultiplePositives(_Probabilistic):
    """Mean KL(N2 || N1) of diagonal Gaussians, N2 from the conformers'
    mean and variance (losses.py:261-314)."""

    def __init__(self, norm=False, tau=0.5, **kw):
        super().__init__(norm, tau, **kw)

    def __call__(self, z1, z2):
        z1, z2 = self._views(z1, z2)
        if self.norm:
            z1, z2 = _unit(z1), _unit(z2)
        mu1, var1 = z1[:, 0, :], torch.exp(z1[:, 1, :])
        mu2 = z2.mean(dim=1)
        var2 = z2.var(dim=1, unbiased=True) + 1e-6
        kl = 0.5 * (torch.log(var1) - torch.log(var2) - 1.0 + var2 / var1
                    + (mu1 - mu2) ** 2 / var1).sum(dim=1)
        return self._reg(kl.mean(), z1, z2)


class KLDivergenceMultiplePositivesV2(_Probabilistic):
    """The pairwise KL, summed over dimensions, as the NT-Xent similarity
    (losses.py:479-534; the JAX package's reading of a reference that
    crashes for D > 1)."""

    def __call__(self, z1, z2):
        z1, z2 = self._views(z1, z2)
        mu1, std1 = z1[:, 0, :], torch.exp(z1[:, 1, :] / 2.0)
        mu2 = z2.mean(dim=1)
        std2 = z2.std(dim=1, unbiased=True) + 1e-5
        v1, v2 = std1[:, None, :] ** 2, std2[None, :, :] ** 2
        kl = (torch.log(std2[None, :, :] / std1[:, None, :])
              + (v1 + (mu1[:, None, :] - mu2[None, :, :]) ** 2) / (2 * v2)
              - 0.5).sum(dim=2)                            # [B, B]
        return self._reg(_ntxent_of(torch.exp(kl / self.tau)), z1, z2)


class JSDMultiplePositivesLoss(_Probabilistic):
    """A KL-based similarity matrix in the NT-Xent ratio (losses.py:
    317-391, the vectorized `kl_similarity2`)."""

    def __call__(self, z1, z2):
        z1, z2 = self._views(z1, z2)
        d = z2.shape[-1]
        if self.norm:
            z1, z2 = _unit(z1), _unit(z2)
        mu1 = z1[:, 0, :][None, :, :]                      # j index
        var1 = torch.exp(z1[:, 1, :])[None, :, :]
        mu2 = z2.mean(dim=1)[:, None, :]                   # i index
        var2 = z2.var(dim=1, unbiased=True)[:, None, :]
        log_det_diff = torch.log((torch.prod(var2, dim=2) + 1e-5)
                                 / torch.prod(var1, dim=2))
        trace_inv = (var1 / (var2 + 1e-5)).sum(dim=2)
        msm = ((mu2 - mu1) ** 2 / (var2 + 1e-5)).sum(dim=2)
        sim = 0.5 * (log_det_diff - d + trace_inv + msm)   # [B, B]
        return self._reg(_ntxent_of(sim), z1, z2)


class NTXentLikelihoodLoss(_Probabilistic):
    """The conformers' Gaussian likelihood under the 2D head's (mean,
    log-variance) as the similarity (losses.py:537-595)."""

    def __init__(self, norm=True, tau=0.5, conformer_variance_reg=0.0, **kw):
        super().__init__(norm, tau, **kw)
        self.conformer_variance_reg = conformer_variance_reg

    def __call__(self, z1, z2):
        z1, z2 = self._views(z1, z2)
        mu, std = z1[:, 0, :], torch.exp(z1[:, 1, :] / 2.0)
        # log N(z2[j, u, k]; mu[i, k], std[i, k]) as [i, j, u, k]
        diff = z2[None, :, :, :] - mu[:, None, None, :]
        s = std[:, None, None, :]
        log_prob = (-0.5 * (diff / s) ** 2 - torch.log(s)
                    - 0.5 * math.log(2 * math.pi))
        kernel = torch.exp(log_prob).mean(dim=(2, 3))      # [B, B]
        loss = _ntxent_of(torch.exp(kernel / self.tau))
        if self.conformer_variance_reg > 0:
            loss = loss + self.conformer_variance_reg * _conformer_std_reg(z2)
        return self._reg(loss, z1, z2)


class NTXentMMDSeparate2D(_MultiPositive):
    """A multi-kernel MMD between the two conformer sets as the similarity
    (losses.py:394-476); the kernels' bandwidth carries no gradient."""

    def __init__(self, norm=True, tau=0.5, kernel_num=5, kernel_mul=2.0,
                 **kw):
        super().__init__(norm, tau, **kw)
        self.kernel_num = kernel_num
        self.kernel_mul = kernel_mul

    def __call__(self, z1, z2):
        z1, z2 = self._views(z1, z2, True)
        b, c, d = z1.shape
        if self.norm:
            z1, z2 = _unit(z1), _unit(z2)
        # [i, j, 2C, D]: molecule j's 2D conformers, then molecule i's 3D
        total = torch.cat([z1[None].expand(b, b, c, d),
                           z2[:, None].expand(b, b, c, d)], dim=2)
        n = 2 * c
        l2 = ((total[:, :, None, :, :] - total[:, :, :, None, :]) ** 2
              ).sum(dim=4)                                 # [B, B, 2C, 2C]
        bw = l2.detach().sum(dim=(2, 3)) / (n * n - n)
        bw = bw / self.kernel_mul ** (self.kernel_num // 2)
        kv = sum(torch.exp(-l2 / (bw * self.kernel_mul ** i)[:, :, None, None])
                 for i in range(self.kernel_num))
        mmd = (kv[:, :, :c, :c] + kv[:, :, c:, c:] - kv[:, :, :c, c:]
               - kv[:, :, c:, :c]).mean(dim=(2, 3))
        sim = torch.exp((1.0 / (mmd + 1.0)) / self.tau)
        return self._reg(_ntxent_of(sim), z1, z2)


MULTI_POSITIVE_LOSSES = (
    NTXentMultiplePositives, NTXentMultiplePositivesV2,
    NTXentMultiplePositivesV3, NTXentMultiplePositivesSeparate2D,
    NTXentMinimumMatching, MaximumSimilarityMSE, NTXentMaximumSimilarity,
    KLDivergenceMultiplePositives, KLDivergenceMultiplePositivesV2,
    JSDMultiplePositivesLoss, NTXentLikelihoodLoss, NTXentMMDSeparate2D)
