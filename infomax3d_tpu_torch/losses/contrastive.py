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
    """Mean over x1 and x2 of log mean_{i<j} exp(-t |x_i - x_j|^2).

    The squared distances of the pairs i < j come from `torch.pdist`, as
    the original computes them: N (N - 1) / 2 values and no [N, N, D]
    difference tensor, so the memory is O(N^2) on the host (the metric)
    and on the card under autograd (the regularizer); the JAX twin builds
    the [N, N, D] differences and gives the same value.  A duplicated row
    is a zero distance with a zero gradient; spread-out rows give -inf."""
    def _u(x):
        sq = torch.pdist(x.reshape(x.shape[0], -1)).pow(2)
        return torch.log(torch.exp(-t * sq).mean())
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


# --- the other objectives: critic, Barlow Twins, VICReg, InfoNCE, hard
# negatives, shuffled and sampled NT-Xent, extra negatives, local-global, JSE

class CriticLoss:
    """The PhilosophyTrainer's critic loss (reference losses.py:33-42):
    z2 [B, D] and the reconstruction [B, D, R] each normalized over D
    (norms clamped at 1e-12), the squared difference summed over D and
    averaged over B and R."""

    def __call__(self, z2, reconstruction, **kw):
        z2n = z2 / _norms(z2, 1)[:, None].clamp(min=1e-12)
        rn = reconstruction / torch.linalg.vector_norm(
            reconstruction, dim=1, keepdim=True).clamp(min=1e-12)
        return ((z2n[..., None] - rn) ** 2).sum(dim=1).mean()


class BarlowTwinsLoss(_Regularized):
    """Barlow Twins (losses.py:45-73): the cross-correlation of the
    standardized views (unbiased std), on-diagonal ``(c_ii - 1)²`` plus
    `lambd` times the off-diagonal squares, both times `scale_loss`."""

    def __init__(self, scale_loss=1 / 32, lambd=3.9e-3, **kw):
        super().__init__(**kw)
        self.scale_loss = scale_loss
        self.lambd = lambd

    def __call__(self, z1, z2, **kw):
        b = z1.shape[0]
        z1n = (z1 - z1.mean(0)) / z1.std(0, unbiased=True)
        z2n = (z2 - z2.mean(0)) / z2.std(0, unbiased=True)
        corr = (z1n.T @ z2n) / b
        diag = torch.diagonal(corr)
        on = ((diag - 1.0) ** 2).sum() * self.scale_loss
        off = ((corr - torch.diag(diag)) ** 2).sum() * self.scale_loss
        return self._reg(on + self.lambd * off, z1, z2)


class RegularizationLoss(_Regularized):
    """VICReg-style (losses.py:98-123): the MSE of the views plus the
    variance and covariance terms (`norm` is accepted and unused)."""

    def __init__(self, norm=True, uniformity_reg=0.0, variance_reg=1.0,
                 covariance_reg=0.04):
        super().__init__(uniformity_reg, variance_reg, covariance_reg)

    def __call__(self, z1, z2, **kw):
        return self._reg(((z1 - z2) ** 2).mean(), z1, z2)


class InfoNCE(NTXent):
    """NT-Xent whose denominator keeps the positive (losses.py:998-1034)."""

    def __call__(self, z1, z2, **kw):
        sim = torch.exp(cosine_sim_matrix(z1, z2, self.norm) / self.tau)
        pos = torch.diagonal(sim)
        loss = -torch.log(pos / sim.sum(dim=1)).mean()
        return self._reg(loss, z1, z2)


class _HardNegative:
    """Hard-negative reweighting of 'Contrastive Learning with Hard
    Negative Samples' (losses.py:1037-1114)."""

    def __init__(self, norm, tau, tau_plus, beta):
        self.norm, self.tau, self.tau_plus, self.beta = norm, tau, tau_plus, \
            beta

    def _pos_ng(self, z1, z2):
        b = z1.shape[0]
        sim = torch.exp(cosine_sim_matrix(z1, z2, self.norm) / self.tau)
        eye = torch.eye(b, dtype=torch.bool, device=sim.device)
        pos = torch.diagonal(sim)
        neg = sim[~eye].reshape(b, b - 1)
        imp = torch.exp(self.beta * torch.log(neg))
        reweight = (imp * neg).sum(dim=-1) / imp.mean(dim=-1)
        ng = (-self.tau_plus * (b - 1) * pos + reweight) / (1 - self.tau_plus)
        return pos, ng.clamp(min=(b - 1) * math.e ** (-1 / self.tau))


class InfoNCEHard(_HardNegative):
    def __init__(self, norm=False, tau=0.5, tau_plus=0.1, beta=0.5):
        super().__init__(norm, tau, tau_plus, beta)

    def __call__(self, z1, z2, **kw):
        pos, ng = self._pos_ng(z1, z2)
        return -torch.log(pos / (pos + ng)).mean()


class NTXentHard(_HardNegative):
    def __init__(self, norm=True, tau=0.5, tau_plus=0.1, beta=0.1):
        super().__init__(norm, tau, tau_plus, beta)

    def __call__(self, z1, z2, **kw):
        pos, ng = self._pos_ng(z1, z2)
        return -torch.log(pos / ng).mean()


def _drawn(given, generator, what: str, draw):
    """`given` (indices handed in), else `draw(generator)`; a draw with no
    generator raises, as the JAX loss does without its key."""
    if given is not None:
        return given
    if generator is None:
        raise ValueError(f"{what} needs generator=torch.Generator(...)")
    return draw(generator)


class NTXentShuffled(NTXent):
    """NT-Xent against z2 with its rows permuted (losses.py:967-995), no
    regularizer tail.  The permutation is `perm` or drawn from
    `generator`; with neither the loss raises, as the JAX loss raises
    without `key`."""

    def __init__(self, norm=True, tau=0.5):
        super().__init__(norm=norm, tau=tau)

    def __call__(self, z1, z2, generator=None, perm=None, **kw):
        perm = _drawn(perm, generator, "NTXentShuffled", lambda gen:
                      torch.randperm(z2.shape[0], generator=gen,
                                     device=gen.device))
        sim = torch.exp(cosine_sim_matrix(z1, z2[perm.to(z2.device)],
                                          self.norm) / self.tau)
        return _ntxent_of(sim)


class SampleLossWrapper:
    """The wrapped loss `loss_func` on ``int(B * fraction_samples)`` rows
    drawn with replacement (losses.py:1188-1206): `idx`, or drawn from
    `generator`; with neither it raises, as the JAX wrapper without
    `key`."""

    def __init__(self, loss_func, fraction_samples=0.1, **loss_params):
        from infomax3d_tpu_torch.losses import get_loss
        self.loss = get_loss(loss_func, **loss_params)
        self.fraction = fraction_samples

    def __call__(self, x, y, generator=None, idx=None, **kw):
        n = int(x.shape[0] * self.fraction)
        idx = _drawn(idx, generator, "SampleLossWrapper", lambda gen:
                     torch.randint(0, x.shape[0], (n,), generator=gen,
                                   device=gen.device))
        idx = idx.to(x.device)
        return self.loss(x[idx], y[idx])


class NTXentExtraNegatives(_Regularized):
    """The noisy-negatives loss (losses.py:889-943): z2 is the 3D side's
    [B, D] rows followed by X noised copies of each molecule, [B * X, D]
    molecule-major after them; each row's copies join its negatives,
    weighted by `extra_negatives_weight`."""

    def __init__(self, norm=True, tau=0.5, extra_negatives_weight=1.0, **kw):
        super().__init__(**kw)
        self.norm = norm
        self.tau = tau
        self.extra_negatives_weight = extra_negatives_weight

    def __call__(self, z1, z2, **kw):
        b, d = z1.shape
        extra = z2[b:].reshape(b, -1, d)                   # [B, X, D]
        z2m = z2[:b]
        sim = z1 @ z2m.T
        sim_x = torch.einsum("ik,iuk->iu", z1, extra)
        if self.norm:
            n1 = _norms(z1, 1)
            sim = sim / (n1[:, None] * _norms(z2m, 1)[None, :])
            sim_x = sim_x / (_norms(extra, 2) * n1[:, None])
        sim_x = torch.exp(sim_x / self.tau) * self.extra_negatives_weight
        full = torch.cat([torch.exp(sim / self.tau), sim_x], dim=-1)
        pos = torch.diagonal(full)
        loss = -torch.log(pos / (full.sum(dim=1) - pos)).mean()
        return self._reg(loss, z1, z2)


def _node_graph_masks(zn, g: int, node_graph, node_mask):
    """(positive, negative) [N, G] masks of nodes against graphs: a node's
    own graph, and the other graphs; padding nodes (`node_mask` false, id
    G) in neither."""
    pos = (node_graph.long()[:, None] == torch.arange(
        g, device=zn.device)[None, :]).to(zn.dtype)
    if node_mask is None:
        valid = torch.ones((zn.shape[0], 1), dtype=zn.dtype,
                           device=zn.device)
    else:
        pos = pos * node_mask[:, None]
        valid = node_mask[:, None].to(zn.dtype)
    return pos, valid - pos


class NTXentLocalGlobal:
    """Node-against-graph NT-Xent (losses.py:1117-1161) with the positive
    mask from the nodes' graph ids `node_graph` (padding nodes, `node_mask`
    false, count nowhere)."""

    def __init__(self, norm=True, tau=0.5, **kw):
        self.norm = norm
        self.tau = tau

    def __call__(self, zn, zg, node_graph=None, node_mask=None, **kw):
        pos_mask, neg_mask = _node_graph_masks(zn, zg.shape[0], node_graph,
                                               node_mask)
        sim = zn @ zg.T
        if self.norm:
            sim = sim / (_norms(zn, 1)[:, None] * _norms(zg, 1)[None, :]
                         + 1e-10)
        sim = torch.exp(sim / self.tau)
        pos = (sim * pos_mask).sum(dim=1)
        neg = (sim * neg_mask).sum(dim=1)
        ratio = torch.where(pos > 0, pos / neg.clamp(min=1e-12),
                            torch.ones((), dtype=pos.dtype,
                                       device=pos.device))
        if node_mask is None:
            return -torch.log(ratio).mean()
        return -torch.where(node_mask, torch.log(ratio), torch.zeros(
            (), dtype=ratio.dtype, device=ratio.device)).sum() \
            / node_mask.sum().clamp(min=1)


class NTXentGlobalLocal(NTXentLocalGlobal):
    """`NTXentLocalGlobal` with its arguments switched (losses.py:
    1164-1185)."""

    def __call__(self, zg, zn, node_graph=None, node_mask=None, **kw):
        return super().__call__(zn, zg, node_graph=node_graph,
                                node_mask=node_mask)


LOG_2 = math.log(2.0)


def get_positive_expectation(p, measure: str, average: bool = True):
    """The positive-sample expectation of a divergence `measure`
    (losses.py:1209-1230)."""
    if measure == "GAN":
        ep = -F.softplus(-p)
    elif measure == "JSD":
        ep = LOG_2 - F.softplus(-p)
    elif measure == "X2":
        ep = p ** 2
    elif measure in ("KL", "DV", "W1"):
        ep = p
    elif measure == "RKL":
        ep = -torch.exp(-p)
    elif measure == "H2":
        ep = 1.0 - torch.exp(-p)
    else:
        raise ValueError(f"measure does not exist: {measure}")
    return ep.mean() if average else ep


def get_negative_expectation(q, measure: str, average: bool = True):
    """The negative-sample expectation of a divergence `measure`
    (losses.py:1233-1249)."""
    if measure == "GAN":
        eq = F.softplus(-q) + q
    elif measure == "JSD":
        eq = F.softplus(-q) + q - LOG_2
    elif measure == "X2":
        eq = -0.5 * ((torch.sqrt(q ** 2) + 1.0) ** 2)
    elif measure == "KL":
        eq = torch.exp(q - 1.0)
    elif measure == "RKL":
        eq = q - 1.0
    elif measure == "DV":
        eq = torch.logsumexp(q, dim=0) - math.log(q.shape[0])
    elif measure == "H2":
        eq = torch.exp(q) - 1.0
    elif measure == "W1":
        eq = q
    else:
        raise ValueError(f"measure does not exist: {measure}")
    return eq.mean() if average else eq


def jse_global_global(z1, z2):
    """The JSD estimator between two global views (losses.py:1356-1376):
    every entry of the masked score matrices summed (masked entries
    contribute exactly 0)."""
    g = z1.shape[0]
    d = z1 @ z2.T
    eye = torch.eye(g, dtype=d.dtype, device=d.device)
    pos_score = LOG_2 - F.softplus(-(d * eye))
    neg_score = F.softplus(-(d * (1 - eye))) + d * (1 - eye) - LOG_2
    return neg_score.sum() / (g * (g - 1)) - pos_score.sum() / g


def jse_local_global(zg, zn, node_graph, node_mask=None, measure="JSD"):
    """MVGRL's local-global JSE (losses.py:1330-1353) with the graph-id
    masks of `NTXentLocalGlobal`."""
    g = zg.shape[0]
    pos_mask, neg_mask = _node_graph_masks(zn, g, node_graph, node_mask)
    n_real = zn.shape[0] if node_mask is None else node_mask.sum()
    d = zn @ zg.T
    e_pos = get_positive_expectation(d * pos_mask, measure,
                                     average=False).sum() / n_real
    e_neg = get_negative_expectation(d * neg_mask, measure,
                                     average=False).sum() / (n_real * (g - 1))
    return e_neg - e_pos


class JSELossGlobal:
    def __init__(self, **kw):
        pass

    def __call__(self, z1, z2, **kw):
        return jse_global_global(z1, z2)


class JSELoss:
    """The multi-view JSE combiner (losses.py:1252-1298): local-global
    pairs when node views `zs_n` come, else global-global; beyond two views
    the pairs `sigma` selects."""

    def __init__(self, neg_by_crpt=False, **kw):
        self.neg_by_crpt = neg_by_crpt

    def __call__(self, zs, zs_n=None, node_graph=None, node_mask=None,
                 sigma=None, **kw):
        import itertools
        pairs = list(itertools.combinations(range(len(zs)), 2))
        if zs_n is not None:
            def jse(i, j):
                return jse_local_global(zs[i], zs_n[j], node_graph,
                                        node_mask)
            if len(zs) == 1:
                return jse(0, 0)
            if len(zs) == 2:
                return jse(0, 1) + jse(1, 0)
            return sum(jse(i, j) + jse(j, i) for i, j in pairs
                       if sigma[i][j])
        if len(zs) == 2:
            return jse_global_global(zs[0], zs[1])
        return sum(jse_global_global(zs[i], zs[j]) for i, j in pairs
                   if sigma[i][j])


OTHER_LOSSES = (CriticLoss, BarlowTwinsLoss, RegularizationLoss, InfoNCE,
               InfoNCEHard, NTXentHard, NTXentShuffled, SampleLossWrapper,
               NTXentExtraNegatives, NTXentLocalGlobal, NTXentGlobalLocal,
               JSELossGlobal, JSELoss)
