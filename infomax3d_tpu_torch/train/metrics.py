"""Metrics (port of `infomax3d_tpu/train/metrics.py`): the regression
metrics, the contrastive probes, the QM9 denormalized errors and the OGB /
PCQM4M evaluators of the JAX package's `build_metrics` table.

They run on the host, as the JAX trainer runs its metrics (on its CPU
backend, `trainer.py:503-515`): each takes the epoch's or batch's
predictions and targets as numpy arrays or CPU tensors and computes in
float32 torch, the evaluators in float64 numpy.  `Uniformity` takes the
pairwise squared distances from `torch.pdist` (`uniformity_loss`), in
O(N^2) host memory: at the QMugs batch (1,500 conformer rows of 256) no
op allocates more than 4.5 MB, where the [N, N, D] differences took 2.3 GB.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from infomax3d_tpu_torch.losses.contrastive import cov_loss, uniformity_loss


def _t(x) -> torch.Tensor:
    """A host float32 tensor of `x`."""
    if isinstance(x, torch.Tensor):
        return x.detach().to("cpu", torch.float32)
    return torch.as_tensor(np.asarray(x, np.float32))


def _cos_sim_matrix(x1, x2):
    sim = x1 @ x2.T
    n1 = torch.linalg.vector_norm(x1, dim=1)
    n2 = torch.linalg.vector_norm(x2, dim=1)
    return sim / (n1[:, None] * n2[None, :])


# ---------------------------------------------------------------------------
# regression metrics
# ---------------------------------------------------------------------------

class MAE:
    def __call__(self, preds, targets, **kw):
        return (_t(preds) - _t(targets)).abs().mean()


class Rsquared:
    def __call__(self, preds, targets, **kw):
        p, t = _t(preds), _t(targets)
        total = ((t - t.mean()) ** 2).sum()
        residual = ((t - p) ** 2).sum()
        return 1.0 - residual / total


class PearsonR:
    def __call__(self, preds, targets, **kw):
        p, t = _t(preds), _t(targets)
        sx = p - p.mean(dim=0)
        sy = t - t.mean(dim=0)
        sigx = torch.sqrt((sx ** 2).sum(dim=0))
        sigy = torch.sqrt((sy ** 2).sum(dim=0))
        r = (sx * sy).sum(dim=0) / (sigx * sigy + 1e-8)
        return r.clamp(-1.0, 1.0).mean()


class MeanPredictorLoss:
    def __init__(self, loss_func=None):
        self.loss_func = loss_func or (lambda p, t: ((p - t) ** 2).mean())

    def __call__(self, x1, targets, **kw):
        t = _t(targets)
        return self.loss_func(torch.full_like(t, float(t.mean())), t)


def denormalize(normalized, means, stds, ev2mev=None):
    """reference trainer/metrics.py:82-86 — undo target normalization and
    convert energies eV -> meV."""
    out = normalized * stds[None, :] + means[None, :]
    if ev2mev is not None:
        out = out * ev2mev[None, :]
    return out


class QM9DenormalizedL1:
    def __init__(self, means=None, stds=None, ev2mev=None, dataset=None):
        if dataset is not None:
            means, stds = dataset.targets_mean, dataset.targets_std
            ev2mev = getattr(dataset, "ev2mev", None)
        self.means = _t(means)
        self.stds = _t(stds)
        self.ev2mev = None if ev2mev is None else _t(ev2mev)

    def _denorm(self, x):
        return denormalize(_t(x), self.means, self.stds, self.ev2mev)

    def __call__(self, preds, targets, **kw):
        return (self._denorm(preds) - self._denorm(targets)).abs().mean()


class QM9DenormalizedL2(QM9DenormalizedL1):
    def __call__(self, preds, targets, **kw):
        return ((self._denorm(preds) - self._denorm(targets)) ** 2).mean()


class QM9SingleTargetDenormalizedL1(QM9DenormalizedL1):
    def __init__(self, task_index=0, **kw):
        super().__init__(**kw)
        self.task_index = task_index

    def __call__(self, preds, targets, **kw):
        p = self._denorm(preds)[:, self.task_index]
        t = self._denorm(targets)[:, self.task_index]
        return (p - t).abs().mean()


# ---------------------------------------------------------------------------
# contrastive probes (trainer/metrics.py:161-463)
# ---------------------------------------------------------------------------

class DimensionCovariance:
    def __call__(self, x1, x2, pos_mask=None, **kw):
        return cov_loss(_t(x1)) + cov_loss(_t(x2))


class BatchVariance:
    def __call__(self, x1, x2, pos_mask=None, **kw):
        return _t(x1).std(dim=0).mean() + _t(x2).std(dim=0).mean()


class Alignment:
    def __init__(self, alpha=2):
        self.alpha = alpha

    def __call__(self, x1, x2, pos_mask=None, **kw):
        x1, x2 = _t(x1), _t(x2)
        if x1.shape != x2.shape and pos_mask is None:
            x2 = x2[: x1.shape[0]]
        return (torch.linalg.vector_norm(x1 - x2, dim=1) ** self.alpha).mean()


class Uniformity:
    def __init__(self, t=2):
        self.t = t

    def __call__(self, x1, x2, pos_mask=None, **kw):
        return uniformity_loss(_t(x1), _t(x2))


class _SimThresholdMetric:
    def __init__(self, threshold=0.5):
        self.threshold = threshold

    def _parts(self, x1, x2, pos_mask):
        x1, x2 = _t(x1), _t(x2)
        b = x1.shape[0]
        if x1.shape != x2.shape and pos_mask is None:
            x2 = x2[:b]
        sim = _cos_sim_matrix(x1, x2)
        preds = (sim + 1) / 2 > self.threshold
        pos_mask = torch.eye(b) if pos_mask is None else _t(pos_mask)
        neg_mask = 1 - pos_mask
        num_pos = b
        num_neg = b * (x2.shape[0] - 1)
        tp = num_pos - int(torch.count_nonzero(
            (preds.float() - pos_mask) * pos_mask))
        tn = num_neg - int(torch.count_nonzero(
            ((~preds).float() - neg_mask) * neg_mask))
        return tp / num_pos, tn / num_neg


class TruePositiveRate(_SimThresholdMetric):
    def __call__(self, x1, x2, pos_mask=None, **kw):
        return self._parts(x1, x2, pos_mask)[0]


class TrueNegativeRate(_SimThresholdMetric):
    def __call__(self, x1, x2, pos_mask=None, **kw):
        return self._parts(x1, x2, pos_mask)[1]


class ContrastiveAccuracy(_SimThresholdMetric):
    def __call__(self, x1, x2, pos_mask=None, **kw):
        tp, tn = self._parts(x1, x2, pos_mask)
        return (tp + tn) / 2


class PositiveSimilarity:
    def __call__(self, x1, x2, pos_mask=None, **kw):
        x1, x2 = _t(x1), _t(x2)
        if x1.shape != x2.shape and pos_mask is None:
            x2 = x2[: x1.shape[0]]
        if pos_mask is not None:
            pos = (_t(pos_mask) * _cos_sim_matrix(x1, x2)).sum(dim=1)
        else:
            pos = (x1 * x2).sum(dim=1) / (
                torch.linalg.vector_norm(x1, dim=1)
                * torch.linalg.vector_norm(x2, dim=1))
        return ((pos + 1) / 2).mean()


class NegativeSimilarity:
    def __call__(self, x1, x2, pos_mask=None, **kw):
        x1, x2 = _t(x1), _t(x2)
        b = x1.shape[0]
        if x1.shape != x2.shape and pos_mask is None:
            x2 = x2[:b]
        sim = _cos_sim_matrix(x1, x2)
        if pos_mask is not None:
            pos = (_t(pos_mask) * sim).sum(dim=1)
        else:
            pos = torch.diagonal(sim)
        neg = (sim.sum(dim=1) - pos) / (b - 1)
        return ((neg + 1) / 2).mean()


class PositiveSimilarityMultiplePositivesSeparate2d:
    def __call__(self, z1, z2, **kw):
        z1, z2 = _t(z1), _t(z2)
        b, d = z1.shape[0], z2.shape[-1]
        z1 = z1.reshape(b, -1, d)
        z2 = z2.reshape(b, -1, d)
        pos = (z1 * z2).sum(dim=2)
        pos = pos / (torch.linalg.vector_norm(z1, dim=2)
                     * torch.linalg.vector_norm(z2, dim=2))
        return ((pos.sum(dim=1) + 1) / 2).mean()


class NegativeSimilarityMultiplePositivesSeparate2d:
    def __call__(self, z1, z2, **kw):
        z1, z2 = _t(z1), _t(z2)
        b, d = z1.shape[0], z2.shape[-1]
        z1 = z1.reshape(b, -1, d)
        c = z1.shape[1]
        z2 = z2.reshape(b, -1, d)
        sim = torch.einsum("ilk,juk->ijlu", z1, z2)
        sim = sim / torch.einsum("il,ju->ijlu",
                                 torch.linalg.vector_norm(z1, dim=2),
                                 torch.linalg.vector_norm(z2, dim=2))
        sim = sim.reshape(b, b, -1).sum(dim=2)
        neg = (sim.sum(dim=1) - torch.diagonal(sim)) / (c ** 2 * (b - 1))
        return ((neg + 1) / 2).mean()


class Conformer3DVariance:
    def __init__(self, normalize=False):
        self.norm = normalize

    def __call__(self, z1, z2, pos_mask=None, **kw):
        z1, z2 = _t(z1), _t(z2)
        b, d = z1.shape[0], z2.shape[-1]
        z2 = z2.reshape(b, -1, d)
        if self.norm:
            z2 = z2 / torch.linalg.vector_norm(z2, dim=2, keepdim=True)
        return z2.var(dim=1).mean()


class Conformer2DVariance:
    def __init__(self, normalize=False):
        self.norm = normalize

    def __call__(self, z1, z2, pos_mask=None, **kw):
        z1, z2 = _t(z1), _t(z2)
        b, d = z1.shape[0], z2.shape[-1]
        z1 = z1.reshape(b, 2, d)
        if self.norm:
            z1 = z1 / torch.linalg.vector_norm(z1, dim=2, keepdim=True)
        return torch.exp(z1[:, 1, :]).mean()


class PositiveProb:
    def _kernel(self, z1, z2):
        z1, z2 = _t(z1), _t(z2)
        b, d = z1.shape[0], z2.shape[-1]
        z1 = z1.reshape(b, 2, d)
        mu, std = z1[:, 0, :], torch.exp(z1[:, 1, :] / 2)
        # reference quirk (metrics.py:350): conformers stacked graph-major
        z2 = z2.reshape(-1, b, d).permute(1, 0, 2)
        diff = z2[None, :, :, :] - mu[:, None, None, :]
        s = std[:, None, None, :]
        log_prob = (-0.5 * (diff / s) ** 2 - torch.log(s)
                    - 0.5 * math.log(2 * math.pi))
        return torch.exp(log_prob).mean(dim=(2, 3))

    def __call__(self, z1, z2, pos_mask=None, **kw):
        return torch.diagonal(self._kernel(z1, z2)).mean()


class NegativeProb(PositiveProb):
    def __call__(self, z1, z2, pos_mask=None, **kw):
        k = self._kernel(z1, z2)
        return (k.sum(dim=1) - torch.diagonal(k)).mean()


# ---------------------------------------------------------------------------
# host-side evaluator metrics (OGB equivalents; numpy)
# ---------------------------------------------------------------------------

def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def roc_auc_score(y_true: np.ndarray, y_score: np.ndarray) -> float:
    """Rank-based AUC (Mann-Whitney), ties handled by average ranks."""
    y_true = np.asarray(y_true).astype(np.float64)
    y_score = np.asarray(y_score).astype(np.float64)
    n_pos = (y_true == 1).sum()
    n_neg = (y_true == 0).sum()
    if n_pos == 0 or n_neg == 0:
        return float("nan")
    order = np.argsort(y_score, kind="mergesort")
    ranks = np.empty_like(order, dtype=np.float64)
    sorted_scores = y_score[order]
    i = 0
    r = 1.0
    n = len(y_score)
    while i < n:
        j = i
        while j + 1 < n and sorted_scores[j + 1] == sorted_scores[i]:
            j += 1
        ranks[order[i:j + 1]] = (r + r + (j - i)) / 2.0
        r += j - i + 1
        i = j + 1
    sum_pos = ranks[y_true == 1].sum()
    return float((sum_pos - n_pos * (n_pos + 1) / 2.0) / (n_pos * n_neg))


def average_precision_score(y_true: np.ndarray, y_score: np.ndarray) -> float:
    """AP with sklearn's grouped-threshold semantics (tied scores form one
    precision/recall point), as `ogb.graphproppred.Evaluator._eval_ap`
    computes it: AP = sum_i (R_i - R_{i-1}) * P_i over distinct-score
    thresholds in descending order."""
    y_true = np.asarray(y_true).astype(np.float64)
    y_score = np.asarray(y_score).astype(np.float64)
    n_pos = (y_true == 1).sum()
    if n_pos == 0:
        return float("nan")
    order = np.argsort(-y_score, kind="mergesort")
    yt = y_true[order]
    ys = y_score[order]
    last = np.r_[np.nonzero(np.diff(ys))[0], len(ys) - 1]
    tp = np.cumsum(yt)[last]
    precision = tp / (last + 1.0)
    recall = tp / n_pos
    return float(np.sum(np.diff(np.r_[0.0, recall]) * precision))


class OGBEvaluator:
    """OGB graph-prop evaluator equivalent (reference trainer/metrics.py:
    104-115): NaN-masked per-task rocauc / ap / rmse / mae / acc averaged
    over tasks with at least one positive and one negative label;
    `val_only` for rocauc (skipped on training batches)."""

    is_host_metric = True

    def __init__(self, d_name: str = "", metric: str = "rocauc",
                 num_tasks: int = 1):
        self.metric = metric
        self.num_tasks = num_tasks
        self.val_only = metric == "rocauc"

    def __call__(self, preds, targets, **kw):
        y_pred = _np(preds)
        y_true = _np(targets)
        if y_pred.ndim == 1:
            y_pred = y_pred[:, None]
        if y_true.ndim == 1:
            y_true = y_true[:, None]
        if y_pred.shape[1] != self.num_tasks:
            return float("nan")
        vals = []
        for t in range(y_true.shape[1]):
            mask = ~np.isnan(y_true[:, t])
            yt, yp = y_true[mask, t], y_pred[mask, t]
            if self.metric == "rmse":
                vals.append(float(np.sqrt(np.mean((yt - yp) ** 2))))
            elif self.metric == "mae":
                vals.append(float(np.mean(np.abs(yt - yp))))
            elif self.metric == "rocauc":
                if (yt == 1).any() and (yt == 0).any():
                    vals.append(roc_auc_score(yt, yp))
            elif self.metric == "ap":
                if (yt == 1).any() and (yt == 0).any():
                    vals.append(average_precision_score(yt, yp))
            elif self.metric == "acc":
                vals.append(float(np.mean((yp > 0.5) == yt)))
            else:
                raise ValueError(f"unknown OGB metric {self.metric}")
        if not vals:
            raise RuntimeError(
                "No positively labeled data available. Cannot compute metric.")
        return float(np.mean(vals))


class PCQM4MEvaluatorWrapper:
    is_host_metric = True
    val_only = False

    def __call__(self, preds, targets, **kw):
        y_pred = _np(preds).squeeze()
        y_true = _np(targets).squeeze()
        return float(np.mean(np.abs(y_pred - y_true)))
