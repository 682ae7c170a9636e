"""Host-side featurization helpers (port of `infomax3d_tpu/data/featurize.py`:
Laplacian PE and its sign augmentation).

`laplacian_pe` replicates the reference's eigendecomposition EXACTLY,
including its broadcasting quirk (`datasets/qm9_dataset.py:403-419`):
``L_sym = I - N * L * N`` in torch broadcasts the degree vector over the
LAST axis twice, i.e. ``L_sym = I - (D - A) * (deg^-1)[None, :]`` — not the
textbook symmetric normalization.  Row-wise (per-node) L2 normalization of
the eigenvector matrix and NaN padding are likewise preserved.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np


def laplacian_pe(senders: np.ndarray, receivers: np.ndarray, n_atoms: int,
                 max_freqs: int = 10) -> Tuple[np.ndarray, np.ndarray]:
    """Returns (eig_vals [max_freqs], eig_vecs [n_atoms, max_freqs]) padded
    with NaN beyond n_atoms frequencies."""
    adj = np.zeros((n_atoms, n_atoms), dtype=np.float64)
    adj[senders, receivers] = 1.0
    deg = adj.sum(axis=0)
    L = np.diag(deg) - adj
    n_inv_sqrt = deg.astype(np.float64) ** -0.5
    n_inv_sqrt[~np.isfinite(n_inv_sqrt)] = 0.0
    # torch `N * L * N` broadcasting quirk: multiplies columns by deg^-1
    l_sym = np.eye(n_atoms) - L * (n_inv_sqrt ** 2)[None, :]
    eig_vals, eig_vecs = np.linalg.eigh(l_sym)
    order = np.argsort(eig_vals)[:max_freqs]
    eig_vals, eig_vecs = eig_vals[order], eig_vecs[:, order]
    eig_vecs = eig_vecs[:, np.argsort(eig_vals)]
    norms = np.linalg.norm(eig_vecs, axis=1, keepdims=True)
    eig_vecs = eig_vecs / np.maximum(norms, 1e-12)
    k = eig_vals.shape[0]
    if k < max_freqs:
        eig_vecs = np.pad(eig_vecs, ((0, 0), (0, max_freqs - k)),
                          constant_values=np.nan)
        eig_vals = np.pad(eig_vals, (0, max_freqs - k),
                          constant_values=np.nan)
    return eig_vals.astype(np.float32), eig_vecs.astype(np.float32)


def lap_pe_node_array(senders, receivers, n_atoms, max_freqs=10) -> np.ndarray:
    """Per-node [n, k, 2] (eigval, eigvec) stack — the `pos_enc` layout of the
    reference san_graph (`datasets/qm9_dataset.py:288-293`)."""
    vals, vecs = laplacian_pe(senders, receivers, n_atoms, max_freqs)
    vals_rep = np.broadcast_to(vals[None, :], (n_atoms, max_freqs))
    return np.stack([vals_rep, vecs], axis=-1)


def random_sign_flip(lap_pe: np.ndarray, rng: np.random.Generator) -> np.ndarray:
    """Eigenvector sign augmentation at load time (qm9_dataset.py:288-291)."""
    k = lap_pe.shape[1]
    signs = np.where(rng.random(k) >= 0.5, 1.0, -1.0).astype(np.float32)
    out = lap_pe.copy()
    out[:, :, 1] = out[:, :, 1] * signs[None, :]
    return out
