"""Spherical message-passing bases (the port's own copy of
`infomax3d_tpu/ops/spherical.py`; reference `commons/spherical_encoding.py:
21-273`): DimeNet++ / SphereNet radial, angular and torsion bases.

The reference lambdifies sympy formulas per call; the JAX package
evaluates the same functions with numeric recurrences (spherical Bessel
j_l upward with a small-x series, Legendre and associated Legendre), and
so does this module, in PyTorch, with the JAX package's constants and
dtype rules: the Bessel zeros and normalisers come from scipy on the
host (float64, cached) and enter as float32 tensors, so under the bf16
recipe the bases that use them (`bessel_rbf`, `angle_emb`,
`torsion_emb`) come out in float32 while `dist_emb` stays in the
distances' dtype, as in JAX.
"""
from __future__ import annotations

import functools
import math

import numpy as np
import torch


@functools.lru_cache(maxsize=None)
def bessel_zeros(n: int, k: int) -> np.ndarray:
    """First k positive zeros of spherical Bessel j_0..j_{n-1}
    (reference Jn_zeros, spherical_encoding.py:25-37)."""
    from scipy import special as sp
    from scipy.optimize import brentq

    def Jn(r, order):
        return np.sqrt(np.pi / (2 * r)) * sp.jv(order + 0.5, r)

    zerosj = np.zeros((n, k), dtype="float64")
    zerosj[0] = np.arange(1, k + 1) * np.pi
    points = np.arange(1, k + n) * np.pi
    racines = np.zeros(k + n - 1, dtype="float64")
    for i in range(1, n):
        for j in range(k + n - 1 - i):
            racines[j] = brentq(Jn, points[j], points[j + 1], (i,))
        points = racines.copy()
        zerosj[i][:k] = racines[:k]
    return zerosj


@functools.lru_cache(maxsize=None)
def bessel_normalizers(n: int, k: int) -> np.ndarray:
    from scipy import special as sp
    zeros = bessel_zeros(n, k)

    def Jn(r, order):
        return np.sqrt(np.pi / (2 * r)) * sp.jv(order + 0.5, r)

    norm = np.zeros((n, k))
    for order in range(n):
        for i in range(k):
            norm[order, i] = 1.0 / np.sqrt(0.5 * Jn(zeros[order, i], order + 1) ** 2)
    return norm


def _f32(a, like: torch.Tensor) -> torch.Tensor:
    """A host constant as a float32 tensor on `like`'s device (the JAX
    package's ``jnp.asarray`` of it with x64 off)."""
    return torch.as_tensor(np.asarray(a), dtype=torch.float32,
                           device=like.device)


def spherical_jn(x: torch.Tensor, n_max: int) -> torch.Tensor:
    """j_0..j_{n_max-1}(x) stacked on the last axis: upward recurrence
    j_{l+1} = (2l+1)/x * j_l - j_{l-1}, with a small-x Taylor fallback
    (the recurrence loses precision for x << l)."""
    x = torch.where(x.abs() < 1e-8, 1e-8, x)
    j0 = torch.sin(x) / x
    out = [j0]
    if n_max > 1:
        j1 = torch.sin(x) / x ** 2 - torch.cos(x) / x
        out.append(j1)
        for l in range(1, n_max - 1):
            out.append((2 * l + 1) / x * out[l] - out[l - 1])
    stacked = torch.stack(out, dim=-1)
    if n_max > 2:
        # series: j_l(x) ~ x^l / (2l+1)!! * (1 - x^2/(2(2l+3)))
        series = []
        for l in range(n_max):
            dfact = float(np.prod(np.arange(2 * l + 1, 0, -2)))
            series.append(x ** l / dfact * (1 - x * x / (2 * (2 * l + 3))))
        series = torch.stack(series, dim=-1)
        stacked = torch.where(x[..., None] < 0.5, series, stacked)
    return stacked


def legendre_p(z: torch.Tensor, l_max: int) -> torch.Tensor:
    """P_0..P_{l_max-1}(z) stacked on the last axis."""
    out = [torch.ones_like(z)]
    if l_max > 1:
        out.append(z)
        for l in range(2, l_max):
            out.append(((2 * l - 1) * z * out[l - 1] - (l - 1) * out[l - 2]) / l)
    return torch.stack(out, dim=-1)


def assoc_legendre(z: torch.Tensor, l_max: int):
    """P_l^m(z) for 0<=m<=l<l_max as dict[(l,m)] using the reference's
    recurrences (no Condon-Shortley beyond the (1-2m) factor it uses; no
    sin(theta)^m factor, as in the reference)."""
    P = {(0, 0): torch.ones_like(z)}
    if l_max > 1:
        P[(1, 0)] = z
        for l in range(2, l_max):
            P[(l, 0)] = ((2 * l - 1) * z * P[(l - 1, 0)] -
                         (l - 1) * P[(l - 2, 0)]) / l
        for m in range(1, l_max):
            P[(m, m)] = (1 - 2 * m) * P[(m - 1, m - 1)]
            if m + 1 < l_max:
                P[(m + 1, m)] = (2 * m + 1) * z * P[(m, m)]
            for l in range(m + 2, l_max):
                P[(l, m)] = ((2 * l - 1) * z * P[(l - 1, m)] -
                             (l + m - 1) * P[(l - 2, m)]) / (l - m)
    return P


def sph_harm_prefactor(l: int, m: int) -> float:
    return math.sqrt((2 * l + 1) * math.factorial(l - abs(m)) /
                     (4 * math.pi * math.factorial(l + abs(m))))


def real_sph_harm_m0(theta: torch.Tensor, l_max: int) -> torch.Tensor:
    """Y_l^0(theta) for l<l_max: prefactor * P_l(cos theta)."""
    P = legendre_p(torch.cos(theta), l_max)
    return P * _f32([sph_harm_prefactor(l, 0) for l in range(l_max)], P)


def real_sph_harm_full(theta: torch.Tensor, phi: torch.Tensor,
                       l_max: int) -> torch.Tensor:
    """All real Y_l^m for |m|<=l<l_max, float32 [..., l_max, 2*l_max-1]
    with m offset by l (entries for |m|>l are zero) — the reference's
    real_sph_harm with zero_m_only=False, in its x / y recurrence for
    cos / sin(m phi) sin(theta)^m."""
    ct, st = torch.cos(theta), torch.sin(theta)
    P = assoc_legendre(ct, l_max)
    x = st * torch.cos(phi)
    y = st * torch.sin(phi)
    C = [torch.ones_like(x)]
    S = [torch.zeros_like(x)]
    for m in range(1, l_max):
        S.append(x * S[m - 1] + y * C[m - 1])
        C.append(x * C[m - 1] - y * S[m - 1])
    out = torch.zeros(theta.shape + (l_max, 2 * l_max - 1),
                      dtype=torch.float32, device=theta.device)
    for l in range(l_max):
        out[..., l, l_max - 1] = sph_harm_prefactor(l, 0) * P[(l, 0)]
        for m in range(1, l + 1):
            out[..., l, l_max - 1 + m] = (
                math.sqrt(2) * sph_harm_prefactor(l, m) * C[m] * P[(l, m)])
            out[..., l, l_max - 1 - m] = (
                math.sqrt(2) * sph_harm_prefactor(l, -m) * S[m] * P[(l, m)])
    return out


def envelope(x: torch.Tensor, exponent: int) -> torch.Tensor:
    """Smooth cutoff envelope (reference Envelope, spherical_encoding.py:159-172)."""
    p = exponent + 1
    a = -(p + 1) * (p + 2) / 2
    b = p * (p + 2)
    c = -p * (p + 1) / 2
    xp0 = x ** (p - 1)
    return 1.0 / x + a * xp0 + b * xp0 * x + c * xp0 * x * x


def dist_emb(dist: torch.Tensor, freq: torch.Tensor, cutoff: float,
             envelope_exponent: int) -> torch.Tensor:
    """Radial Bessel embedding with learned frequencies (dist_emb.forward)."""
    d = (dist / cutoff)[..., None]
    return envelope(d, envelope_exponent) * torch.sin(freq * d)


def bessel_rbf(dist_scaled: torch.Tensor, num_spherical: int,
               num_radial: int) -> torch.Tensor:
    """Normalized spherical-Bessel basis rbf[l, n](d), float32 [..., L, K]
    (the sympy bessel_basis evaluated numerically)."""
    zeros = _f32(bessel_zeros(num_spherical, num_radial), dist_scaled)
    norm = _f32(bessel_normalizers(num_spherical, num_radial), dist_scaled)
    x = dist_scaled[..., None, None] * zeros                         # [..., L, K]
    j = torch.stack([spherical_jn(x[..., l, :], num_spherical)[..., l]
                     for l in range(num_spherical)], dim=-2)         # [..., L, K]
    return j * norm


def _rows(rbf: torch.Tensor, idx_kj: torch.Tensor) -> torch.Tensor:
    """``rbf[idx_kj]`` with ids clipped into range (padding triplets read
    the last edge; their rows are masked)."""
    return rbf[idx_kj.clamp(0, rbf.shape[0] - 1).long()]


def angle_emb(dist: torch.Tensor, angle: torch.Tensor, idx_kj: torch.Tensor,
              num_spherical: int, num_radial: int,
              cutoff: float) -> torch.Tensor:
    """[T, num_spherical*num_radial] angular basis (angle_emb.forward)."""
    rbf = bessel_rbf(dist / cutoff, num_spherical, num_radial)       # [E, L, K]
    cbf = real_sph_harm_m0(angle, num_spherical)                     # [T, L]
    out = _rows(rbf, idx_kj) * cbf[..., None]
    return out.reshape(out.shape[0], num_spherical * num_radial)


def torsion_emb(dist: torch.Tensor, angle: torch.Tensor, phi: torch.Tensor,
                idx_kj: torch.Tensor, num_spherical: int, num_radial: int,
                cutoff: float) -> torch.Tensor:
    """[T, num_spherical^2*num_radial] torsion basis (torsion_emb.forward).
    The reference stores the 2l+1 harmonics of each l as [m=0, +1..+l,
    -l..-1] and views the L^2 of them as [L, L]; this is its flat order."""
    rbf = bessel_rbf(dist / cutoff, num_spherical, num_radial)       # [E, L, K]
    full = real_sph_harm_full(angle, phi, num_spherical)             # [T, L, 2L-1]
    L = num_spherical
    cols = [full[..., 0, L - 1]]                                     # Y_0^0
    for l in range(1, L):
        for m in list(range(0, l + 1)) + list(range(-l, 0)):
            cols.append(full[..., l, L - 1 + m])
    cbf = torch.stack(cols, dim=-1)                                  # [T, L^2]
    T = cbf.shape[0]
    out = _rows(rbf, idx_kj)[:, None, :, :] * cbf.reshape(T, L, L, 1)
    return out.reshape(T, L * L * num_radial)
