"""The reference of model type SMP: SphereNet (Liu et al., "Spherical
Message Passing for 3D Molecular Graphs", ICLR 2022, arXiv 2102.05013) as
the 3D Infomax repository runs it (`models/spherical_message_passing.py`,
the DIG implementation with OGB atom codes), written from the published
formulas in plain PyTorch.

The view builds each molecule's radius graph from its first conformer
(every ordered pair of distinct atoms at most `cutoff` apart, edge
j -> i), the triplets k -> j -> i (an edge k -> j before an edge j -> i,
k != i), each triplet's angle at j and its torsion, the smallest dihedral
over the other in-neighbours k' != i of j, each wrapped into (0, 2 pi]
first (`xyz_to_dat`), all in float64; the model reads them in float32.

The model: the radial basis ``env(d) sin(f d)`` with the DimeNet envelope
and learned frequencies f; the spherical Bessel basis
``N_lk j_l(z_lk d)`` (j_0 .. j_{L-1} in closed form, the zeros z_lk by
bisection, N_lk = sqrt(2) / |j_{l+1}(z_lk)|) times the real spherical
harmonics Y_l^0 of the angle (``sbf``) and Y_l^m of the angle and torsion
(``t``, in the published flat order [m = 0, +1 .. +l, -l .. -1] and its
[L, L] view); the bases are evaluated in float64 and enter in float32.
Then ``init_e`` (``e1 = swish(lin([x_i ‖ x_j ‖ swish(lin_rbf_0(rbf))]))``,
``e2 = lin_rbf_1(rbf) * e1``), ``init_v``, and per block ``update_e_l``
(the triplet message ``x_kj[idx_kj] * sbf' * t'`` summed onto each edge
j -> i, the residual stacks) and ``update_v_l`` (e2 summed at each
receiver, lin_up, three swish Linears, the output Linear), each node
update summed per molecule and over the blocks.

Departures: the harness's initializers (`weights.py`) stand in for
PyG's ``glorot_orthogonal``: every Linear uniform in +-1/sqrt(fan_in),
biases too, the atom embeddings uniform; every ``update_v.lin`` and
``init_v.lin`` is drawn non-zero despite ``output_init: zeros``, so the
first step's outputs are not all zero (the comparison divides by them);
``dist_emb_freq``, published as n pi (n = 1 .. K), is drawn uniform in
+-K pi, since the harness draws or fills (0, 1) and holds no fixed
start.  State-dict names are the port's
(`infomax3d_tpu_torch/models/smp.py`)."""
from __future__ import annotations

import math
from typing import Dict, Mapping

import numpy as np
import torch
import torch.nn.functional as F

from bench_port.reference.nn import Spec, embedding_spec, linear_spec
from bench_port.reference.pna import ATOM_VOCAB

ENVELOPE_EXPONENT = 5
BEFORE_SKIP, AFTER_SKIP, OUTPUT_LAYERS = 1, 2, 3


def shape(params: Mapping) -> Dict:
    if not params.get("use_node_features", True):
        raise NotImplementedError("the reference SMP embeds atom codes")
    if int(params.get("num_spherical", 3)) > 3:
        raise NotImplementedError("the reference SMP has j_l and Y_l^m in "
                                  "closed form for l < 3")
    keys = ("hidden_channels", "target_dim", "int_emb_size",
            "basis_emb_size", "out_emb_size", "num_spherical", "num_radial",
            "propagation_depth")
    s = {k: int(params[k]) for k in keys}
    s["cutoff"] = float(params.get("cutoff", 5.0))
    for k, v in (("envelope_exponent", ENVELOPE_EXPONENT),
                 ("num_before_skip", BEFORE_SKIP),
                 ("num_after_skip", AFTER_SKIP),
                 ("num_output_layers", OUTPUT_LAYERS)):
        if int(params.get(k, v)) != v:
            raise NotImplementedError(f"the reference SMP runs {k} {v}")
    return s


def _linear(name: str, d_in: int, d_out: int, bias: bool = True) -> Spec:
    spec = linear_spec(name, d_in, d_out)
    return spec if bias else spec[:1]


def _update_v_spec(name: str, s: Mapping) -> Spec:
    H, O = s["hidden_channels"], s["out_emb_size"]
    spec = _linear(f"{name}.lin_up", H, O)
    for k in range(OUTPUT_LAYERS):
        spec += _linear(f"{name}.lins_{k}", O, O)
    return spec + _linear(f"{name}.lin", O, s["target_dim"], bias=False)


def spec(s: Mapping) -> Spec:
    H, I, B = s["hidden_channels"], s["int_emb_size"], s["basis_emb_size"]
    L, K = s["num_spherical"], s["num_radial"]
    out: Spec = [("dist_emb_freq", (K,), "uniform", K * math.pi)]
    for i, v in enumerate(ATOM_VOCAB):
        out += embedding_spec(f"init_e.emb.bond_embedding_list.{i}", v, H)
    out += _linear("init_e.lin_rbf_0", K, H)
    out += _linear("init_e.lin", 3 * H, H)
    out += _linear("init_e.lin_rbf_1", K, H, bias=False)
    out += _update_v_spec("init_v", s)
    for layer in range(s["propagation_depth"]):
        e = f"update_e_{layer}"
        out += _linear(f"{e}.lin_ji", H, H) + _linear(f"{e}.lin_kj", H, H)
        out += _linear(f"{e}.lin_rbf1", K, B, bias=False)
        out += _linear(f"{e}.lin_rbf2", B, H, bias=False)
        out += _linear(f"{e}.lin_down", H, I, bias=False)
        out += _linear(f"{e}.lin_sbf1", L * K, B, bias=False)
        out += _linear(f"{e}.lin_sbf2", B, I, bias=False)
        out += _linear(f"{e}.lin_t1", L * L * K, B, bias=False)
        out += _linear(f"{e}.lin_t2", B, I, bias=False)
        out += _linear(f"{e}.lin_up", I, H, bias=False)
        for b in range(BEFORE_SKIP):
            out += _linear(f"{e}.res_before_{b}.lin1", H, H)
            out += _linear(f"{e}.res_before_{b}.lin2", H, H)
        out += _linear(f"{e}.lin", H, H)
        for a in range(AFTER_SKIP):
            out += _linear(f"{e}.res_after_{a}.lin1", H, H)
            out += _linear(f"{e}.res_after_{a}.lin2", H, H)
        out += _linear(f"{e}.lin_rbf", K, H, bias=False)
        out += _update_v_spec(f"update_v_{layer}", s)
    return out


def _cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a x b by its components, each product rounded before the
    difference, so that a x a is exactly 0 (a fused multiply-add would
    leave the rounding of one product)."""
    a0, a1, a2 = a.unbind(-1)
    b0, b1, b2 = b.unbind(-1)
    return torch.stack([a1 * b2 - a2 * b1, a2 * b0 - a0 * b2,
                        a0 * b1 - a1 * b0], dim=-1)


def _min_torsions(pos, idx_i, idx_j, idx_k, in_ptr, in_src):
    """Each triplet's smallest dihedral, over the in-neighbours k' != i of
    j, between the planes (j -> i, j -> k) and (j -> i, j -> k'), each
    wrapped from (-pi, pi] into (0, 2 pi]: k' = k, whose planes are one,
    gives 2 pi."""
    deg = in_ptr[1:] - in_ptr[:-1]
    n_cand = deg[idx_j]
    t = torch.repeat_interleave(torch.arange(idx_j.shape[0],
                                             device=pos.device), n_cand)
    first = torch.cumsum(n_cand, 0) - n_cand
    k_n = in_src[in_ptr[idx_j][t] + torch.arange(t.shape[0],
                                                 device=pos.device)
                 - first[t]]
    keep = k_n != idx_i[t]
    t, k_n = t[keep], k_n[keep]
    pos_ji = pos[idx_i[t]] - pos[idx_j[t]]
    plane1 = _cross(pos_ji, pos[idx_k[t]] - pos[idx_j[t]])
    plane2 = _cross(pos_ji, pos[k_n] - pos[idx_j[t]])
    a = (plane1 * plane2).sum(dim=-1)
    b = (_cross(plane1, plane2) * pos_ji).sum(dim=-1) \
        / torch.linalg.vector_norm(pos_ji, dim=-1)
    tor = torch.atan2(b, a)
    tor = torch.where(tor <= 0, tor + 2 * math.pi, tor)
    return torch.full((idx_j.shape[0],), math.inf, dtype=pos.dtype,
                      device=pos.device).scatter_reduce(0, t, tor, "amin")


def view(s: Mapping, mols, device) -> Dict:
    """The molecules' radius graphs and triplets as one batch: ``atoms``
    [N, 9], ``senders`` / ``receivers`` [E] (j -> i), ``node_graph`` [N],
    ``n_graphs``, ``dist`` [E], and per triplet ``idx_kj`` / ``idx_ji``
    (its edges k -> j and j -> i), ``angle`` and ``torsion``."""
    sizes = torch.as_tensor([m["node_feat"].shape[0] for m in mols],
                            device=device)
    pos = torch.as_tensor(np.concatenate([m["conformers"][0] for m in mols]),
                          dtype=torch.float64, device=device)
    graph = torch.repeat_interleave(torch.arange(len(mols), device=device),
                                    sizes)
    N = pos.shape[0]
    d = torch.linalg.vector_norm(pos[:, None] - pos[None], dim=-1)
    pair = (graph[:, None] == graph[None]) & (d <= s["cutoff"]) & \
        ~torch.eye(N, dtype=torch.bool, device=device)
    # row-major nonzero: edges sorted by receiver i, senders ascending
    i, j = pair.nonzero(as_tuple=True)
    in_ptr = torch.zeros(N + 1, dtype=torch.long, device=device)
    in_ptr[1:] = torch.cumsum(torch.bincount(i, minlength=N), 0)
    # triplets: each edge j -> i with each edge k -> j (the in-edges of j,
    # a contiguous range), k != i
    n_in = (in_ptr[1:] - in_ptr[:-1])[j]
    ji = torch.repeat_interleave(torch.arange(i.shape[0], device=device),
                                 n_in)
    first = torch.cumsum(n_in, 0) - n_in
    kj = in_ptr[j][ji] + torch.arange(ji.shape[0], device=device) - \
        first[ji]
    keep = j[kj] != i[ji]
    ji, kj = ji[keep], kj[keep]
    idx_i, idx_j, idx_k = i[ji], j[ji], j[kj]
    pos_ji, pos_jk = pos[idx_i] - pos[idx_j], pos[idx_k] - pos[idx_j]
    angle = torch.atan2(torch.linalg.vector_norm(
        _cross(pos_ji, pos_jk), dim=-1),
        (pos_ji * pos_jk).sum(dim=-1))
    torsion = _min_torsions(pos, idx_i, idx_j, idx_k, in_ptr, j)
    atoms = torch.as_tensor(np.concatenate([m["node_feat"] for m in mols]),
                            dtype=torch.long, device=device)
    return {"atoms": atoms, "senders": j, "receivers": i,
            "node_graph": graph, "n_graphs": len(mols),
            "dist": torch.linalg.vector_norm(pos[i] - pos[j],
                                             dim=-1).float(),
            "idx_kj": kj, "idx_ji": ji, "angle": angle.float(),
            "torsion": torsion.float()}


def spherical_jn(l: int, x, sin, cos):
    """j_l(x) for l = 0 .. 3 in closed form (Abramowitz and Stegun
    10.1.11), with `sin` / `cos` of math or of torch."""
    s, c = sin(x), cos(x)
    if l == 0:
        return s / x
    if l == 1:
        return s / x ** 2 - c / x
    if l == 2:
        return (3 / x ** 3 - 1 / x) * s - 3 * c / x ** 2
    if l == 3:
        return (15 / x ** 4 - 6 / x ** 2) * s - (15 / x ** 3 - 1 / x) * c
    raise NotImplementedError(f"j_{l}")


def _bisect(f, a: float, b: float) -> float:
    fa = f(a)
    for _ in range(200):
        m = 0.5 * (a + b)
        fm = f(m)
        if m in (a, b) or fm == 0.0:
            return m
        if (fm < 0) == (fa < 0):
            a, fa = m, fm
        else:
            b = m
    return 0.5 * (a + b)


def bessel_zeros(L: int, K: int) -> np.ndarray:
    """[L, K] float64: the first K positive zeros of j_0 .. j_{L-1}; those
    of j_l lie one between each two consecutive zeros of j_{l-1}."""
    roots = [math.pi * (n + 1) for n in range(K + L - 1)]
    out = [roots[:K]]
    for l in range(1, L):
        f = lambda x, l=l: spherical_jn(l, x, math.sin, math.cos)  # noqa
        roots = [_bisect(f, a, b) for a, b in zip(roots, roots[1:])]
        out.append(roots[:K])
    return np.array(out)


def bessel_basis(d: torch.Tensor, L: int, K: int) -> torch.Tensor:
    """[E, L, K] float64: N_lk j_l(z_lk d) at the scaled distances d."""
    zeros = bessel_zeros(L, K)
    norm = np.array([[math.sqrt(2.0) / abs(spherical_jn(l + 1, z, math.sin,
                                                         math.cos))
                      for z in zeros[l]] for l in range(L)])
    x = d.double()[:, None, None] * torch.as_tensor(zeros, device=d.device)
    j = torch.stack([spherical_jn(l, x[:, l], torch.sin, torch.cos)
                     for l in range(L)], dim=1)
    return j * torch.as_tensor(norm, device=d.device)


def _prefactor(l: int, m: int) -> float:
    return math.sqrt((2 * l + 1) * math.factorial(l - abs(m))
                     / (4 * math.pi * math.factorial(l + abs(m))))


def harmonics(theta: torch.Tensor, phi=None, L: int = 3):
    """The real spherical harmonics, float64: Y_l^0(theta) for l < L
    [T, L] where `phi` is None, else every Y_l^m(theta, phi) [T, L^2] in
    the published flat order (m = 0, +1 .. +l, -l .. -1 for each l), with
    the published associated Legendre functions (no sin^m factor, sign
    (1 - 2m) per order) and cos / sin(m phi) sin^m(theta)."""
    z = torch.cos(theta)
    P = {(0, 0): torch.ones_like(z), (1, 0): z,
         (2, 0): (3 * z * z - 1) / 2, (1, 1): -torch.ones_like(z),
         (2, 1): -3 * z, (2, 2): 3 * torch.ones_like(z)}
    if phi is None:
        return torch.stack([_prefactor(l, 0) * P[(l, 0)] for l in range(L)],
                           dim=-1)
    st = torch.sin(theta)
    C = {1: st * torch.cos(phi), 2: st * st * torch.cos(2 * phi)}
    S = {1: st * torch.sin(phi), 2: st * st * torch.sin(2 * phi)}
    cols = []
    for l in range(L):
        cols.append(_prefactor(l, 0) * P[(l, 0)])
        for m in range(1, l + 1):
            cols.append(math.sqrt(2) * _prefactor(l, m) * C[m] * P[(l, m)])
        for m in range(l, 0, -1):
            cols.append(math.sqrt(2) * _prefactor(l, m) * S[m] * P[(l, m)])
    return torch.stack(cols, dim=-1)


def bases(s: Mapping, freq: torch.Tensor, g: Mapping):
    """(rbf [E, K], sbf [T, L K], t [T, L^2 K]): the radial basis in the
    model's float32 (its frequencies learn), the angular and torsion bases
    evaluated in float64 and given in float32."""
    L, K, cut = s["num_spherical"], s["num_radial"], s["cutoff"]
    d = (g["dist"] / cut)[:, None]
    p = ENVELOPE_EXPONENT + 1
    a, b, c = -(p + 1) * (p + 2) / 2, p * (p + 2), -p * (p + 1) / 2
    env = 1.0 / d + a * d ** (p - 1) + b * d ** p + c * d ** (p + 1)
    rbf = env * torch.sin(freq * d)
    bessel = bessel_basis(g["dist"] / cut, L, K)[g["idx_kj"]]   # [T, L, K]
    theta = g["angle"].double()
    sbf = bessel * harmonics(theta, L=L)[:, :, None]
    Y = harmonics(theta, g["torsion"].double(), L).reshape(-1, L, L, 1)
    t = bessel[:, None] * Y
    T = theta.shape[0]
    return rbf, sbf.reshape(T, L * K).float(), t.reshape(T, L * L * K).float()


def _dense(layers, name: str, x: torch.Tensor) -> torch.Tensor:
    """A Linear of the published model, with its bias where it has one;
    the operands rounded by the layers' `q`."""
    q, P = layers.q, layers.P
    y = q(x) @ q(P[f"{name}.weight"]).T
    bias = P.get(f"{name}.bias")
    return y if bias is None else y + bias


def _update_v(layers, name: str, e2: torch.Tensor, g: Mapping,
              N: int) -> torch.Tensor:
    v = e2.new_zeros(N, e2.shape[1]).index_add(0, g["receivers"], e2)
    v = _dense(layers, f"{name}.lin_up", v)
    for k in range(OUTPUT_LAYERS):
        v = F.silu(_dense(layers, f"{name}.lins_{k}", v))
    v = _dense(layers, f"{name}.lin", v)
    return v.new_zeros(g["n_graphs"], v.shape[1]).index_add(
        0, g["node_graph"], v)


def _residual(layers, name: str, x: torch.Tensor) -> torch.Tensor:
    h = F.silu(_dense(layers, f"{name}.lin1", x))
    return x + F.silu(_dense(layers, f"{name}.lin2", h))


def _update_e(layers, name: str, e1: torch.Tensor, rbf, sbf, t,
              g: Mapping) -> tuple:
    x_ji = F.silu(_dense(layers, f"{name}.lin_ji", e1))
    x_kj = F.silu(_dense(layers, f"{name}.lin_kj", e1))
    x_kj = x_kj * _dense(layers, f"{name}.lin_rbf2",
                         _dense(layers, f"{name}.lin_rbf1", rbf))
    x_kj = F.silu(_dense(layers, f"{name}.lin_down", x_kj))
    x_kj = x_kj[g["idx_kj"]] * _dense(layers, f"{name}.lin_sbf2",
                                      _dense(layers, f"{name}.lin_sbf1",
                                             sbf))
    x_kj = x_kj * _dense(layers, f"{name}.lin_t2",
                         _dense(layers, f"{name}.lin_t1", t))
    x_kj = x_kj.new_zeros(e1.shape[0], x_kj.shape[1]).index_add(
        0, g["idx_ji"], x_kj)
    h = x_ji + F.silu(_dense(layers, f"{name}.lin_up", x_kj))
    for b in range(BEFORE_SKIP):
        h = _residual(layers, f"{name}.res_before_{b}", h)
    h = F.silu(_dense(layers, f"{name}.lin", h)) + e1
    for a in range(AFTER_SKIP):
        h = _residual(layers, f"{name}.res_after_{a}", h)
    return h, _dense(layers, f"{name}.lin_rbf", rbf) * h


def forward(s: Mapping, layers, g: Mapping) -> torch.Tensor:
    """[n_graphs, target_dim]: the node updates summed per molecule and
    over ``init_v`` and the blocks."""
    N = g["atoms"].shape[0]
    rbf, sbf, t = bases(s, layers.P["dist_emb_freq"], g)
    x = sum(layers.embed(f"init_e.emb.bond_embedding_list.{i}",
                         g["atoms"][:, i]) for i in range(len(ATOM_VOCAB)))
    rbf0 = F.silu(_dense(layers, "init_e.lin_rbf_0", rbf))
    e1 = F.silu(_dense(layers, "init_e.lin", torch.cat(
        [x[g["receivers"]], x[g["senders"]], rbf0], dim=-1)))
    e2 = _dense(layers, "init_e.lin_rbf_1", rbf) * e1
    u = _update_v(layers, "init_v", e2, g, N)
    for layer in range(s["propagation_depth"]):
        e1, e2 = _update_e(layers, f"update_e_{layer}", e1, rbf, sbf, t, g)
        u = u + _update_v(layers, f"update_v_{layer}", e2, g, N)
    return u
