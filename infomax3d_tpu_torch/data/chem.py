"""Minimal pure-Python chemistry kernel (host-side data prep; port of
`infomax3d_tpu/data/chem.py`, line for line).

RDKit is the preferred featurizer when installed (data/preprocess.py uses it
first); this module provides a dependency-free fallback covering the organic
subset so that the reference's SMILES-driven protocol surface —
`InferenceDataset` (reference datasets/inference_dataset.py:23-100) and the
SDF-based QM9/QMugs preprocessing (reference datasets/qm9_dataset.py:392-446)
— runs in environments without RDKit.

Scope & documented deviations vs RDKit perception:
* organic-subset + bracket atoms, rings (incl. %nn), branches, charges,
  aromatic lowercase notation; no stereo bonds (/ \\ parsed, ignored), no
  reaction/multi-component SMILES.
* implicit hydrogens from OpenSMILES default valences (aromatic bond = 1.5).
* ring membership exact (bridge detection); ring-size queries exact (BFS).
* hybridization is a heuristic (aromatic/double -> SP2, triple/cumulated
  -> SP, else SP3) — RDKit uses full valence-model perception.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

# OpenSMILES organic subset + common bracket atoms
_ORGANIC = {"B": 3, "C": 4, "N": 3, "O": 2, "P": 3, "S": 2,
            "F": 1, "Cl": 1, "Br": 1, "I": 1}
_DEFAULT_VALENCE = dict(_ORGANIC, **{"H": 1, "Si": 4, "Se": 2, "As": 3,
                                     "Te": 2, "Na": 1, "K": 1, "Li": 1,
                                     "Mg": 2, "Ca": 2, "Zn": 2, "Fe": 2})
_SYMBOLS = ["H", "He", "Li", "Be", "B", "C", "N", "O", "F", "Ne", "Na", "Mg",
            "Al", "Si", "P", "S", "Cl", "Ar", "K", "Ca", "Sc", "Ti", "V",
            "Cr", "Mn", "Fe", "Co", "Ni", "Cu", "Zn", "Ga", "Ge", "As", "Se",
            "Br", "Kr", "Rb", "Sr", "Y", "Zr", "Nb", "Mo", "Tc", "Ru", "Rh",
            "Pd", "Ag", "Cd", "In", "Sn", "Sb", "Te", "I", "Xe", "Cs", "Ba",
            "La", "Ce", "Pr", "Nd", "Pm", "Sm", "Eu", "Gd", "Tb", "Dy", "Ho",
            "Er", "Tm", "Yb", "Lu", "Hf", "Ta", "W", "Re", "Os", "Ir", "Pt",
            "Au", "Hg", "Tl", "Pb", "Bi"]
ATOMIC_NUM = {s: i + 1 for i, s in enumerate(_SYMBOLS)}


@dataclass
class Atom:
    symbol: str
    charge: int = 0
    aromatic: bool = False
    explicit_h: Optional[int] = None   # from bracket, else implicit rule
    chiral: int = 0                    # 0 none, 1 @, 2 @@
    coords: Optional[Tuple[float, float, float]] = None


@dataclass
class Bond:
    a: int
    b: int
    order: float = 1.0                 # 1, 2, 3; 1.5 = aromatic
    aromatic: bool = False


@dataclass
class Mol:
    atoms: List[Atom] = field(default_factory=list)
    bonds: List[Bond] = field(default_factory=list)

    # -------------------------------------------------------------- derived
    def neighbors(self) -> List[List[int]]:
        nbr: List[List[int]] = [[] for _ in self.atoms]
        for k, b in enumerate(self.bonds):
            nbr[b.a].append(k)
            nbr[b.b].append(k)
        return nbr

    def implicit_h(self, i: int) -> int:
        a = self.atoms[i]
        if a.explicit_h is not None:
            return a.explicit_h
        if a.symbol not in _ORGANIC:
            return 0
        order = sum(b.order for k, b in enumerate(self.bonds)
                    if b.a == i or b.b == i)
        val = _DEFAULT_VALENCE[a.symbol]
        # N/P/S hypervalent escalation (OpenSMILES: 3,5 / 2,4,6)
        cands = {"N": (3, 5), "P": (3, 5), "S": (2, 4, 6)}.get(a.symbol,
                                                               (val,))
        for v in cands:
            if v + a.charge >= order - 1e-6:
                return int(np.floor(v + a.charge - order + 1e-6))
        return 0

    def ring_bond_mask(self) -> List[bool]:
        """Exact: a bond is in a ring iff it is not a bridge (iterative
        DFS low-link)."""
        n = len(self.atoms)
        adj: List[List[Tuple[int, int]]] = [[] for _ in range(n)]
        for k, b in enumerate(self.bonds):
            adj[b.a].append((b.b, k))
            adj[b.b].append((b.a, k))
        visited = [False] * n
        tin = [0] * n
        low = [0] * n
        is_bridge = [False] * len(self.bonds)
        timer = [0]
        for root in range(n):
            if visited[root]:
                continue
            stack = [(root, -1, iter(adj[root]))]
            visited[root] = True
            tin[root] = low[root] = timer[0]
            timer[0] += 1
            while stack:
                v, pe, it = stack[-1]
                advanced = False
                for to, k in it:
                    if k == pe:
                        continue
                    if visited[to]:
                        low[v] = min(low[v], tin[to])
                    else:
                        visited[to] = True
                        tin[to] = low[to] = timer[0]
                        timer[0] += 1
                        stack.append((to, k, iter(adj[to])))
                        advanced = True
                        break
                if not advanced:
                    stack.pop()
                    if stack:
                        pv = stack[-1][0]
                        low[pv] = min(low[pv], low[v])
                        if low[v] > tin[pv]:
                            is_bridge[pe] = True
            # multigraph parallel edges are never bridges
        counts: Dict[Tuple[int, int], int] = {}
        for b in self.bonds:
            key = (min(b.a, b.b), max(b.a, b.b))
            counts[key] = counts.get(key, 0) + 1
        return [(not is_bridge[k]) or
                counts[(min(b.a, b.b), max(b.a, b.b))] > 1
                for k, b in enumerate(self.bonds)]

    def ring_atom_mask(self) -> List[bool]:
        mask = [False] * len(self.atoms)
        rb = self.ring_bond_mask()
        for k, b in enumerate(self.bonds):
            if rb[k]:
                mask[b.a] = mask[b.b] = True
        return mask

    def hybridization(self, i: int) -> str:
        a = self.atoms[i]
        orders = [b.order for b in self.bonds if b.a == i or b.b == i]
        if a.aromatic or any(o == 1.5 for o in orders):
            return "SP2"
        n_double = sum(1 for o in orders if o == 2)
        n_triple = sum(1 for o in orders if o == 3)
        if n_triple or n_double >= 2:
            return "SP"
        if n_double:
            return "SP2"
        return "SP3"


# ---------------------------------------------------------------------------
# SMILES parser
# ---------------------------------------------------------------------------

class SmilesError(ValueError):
    pass


def parse_smiles(s: str) -> Mol:
    mol = Mol()
    prev: List[Optional[int]] = [None]     # branch stack of previous atoms
    pending_order: Optional[float] = None
    ring: Dict[int, Tuple[int, Optional[float]]] = {}
    i = 0
    n = len(s)

    def add_atom(atom: Atom) -> int:
        mol.atoms.append(atom)
        idx = len(mol.atoms) - 1
        p = prev[-1]
        if p is not None:
            _bond(p, idx)
        prev[-1] = idx
        return idx

    def _bond(a: int, b: int, order: Optional[float] = None):
        nonlocal pending_order
        o = order if order is not None else pending_order
        if o is None:
            o = 1.5 if (mol.atoms[a].aromatic and mol.atoms[b].aromatic) \
                else 1.0
        mol.bonds.append(Bond(a, b, o, aromatic=(o == 1.5)))
        pending_order = None

    def ring_closure(num: int):
        nonlocal pending_order
        cur = prev[-1]
        if cur is None:
            raise SmilesError(f"ring digit before any atom in {s!r}")
        if num in ring:
            other, o_open = ring.pop(num)
            o = pending_order if pending_order is not None else o_open
            _bond(other, cur, o)
        else:
            ring[num] = (cur, pending_order)
            pending_order = None

    while i < n:
        c = s[i]
        if c == "[":
            j = s.index("]", i)
            add_atom(_parse_bracket(s[i + 1:j]))
            i = j + 1
        elif c in "BCNOPSFI" or s[i:i + 2] in ("Cl", "Br"):
            sym = s[i:i + 2] if s[i:i + 2] in ("Cl", "Br") else c
            add_atom(Atom(symbol=sym))
            i += len(sym)
        elif c in "bcnops":
            add_atom(Atom(symbol=c.upper(), aromatic=True))
            i += 1
        elif c in "-=#:~/\\":
            pending_order = {"-": 1.0, "=": 2.0, "#": 3.0, ":": 1.5,
                             "~": 1.0, "/": 1.0, "\\": 1.0}[c]
            i += 1
        elif c == "(":
            prev.append(prev[-1])
            i += 1
        elif c == ")":
            prev.pop()
            i += 1
        elif c.isdigit():
            ring_closure(int(c))
            i += 1
        elif c == "%":
            ring_closure(int(s[i + 1:i + 3]))
            i += 3
        elif c == ".":
            prev[-1] = None
            i += 1
        elif c in " \t":
            break
        else:
            raise SmilesError(f"unexpected {c!r} at {i} in {s!r}")
    if ring:
        raise SmilesError(f"unclosed ring bond(s) {sorted(ring)} in {s!r}")
    return mol


def _parse_bracket(body: str) -> Atom:
    i = 0
    while i < len(body) and body[i].isdigit():        # isotope, ignored
        i += 1
    if i < len(body) and body[i].islower() and body[i] in "bcnops":
        atom = Atom(symbol=body[i].upper(), aromatic=True)
        i += 1
    else:
        j = i + 1
        if j < len(body) and body[j].islower() and \
                body[i:j + 1].capitalize() in ATOMIC_NUM:
            j += 1
        atom = Atom(symbol=body[i:j].capitalize())
        i = j
    atom.explicit_h = 0
    while i < len(body):
        c = body[i]
        if c == "@":
            if body[i:i + 2] == "@@":
                atom.chiral = 2
                i += 2
            else:
                atom.chiral = 1
                i += 1
        elif c == "H":
            cnt = ""
            i += 1
            while i < len(body) and body[i].isdigit():
                cnt += body[i]
                i += 1
            atom.explicit_h = int(cnt) if cnt else 1
        elif c in "+-":
            sign = 1 if c == "+" else -1
            i += 1
            cnt = ""
            while i < len(body) and body[i].isdigit():
                cnt += body[i]
                i += 1
            if cnt:
                atom.charge += sign * int(cnt)
            else:
                atom.charge += sign
                while i < len(body) and body[i] == c:  # ++ / -- runs
                    atom.charge += sign
                    i += 1
        else:
            i += 1
    return atom


# ---------------------------------------------------------------------------
# SDF (V2000 molfile) parser
# ---------------------------------------------------------------------------

def parse_sdf(text: str) -> List[Tuple[Mol, Dict[str, str]]]:
    """Parse a multi-record V2000 SDF string into (Mol, properties) pairs.
    Aromaticity: molfile bond type 4; charges from M  CHG lines."""
    out = []
    for rec in text.split("$$$$"):
        lines = rec.strip("\n").split("\n")
        if len(lines) < 4:
            continue
        counts = lines[3]
        try:
            na, nb = int(counts[0:3]), int(counts[3:6])
        except ValueError:
            continue
        mol = Mol()
        for k in range(na):
            ln = lines[4 + k]
            x, y, z = float(ln[0:10]), float(ln[10:20]), float(ln[20:30])
            sym = ln[31:34].strip()
            mol.atoms.append(Atom(symbol=sym, coords=(x, y, z)))
        for k in range(nb):
            ln = lines[4 + na + k]
            a, b = int(ln[0:3]) - 1, int(ln[3:6]) - 1
            t = int(ln[6:9])
            order = {1: 1.0, 2: 2.0, 3: 3.0, 4: 1.5}.get(t, 1.0)
            mol.bonds.append(Bond(a, b, order, aromatic=(t == 4)))
            if t == 4:
                mol.atoms[a].aromatic = True
                mol.atoms[b].aromatic = True
        props: Dict[str, str] = {}
        i = 4 + na + nb
        while i < len(lines):
            ln = lines[i]
            if ln.startswith("M  CHG"):
                parts = ln.split()
                cnt = int(parts[2])
                for c in range(cnt):
                    idx = int(parts[3 + 2 * c]) - 1
                    mol.atoms[idx].charge = int(parts[4 + 2 * c])
            elif ln.startswith(">"):
                name = ln.split("<")[-1].rstrip(">").strip() if "<" in ln \
                    else ln[1:].strip()
                vals = []
                i += 1
                while i < len(lines) and lines[i].strip() != "":
                    vals.append(lines[i])
                    i += 1
                props[name] = "\n".join(vals)
            i += 1
        out.append((mol, props))
    return out


# ---------------------------------------------------------------------------
# OGB featurization (matches data/preprocess.py tables)
# ---------------------------------------------------------------------------

def mol_to_graph_arrays(mol: Mol) -> Dict[str, np.ndarray]:
    """Mol -> the flat per-molecule dict the collates consume (OGB atom codes
    [N,9], bond codes [E,3], both edge directions, coords when present) —
    pure-Python equivalent of preprocess.mol_to_arrays (RDKit path)."""
    from infomax3d_tpu_torch.data.preprocess import (
        ATOM_CHIRALITY, BOND_STEREO, BOND_TYPES, HYBRIDIZATIONS, _idx,
    )
    n = len(mol.atoms)
    ring_atoms = mol.ring_atom_mask()
    ring_bonds = mol.ring_bond_mask()
    nbr = mol.neighbors()
    feats = []
    for i, a in enumerate(mol.atoms):
        n_h = mol.implicit_h(i) + sum(
            1 for k in nbr[i]
            for j in (mol.bonds[k].a, mol.bonds[k].b)
            if j != i and mol.atoms[j].symbol == "H")
        total_deg = len(nbr[i]) + mol.implicit_h(i)
        chir = {0: "CHI_UNSPECIFIED", 1: "CHI_TETRAHEDRAL_CCW",
                2: "CHI_TETRAHEDRAL_CW"}[a.chiral]
        feats.append([
            min(ATOMIC_NUM.get(a.symbol, 119) - 1, 118),
            _idx(ATOM_CHIRALITY, chir),
            min(total_deg, 11),
            min(a.charge + 5, 11),
            min(n_h, 9),
            0,                                    # radical electrons
            _idx(HYBRIDIZATIONS, mol.hybridization(i)),
            int(a.aromatic),
            int(ring_atoms[i]),
        ])
    node_feat = np.asarray(feats, np.int32).reshape(n, 9)
    src, dst, ef = [], [], []
    for k, b in enumerate(mol.bonds):
        bt = {1.0: "SINGLE", 2.0: "DOUBLE", 3.0: "TRIPLE",
              1.5: "AROMATIC"}.get(b.order, "misc")
        f = [_idx(BOND_TYPES, bt), _idx(BOND_STEREO, "STEREONONE"),
             int(b.aromatic)]          # conjugation approximated by aromatic
        src += [b.a, b.b]
        dst += [b.b, b.a]
        ef += [f, f]
    out = dict(node_feat=node_feat,
               senders=np.asarray(src, np.int32),
               receivers=np.asarray(dst, np.int32),
               edge_feat=np.asarray(ef, np.int32).reshape(len(src), 3))
    if all(a.coords is not None for a in mol.atoms) and n:
        out["coords"] = np.asarray([a.coords for a in mol.atoms], np.float32)
    return out


def smiles_to_graph(smiles: str) -> Dict[str, np.ndarray]:
    """SMILES -> per-molecule graph dict (InferenceDataset equivalent,
    reference datasets/inference_dataset.py:36-60)."""
    return mol_to_graph_arrays(parse_smiles(smiles))
