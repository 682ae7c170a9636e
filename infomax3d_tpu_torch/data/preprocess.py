"""Dataset preprocessing: raw chemistry files -> the flat .npz cache
(port of `infomax3d_tpu/data/preprocess.py`; reference
`datasets/qm9_dataset.py:370-471`, `qmugs_dataset.py:230-315`).

Host-side data PREP, numpy and the standard library.  QM9 and plain SDF
files go through RDKit when it can be imported, else through the
dependency-free V2000 parser (`data/sdf.py`):

  python -m infomax3d_tpu_torch.data.preprocess qm9 --raw dataset/QM9/raw \
      --out dataset/QM9/processed.npz

SMILES and GEOM pickles need RDKit (`main` exits with a message without
it).  The cache layout matches the reference's processed tensors: flat
contiguous ``atom_features [ΣN, 9]`` (OGB codes), ``edge_features [ΣE, 3]``,
``edge_indices [2, ΣE]`` (both directions), ``coordinates`` ([ΣN, 3] or
[ΣN, C, 3]), ``targets``, plus ``atom_slices`` / ``edge_slices``.  The
training CLI reads it from ``$INFOMAX3D_DATA/<set>/processed.npz``.
"""
from __future__ import annotations

import argparse
import os
from typing import Dict, List, Optional

import numpy as np

# OGB-compatible featurization tables (ogb.utils.features); hardcoded so the
# prep also works from plain RDKit without ogb installed
ATOM_CHIRALITY = ["CHI_UNSPECIFIED", "CHI_TETRAHEDRAL_CW",
                  "CHI_TETRAHEDRAL_CCW", "CHI_OTHER", "misc"]
HYBRIDIZATIONS = ["SP", "SP2", "SP3", "SP3D", "SP3D2", "misc"]
BOND_TYPES = ["SINGLE", "DOUBLE", "TRIPLE", "AROMATIC", "misc"]
BOND_STEREO = ["STEREONONE", "STEREOZ", "STEREOE", "STEREOCIS",
               "STEREOTRANS", "STEREOANY"]


def _idx(lst, val):
    try:
        return lst.index(val)
    except ValueError:
        return len(lst) - 1


def atom_features(atom) -> List[int]:
    """OGB atom_to_feature_vector equivalent."""
    return [
        min(atom.GetAtomicNum() - 1, 118),
        _idx(ATOM_CHIRALITY, str(atom.GetChiralTag())),
        min(atom.GetTotalDegree(), 11),
        min(atom.GetFormalCharge() + 5, 11),
        min(atom.GetTotalNumHs(), 9),
        min(atom.GetNumRadicalElectrons(), 5),
        _idx(HYBRIDIZATIONS, str(atom.GetHybridization())),
        int(atom.GetIsAromatic()),
        int(atom.IsInRing()),
    ]


def bond_features(bond) -> List[int]:
    return [
        _idx(BOND_TYPES, str(bond.GetBondType())),
        min(int(bond.GetStereo()), 5),
        int(bond.GetIsConjugated()),
    ]


def mol_to_arrays(mol, num_conformers: int = 1) -> Optional[Dict[str, np.ndarray]]:
    if mol is None:
        return None
    n = mol.GetNumAtoms()
    if n == 0:
        return None
    af = np.array([atom_features(a) for a in mol.GetAtoms()], np.int32)
    src, dst, bf = [], [], []
    for b in mol.GetBonds():
        i, j = b.GetBeginAtomIdx(), b.GetEndAtomIdx()
        f = bond_features(b)
        src += [i, j]
        dst += [j, i]
        bf += [f, f]
    coords = None
    confs = mol.GetConformers()
    if confs:
        if num_conformers > 1:
            cs = [np.asarray(c.GetPositions(), np.float32)
                  for c in confs[:num_conformers]]
            while len(cs) < num_conformers:
                cs.append(cs[-1])
            coords = np.stack(cs, axis=1)           # [n, C, 3]
        else:
            coords = np.asarray(confs[0].GetPositions(), np.float32)
    return dict(atom_features=af,
                edge_index=np.array([src, dst], np.int64).reshape(2, -1),
                edge_features=np.array(bf, np.int32).reshape(-1, 3),
                coordinates=coords)


def build_cache(mols, targets: Optional[np.ndarray], out_path: str,
                num_conformers: int = 1):
    atom_chunks, edge_chunks, ei_chunks, coord_chunks = [], [], [], []
    atom_slices, edge_slices = [0], [0]
    kept_targets = []
    kept = 0
    for i, mol in enumerate(mols):
        arr = mol_to_arrays(mol, num_conformers)
        if arr is None:
            continue
        atom_chunks.append(arr["atom_features"])
        edge_chunks.append(arr["edge_features"])
        ei_chunks.append(arr["edge_index"])
        if arr["coordinates"] is not None:
            coord_chunks.append(arr["coordinates"])
        atom_slices.append(atom_slices[-1] + arr["atom_features"].shape[0])
        edge_slices.append(edge_slices[-1] + arr["edge_features"].shape[0])
        if targets is not None:
            kept_targets.append(targets[i])
        kept += 1
    out = dict(
        atom_features=np.concatenate(atom_chunks),
        edge_features=np.concatenate(edge_chunks),
        edge_indices=np.concatenate(ei_chunks, axis=1),
        atom_slices=np.asarray(atom_slices, np.int64),
        edge_slices=np.asarray(edge_slices, np.int64),
    )
    if coord_chunks:
        out["coordinates"] = np.concatenate(coord_chunks)
    if kept_targets:
        out["targets"] = np.stack(kept_targets).astype(np.float32)
    os.makedirs(os.path.dirname(out_path), exist_ok=True)
    np.savez_compressed(out_path, **out)
    print(f"wrote {kept} molecules -> {out_path}")


def _sdf_supplier(path: str):
    """RDKit SDMolSupplier when available, else the dependency-free V2000
    parser (data/sdf.py) with the same accessor surface."""
    try:
        from rdkit import Chem
        return Chem.SDMolSupplier(path, removeHs=False, sanitize=True)
    except ImportError:
        from infomax3d_tpu_torch.data.sdf import parse_sdf
        return parse_sdf(path)


# raw gdb9.sdf.csv column order: mol_id,A,B,C,mu,alpha,homo,lumo,gap,r2,
# zpve,u0,u298,h298,g298,cv,u0_atom,u298_atom,h298_atom,g298_atom.
# The cache stores targets in QM9_TARGET_NAMES order (mu first, rotational
# constants a/b/c last — data/cached.py:133), so reorder here.
_QM9_CSV_TO_CACHE = [4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15,
                     16, 17, 18, 19, 1, 2, 3]


def preprocess_qm9(raw_dir: str, out_path: str):
    sdf = os.path.join(raw_dir, "gdb9.sdf")
    csv = os.path.join(raw_dir, "gdb9.sdf.csv")
    raw = np.genfromtxt(csv, delimiter=",", skip_header=1)
    targets = raw[:, _QM9_CSV_TO_CACHE]
    build_cache(_sdf_supplier(sdf), targets, out_path)


def preprocess_sdf(raw_path: str, out_path: str, num_conformers: int = 1):
    build_cache(_sdf_supplier(raw_path), None, out_path, num_conformers)


GEOM_TARGET_KEYS = ("ensembleenergy", "ensembleentropy", "ensemblefreeenergy",
                    "lowestenergy", "poplowestpct", "temperature",
                    "uniqueconfs")


def preprocess_geom_pickle(raw_dir: str, out_path: str,
                           num_conformers: int = 5,
                           summary_name: str = "summary_drugs.json",
                           max_molecules: Optional[int] = None):
    """GEOM (drugs/qm9) pickles -> flat cache (reference
    geom_drugs_dataset.py:294-360): walk the summary json, unpickle each
    molecule's conformer list, featurize conformer 0's graph and keep the
    first `num_conformers` conformer coordinate sets.  Requires RDKit (the
    pickles contain rdkit Mol payloads)."""
    import json
    import pickle

    with open(os.path.join(raw_dir, summary_name)) as f:
        summary = json.load(f)

    mols, targets = [], []
    for smiles, sub in summary.items():
        pp = os.path.join(raw_dir, sub.get("pickle_path", ""))
        if not os.path.isfile(pp):
            continue
        with open(pp, "rb") as pf:
            mol_dict = pickle.load(pf)
        if "ensembleenergy" not in mol_dict:
            continue
        confs = mol_dict["conformers"]
        mol = confs[0]["rd_mol"]
        # graph/topology from conformer 0; extra conformers become extra
        # coordinate sets on the same mol (mol_to_arrays reads them in order)
        for extra in confs[1:num_conformers]:
            rd = extra["rd_mol"]
            if rd.GetNumConformers():
                mol.AddConformer(rd.GetConformer(), assignId=True)
        mols.append(mol)
        targets.append([float(mol_dict.get(k, 0.0)) for k in GEOM_TARGET_KEYS])
        if max_molecules and len(mols) >= max_molecules:
            break
    build_cache(mols, np.asarray(targets, np.float64), out_path,
                num_conformers)


def generate_conformer(mol, seed: int = -1):
    """ETKDGv2 conformer embedding + MMFF optimization on an H-added mol —
    the reference's per-molecule conformer step
    (qm9_dataset_rdkit_conformers.py:403-415: MolFromSmiles -> AddHs ->
    ETKDGv2(useRandomCoords) -> EmbedMolecule -> MMFFOptimizeMolecule).
    Returns the embedded mol, or None when embedding fails (the reference
    skips those molecules)."""
    from rdkit import Chem
    from rdkit.Chem import AllChem
    mol = Chem.AddHs(mol)
    try:
        ps = AllChem.ETKDGv2()
        ps.useRandomCoords = True
        if seed >= 0:
            ps.randomSeed = seed
        if AllChem.EmbedMolecule(mol, ps) != 0:
            return None
        AllChem.MMFFOptimizeMolecule(mol, confId=0)
        if not mol.GetNumConformers():
            return None
    except Exception:
        return None
    return mol


def preprocess_smiles(txt_path: str, out_path: str,
                      conformers: bool = False, seed: int = -1):
    from rdkit import Chem
    with open(txt_path) as f:
        smiles = [l.strip() for l in f if l.strip()]
    mols = [Chem.MolFromSmiles(s) for s in smiles]
    if conformers:
        # rdkit-conformer variant (reference qm9_dataset_rdkit_conformers):
        # embed an ETKDG conformer per molecule; failures are dropped
        mols = [generate_conformer(m, seed) if m is not None else None
                for m in mols]
    build_cache(mols, None, out_path)


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("dataset", choices=["qm9", "sdf", "smiles", "geom"])
    p.add_argument("--raw", required=True)
    p.add_argument("--out", required=True)
    p.add_argument("--num_conformers", type=int, default=1)
    p.add_argument("--summary", default="summary_drugs.json",
                   help="GEOM summary json name (geom only)")
    p.add_argument("--max_molecules", type=int, default=None)
    p.add_argument("--conformers", action="store_true",
                   help="smiles only: embed an ETKDGv2+MMFF conformer per "
                        "molecule (reference rdkit-conformers variant)")
    p.add_argument("--seed", type=int, default=-1,
                   help="ETKDG random seed (-1 = nondeterministic, as the "
                        "reference)")
    a = p.parse_args(argv)
    if a.dataset in ("smiles", "geom"):
        # SMILES featurization / GEOM rdkit-Mol pickles genuinely need RDKit;
        # qm9/sdf fall back to the pure V2000 parser (data/sdf.py)
        try:
            import rdkit  # noqa: F401
        except ImportError:
            raise SystemExit(
                f"RDKit is required for '{a.dataset}' preprocessing; run in "
                f"a data-prep environment (training only needs the .npz).")
    if a.dataset == "qm9":
        preprocess_qm9(a.raw, a.out)
    elif a.dataset == "sdf":
        preprocess_sdf(a.raw, a.out, a.num_conformers)
    elif a.dataset == "geom":
        preprocess_geom_pickle(a.raw, a.out, a.num_conformers,
                               summary_name=a.summary,
                               max_molecules=a.max_molecules)
    else:
        preprocess_smiles(a.raw, a.out, conformers=a.conformers, seed=a.seed)


if __name__ == "__main__":
    main()
