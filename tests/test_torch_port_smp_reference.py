"""SMP (SphereNet) on the CPU against the benchmark's plain reference
(`bench_port/reference/models/SMP.py`: its own radius graphs, triplets,
angles and torsions from the raw coordinates, its own bases, no kernel and
no padding), from the same seeded weights (`bench_port/weights.py`) on the
same molecules (`bench_port/molecules.py`): the forward, one L1 Adam step,
and two planted faults that the forward's comparison must catch (SMP's
spans and counters are `test_torch_port_smp_spans.py`'s).  Tiny widths (hidden 16,
int_emb 8, basis_emb 4, out_emb 16, 2 blocks; the published 3 spherical
and 6 radial bases, cutoff 5), 4 molecules of 13 to 23 atoms, one torch
thread.

Tolerances, float32 (the worst reading on this data in brackets):
* the forward: 1e-5, the relative L2 gap of the [4, 1] outputs.  Both
  sides sum in another order (the CSR sums against `index_add`,
  `init_e.lin` split into node-space blocks against one product on the
  concatenated rows), and the port evaluates j_l below x = 0.5 by a
  two-term series (up to 2.2e-3 off on basis entries up to ~20, on the
  closest pairs only) where the reference evaluates the closed forms in
  float64 [1.8e-7];
* the Adam step: 1e-4, each leaf's relative L2 gap after the step.
  Adam's first update is lr * g / (|g| + eps) per element, lr or -lr
  unless |g| nears eps, where the two sides' rounding of g moves it by a
  share of lr (up to 0.5 % of lr on this data); an update of the wrong
  sign on a leaf's elements moves it by 2 lr each, 7e-3 of a leaf's norm
  [1.3e-6].

The planted faults read 2.4e-4 (the largest dihedral) and 2.1e-3 (the
messages summed by `idx_kj`) on the forward.
"""
import json
import math
import os

import numpy as np
import pytest
import torch

from bench_port import manifest
from bench_port.molecules import MoleculePool
from bench_port.reference.nn import Layers
from bench_port.reference.run import ReferenceRun
from bench_port.weights import make_weights, model_state
from infomax3d_tpu_torch.data.loader import smp_collate, to_device
from infomax3d_tpu_torch.models import smp as smp_module
from infomax3d_tpu_torch.models.registry import build_model
from infomax3d_tpu_torch.ops.segment import segment_sum
from infomax3d_tpu_torch.train.optim import build_adam
from infomax3d_tpu_torch.train.supervised import SupervisedStep

SEED, B, LR = 2 ** 31 + 11, 4, 5e-4
FWD_TOL, STEP_TOL = 1e-5, 1e-4
TINY = dict(hidden_channels=16, target_dim=1, int_emb_size=8,
            basis_emb_size=4, out_emb_size=16, num_spherical=3, num_radial=6,
            propagation_depth=2, cutoff=5.0, output_init="zeros",
            use_node_features=True, energy_and_force=False)
CONFIG = {"model_type": "SMP", "model_parameters": TINY,
          "loss_func": "L1Loss", "optimizer_params": {"lr": LR}}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def case():
    """(molecules, the port's host batch of them, the weights)."""
    with open(os.path.join(manifest.BENCH, "workloads",
                           "qm9_size_closed.json")) as f:
        traffic = json.load(f)
    pool = MoleculePool(SEED, traffic, B, 1)
    arrays = smp_collate([pool.item(i) for i in range(B)], None)["graph"]
    assert arrays["graph_mask"].all() and not arrays["tri_mask"].all()
    return ([pool.molecule(i) for i in range(B)], arrays,
            make_weights(CONFIG, SEED, "cpu"))


def _port(weights):
    model = build_model("SMP", TINY)
    model.load_state_dict(model_state(weights, "model"), strict=True)
    return model


def _reference(mols, weights):
    run = ReferenceRun(CONFIG, weights, manifest.reference_parts(CONFIG))
    return run, run.batch(mols, "cpu")


def _reference_outputs(mols, weights):
    run, batch = _reference(mols, weights)
    s = run.parts.shapes["model"]
    layers = Layers(run.P["model"], run.S["model"], 0.1)
    with torch.no_grad():
        return run.parts.models["model"].forward(s, layers, batch["model"])


def _gap(port, reference) -> float:
    return float(torch.linalg.vector_norm(port - reference)
                 / torch.linalg.vector_norm(reference))


def _port_outputs(arrays, weights):
    with torch.no_grad():
        return _port(weights)(to_device(arrays, "cpu"))


def test_forward_matches_reference(case):
    mols, arrays, weights = case
    want = _reference_outputs(mols, weights)
    assert want.shape == (B, 1) and float(want.abs().min()) > 0
    assert _gap(_port_outputs(arrays, weights), want) <= FWD_TOL


def test_adam_step_matches_reference(case):
    """One L1 step under the port's supervised step and Adam, against the
    reference's: every leaf after the step."""
    mols, arrays, weights = case
    model = _port(weights)
    step = SupervisedStep.from_modules(
        model, torch.device("cpu"), None, "L1Loss",
        build_adam(model.named_parameters(), lr=LR))
    loss = step.step(step.prepare(to_device(arrays, "cpu")))
    run, batch = _reference(mols, weights)
    ref_loss = run.step(batch, LR)
    assert float(loss) == pytest.approx(ref_loss, rel=FWD_TOL)
    moved = 0
    for name, p in model.named_parameters():
        assert _gap(p.detach(), run.P["model"][name].detach()) <= STEP_TOL, \
            name
        moved += int((p.detach() != weights[f"model.{name}"]).sum())
    assert moved > 0.9 * sum(p.numel() for p in model.parameters())


def _max_torsions(arrays) -> np.ndarray:
    """Each real triplet's LARGEST dihedral over the other in-neighbours
    k' (not i, not k) of j, wrapped into (0, 2 pi] (2 pi where there is
    none): the minimum taken the wrong way."""
    pos = arrays["coords"].astype(np.float64)
    snd, rcv = arrays["senders"], arrays["receivers"]
    real = arrays["edge_mask"]
    out = arrays["torsion"].copy()
    for t in np.flatnonzero(arrays["tri_mask"]):
        kj, ji = arrays["idx_kj"][t], arrays["idx_ji"][t]
        k, j, i = snd[kj], rcv[kj], rcv[ji]
        others = snd[real & (rcv == j)]
        others = others[(others != i) & (others != k)]
        if not len(others):
            out[t] = 2 * math.pi
            continue
        pos_ji = pos[i] - pos[j]
        plane1 = np.cross(pos_ji, pos[k] - pos[j])
        plane2 = np.cross(pos_ji, pos[others] - pos[j])
        a = plane2 @ plane1
        b = np.cross(plane1, plane2) @ pos_ji / np.linalg.norm(pos_ji)
        tor = np.arctan2(b, a)
        out[t] = np.where(tor <= 0, tor + 2 * math.pi, tor).max()
    return out


def test_planted_max_torsion_fails(case):
    mols, arrays, weights = case
    faulty = dict(arrays, torsion=_max_torsions(arrays))
    assert not np.allclose(faulty["torsion"], arrays["torsion"])
    gap = _gap(_port_outputs(faulty, weights),
               _reference_outputs(mols, weights))
    assert gap > FWD_TOL, gap


def test_planted_sum_by_idx_kj_fails(case, monkeypatch):
    """The triplet messages summed onto their edge k -> j instead of
    j -> i."""
    mols, arrays, weights = case
    g = to_device(arrays, "cpu")
    real = smp_module.csr_sum

    def by_kj(x, row_ptr, ids):
        if ids is g.idx_ji:
            return segment_sum(x.float(), g.idx_kj, row_ptr.shape[0] - 1)
        return real(x, row_ptr, ids)
    monkeypatch.setattr(smp_module, "csr_sum", by_kj)
    with torch.no_grad():
        out = _port(weights)(g)
    gap = _gap(out, _reference_outputs(mols, weights))
    assert gap > FWD_TOL, gap
