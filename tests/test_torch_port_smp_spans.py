"""SMP's spans and triplet counters (`utils/spans.py`) on the CPU: under a
profiler a forward records ``smp.bases`` once and ``smp.triplets`` once a
block, and a batch handed to the device counts its real triplets
(``smp_triplets``, the host ``tri_mask``'s sum) and its triplet rows
(``smp_triplet_rows``); without a profiler nothing is recorded and the
real triplets are not counted at all.  Tiny sizes: 6 molecules of 4 to 10
atoms, SMP hidden 8, 2 blocks, one torch thread."""
import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from infomax3d_tpu_torch.data import loader
from infomax3d_tpu_torch.data.synthetic import SyntheticMolecules
from infomax3d_tpu_torch.graphs import batch as batch_module
from infomax3d_tpu_torch.graphs.batch import BucketSpec
from infomax3d_tpu_torch.models.registry import build_model
from infomax3d_tpu_torch.utils import spans

B, N_CAP, E_CAP = 6, 64, 512
SMP = dict(hidden_channels=8, target_dim=1, int_emb_size=6, basis_emb_size=4,
           out_emb_size=10, num_spherical=3, num_radial=4,
           propagation_depth=2, cutoff=5.0, output_init="zeros")


@pytest.fixture(scope="module")
def arrays():
    """One SMP host batch with padded triplet rows."""
    ds = SyntheticMolecules(B, seed=2, n_min=4, n_max=10, num_targets=1)
    items = [{"graph2d": ds.graph2d(i), "targets": ds.targets[i]}
             for i in range(B)]
    view = loader.smp_collate(items, BucketSpec(
        B + 1, N_CAP, E_CAP, max_deg=N_CAP, csr=True, nmax=10), 5.0)
    tri = view["graph"]["tri_mask"]
    assert 0 < tri.sum() < len(tri)
    return view["graph"]


@pytest.fixture
def idle():
    """A span outside any profiler, so the next recording starts a fresh
    tally whatever an earlier test left."""
    with spans.span("idle"):
        pass


def test_spans_and_counters_under_the_profiler(arrays, idle):
    torch.manual_seed(0)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        model = build_model("SMP", SMP)
        with profile(activities=[ProfilerActivity.CPU]):
            g = loader.to_device(arrays, "cpu")
            with torch.no_grad():
                model(g)
    finally:
        torch.set_num_threads(threads)
    t = spans.tally()
    assert t["spans"]["smp.bases"]["calls"] == 1
    assert t["spans"]["smp.triplets"]["calls"] == SMP["propagation_depth"]
    assert t["counters"]["smp_triplets"] == int(arrays["tri_mask"].sum())
    assert t["counters"]["smp_triplet_rows"] == len(arrays["tri_mask"])


def test_no_profiler_counts_nothing(arrays, idle, monkeypatch):
    """Off the profiler the real triplets are not even summed."""
    def refuse(*args, **kwargs):
        raise AssertionError("tri_mask summed with no profiler recording")
    real = np.count_nonzero
    monkeypatch.setattr(batch_module.np, "count_nonzero", refuse)
    assert not spans.recording()
    before = spans.tally()
    loader.to_device(arrays, "cpu")
    assert spans.tally() == before
    monkeypatch.setattr(batch_module.np, "count_nonzero", real)
    with profile(activities=[ProfilerActivity.CPU]):
        loader.to_device(arrays, "cpu")
    assert spans.tally()["counters"]["smp_triplets"] == \
        int(arrays["tri_mask"].sum())
