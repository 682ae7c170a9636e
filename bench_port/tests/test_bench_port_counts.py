"""The benchmark's FLOP and byte counts at tiny shapes against hand
counts, and each roofline file's `record` against the port kernel entry
it wraps."""
import inspect
import os

import pytest
import torch

from bench_port import manifest, trace
from bench_port.cell import step_flops

PNA = {"hidden_dim": 4, "target_dim": 3, "propagation_depth": 2,
       "aggregators": ["mean", "max"], "scalers": ["identity",
                                                   "amplification"],
       "readout_aggregators": ["min", "max"], "pretrans_layers": 2,
       "posttrans_layers": 1, "readout_layers": 2, "readout_hidden_dim": 5,
       "mid_batch_norm": True, "last_batch_norm": True,
       "readout_batchnorm": True}
NET3D = {"hidden_dim": 2, "target_dim": 3, "fourier_encodings": 1,
         "propagation_depth": 1, "message_net_layers": 1,
         "update_net_layers": 1, "readout_layers": 1,
         "readout_aggregators": ["mean"], "node_wise_output_layers": 0,
         "batch_norm": True, "reduce_func": "mean"}


def _flops(name):
    return trace.load_file(os.path.join(manifest.BENCH, "flops",
                                        f"{name}.py"),
                           f"test_flops_{name}").forward_flops


def test_pna_flops_by_hand():
    # per layer: pretrans 12 -> 4 -> 4 on 10 edges, posttrans 20 -> 4 on
    # 6 nodes; output 8 -> 5 -> 3 on 2 graphs
    per_layer = 2 * 10 * (12 * 4 + 4 * 4) + 2 * 6 * (20 * 4)
    want = 2 * per_layer + 2 * 2 * (8 * 5 + 5 * 3)
    got = _flops("PNA")(PNA, {"nodes": 6, "edges": 10, "graphs": 2})
    assert got == want


def test_net3d_flops_by_hand():
    # edge MLP 3 -> 2, message 6 -> 2, gate 2 -> 1 on 12 edges; update
    # 2 -> 2 on 4 nodes; output 2 -> 3 on 2 graphs
    want = (2 * 12 * 3 * 2 + 2 * 12 * 6 * 2 + 2 * 12 * 2 + 2 * 4 * 2 * 2
            + 2 * 2 * 2 * 3)
    assert _flops("Net3D")(NET3D, {"nodes": 4, "edges": 12,
                                   "graphs": 2}) == want


def test_step_flops_three_times_forward():
    args = {"model_type": "PNA", "model3d_type": "Net3D",
            "loss_func": "NTXentMultiplePositives", "model_parameters": PNA,
            "model3d_parameters": NET3D, "num_conformers": 2}
    counts = {"graph2d": {"nodes": 6, "edges": 10, "graphs": 2},
              "graph3d": {"nodes": 12, "edges": 24, "graphs": 4}}
    models = _flops("PNA")(PNA, counts["graph2d"]) + _flops("Net3D")(
        NET3D, counts["graph3d"])
    # the loss: 2 molecules against their 2 x 2 conformers, width 3
    loss = 2 * 2 * 2 * 2 * 3
    assert step_flops(args, counts) == 3 * (models + loss)


def test_roofline_bytes_by_hand():
    files = trace.rooflines()
    N, E, D = 5, 9, 4
    rp = torch.tensor([0, 2, 4, 6, 7, 7], dtype=torch.int32)   # 7 real
    x = torch.zeros(E, D, dtype=torch.bfloat16)
    h = torch.zeros(N, D, dtype=torch.bfloat16)
    idx = torch.zeros(E, dtype=torch.int32)
    cases = {
        "edge_combine": (files["edge_combine"].record(h, h, x, idx, idx),
                         None, 2 * N * D * 2 + E * D * 2 + 2 * E * 4
                         + E * D * 2),
        "pna_stats": (files["pna_stats"].record(x, rp, 4, (1, 2), False), 7,
                      7 * D * 2 + (N + 1) * 4 + 2 * D * 4 + 5 * N * D * 2),
        "pair_segment_sum": (files["pair_segment_sum"].record(x, rp, rp,
                                                              idx), 7,
                             7 * D * 2 + 2 * (N + 1) * 4 + 7 * 4
                             + 2 * N * D * 2),
        "csr_sum": (files["csr_sum"].record(x, rp), 7,
                    7 * D * 2 + (N + 1) * 4 + N * D * 4),
        "pna_stats_bwd": (files["pna_stats_bwd"].record(
            x, rp, 4, h, h, h, (None, h, h, h, h), (1, 2)), 7,
            7 * D * 2 + E * D * 2 + 7 * N * D * 2 + (N + 1) * 4
            + 4 * D * 4)}
    for kernel, (rec, e_real, want) in cases.items():
        assert files[kernel].work(rec, e_real)[0] == want, kernel


def test_least_seconds_reads_real_rows():
    rec = trace.LaunchRecorder()
    rp = torch.tensor([0, 3, 3, 8], dtype=torch.int32)
    rec.launches = [("csr_sum", rec.files["csr_sum"].record(
        torch.zeros(10, 2), rp))] * 2
    peaks = {"hbm_bytes_per_s": 1.0, "f32_flops": 1e30}
    launches, seconds = rec.least_seconds(peaks)["csr_sum"]
    assert launches == 2
    assert seconds == 2 * (8 * 2 * 4 + 4 * 4 + 3 * 2 * 4)


@pytest.mark.parametrize("kernel", sorted(trace.rooflines()))
def test_record_matches_the_kernel_entry(kernel):
    """A roofline file's `record` takes the arguments of the `_launch` it
    wraps, so a change of the port's entry shows here."""
    import importlib
    spec = trace.rooflines()[kernel]
    launch = importlib.import_module(spec.MODULE)._launch
    params = list(inspect.signature(launch).parameters)
    rec = inspect.signature(spec.record).parameters
    named = [p for p, v in rec.items() if v.kind == v.POSITIONAL_OR_KEYWORD]
    assert params[:len(named)] == named
    if len(named) < len(params):
        assert any(v.kind == v.VAR_POSITIONAL for v in rec.values())


def test_real_counts_of_a_radius_graph_pool(tmp_path):
    """A pool collated for SMP's `smp_collate` (the items' `graph3d`
    coordinates, their targets) counts its triplets beside its atoms,
    edges and graphs."""
    import json
    from bench_port.cell import collate_pool, real_counts
    from infomax3d_tpu_torch.cli.config import load_config
    from infomax3d_tpu_torch.cli.train import resolve_collate
    (tmp_path / "smp.yml").write_text(
        "model_type: SMP\nbatch_size: 4\nnum_conformers: 1\n"
        "loss_func: L1Loss\ncollate_function: graph_collate\n")
    args = load_config(str(tmp_path / "smp.yml"))
    resolve_collate(args)
    with open(os.path.join(manifest.BENCH, "workloads",
                           "drug_size_closed.json")) as f:
        traffic = dict(json.load(f), n_min=8, n_max=12, targets=1)
    batches = collate_pool(args, traffic, 5)
    graph = batches[0]["graph"]
    assert graph["targets"].shape[1] == 1
    counts = real_counts(batches)["graph"]
    assert counts["graphs"] == 4
    assert counts["triplets"] == sum(float(b["graph"]["tri_mask"].sum())
                                     for b in batches) / len(batches) > 0
