"""`flops/SMP.py` and `flops/L1Loss.py` against a count by hand at a tiny
size.  The cell `qm9_smp_b32` itself is run, and its planted faults
caught, by the parametrised run and control tests, which take every
cell."""
import os

from bench_port import manifest, trace


def test_smp_flops_by_hand():
    # H 4, I 3, B 2, O 5, L 2, K 3, target 1, 1 block; 10 edges, 20
    # triplets, 6 atoms.  init_e on the edges: 3 -> 4, 12 -> 4, 3 -> 4;
    # init_v and update_v on the atoms: 4 -> 5, three 5 -> 5, 5 -> 1;
    # update_e on the edges: nine 4 -> 4, 3 -> 2, 2 -> 4, 4 -> 3, 3 -> 4,
    # 3 -> 4; on the triplets: 6 -> 2, 2 -> 3, 12 -> 2, 2 -> 3
    params = {"hidden_channels": 4, "int_emb_size": 3, "basis_emb_size": 2,
              "out_emb_size": 5, "num_spherical": 2, "num_radial": 3,
              "target_dim": 1, "propagation_depth": 1}
    init_e = 10 * (3 * 4 + 12 * 4 + 3 * 4)
    update_v = 6 * (4 * 5 + 3 * 5 * 5 + 5 * 1)
    update_e = 10 * (9 * 16 + 3 * 2 + 2 * 4 + 4 * 3 + 3 * 4 + 3 * 4) + \
        20 * (6 * 2 + 2 * 3 + 12 * 2 + 2 * 3)
    want = 2 * (init_e + 2 * update_v + update_e)
    flops = trace.load_file(os.path.join(manifest.BENCH, "flops", "SMP.py"),
                            "test_flops_SMP").forward_flops
    got = flops(params, {"nodes": 6, "edges": 10, "graphs": 2,
                         "triplets": 20})
    assert got == want
    loss = trace.load_file(os.path.join(manifest.BENCH, "flops",
                                        "L1Loss.py"), "test_flops_L1Loss")
    assert loss.forward_flops({}, {}) == 0.0
