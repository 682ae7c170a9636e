"""Forward matrix-product FLOPs of SMP (SphereNet) on the real atoms,
radius-graph edges, molecules and triplets of a batch, each Linear at
2 * rows * in * out as the published model applies it: ``init_e`` and
each ``update_e`` on the edges (``init_e.lin`` on the concatenated
[3 H] rows), the basis projections ``lin_sbf1`` / ``lin_sbf2`` and
``lin_t1`` / ``lin_t2`` on the triplets, ``init_v`` and each
``update_v`` on the atoms.  Basis functions, gathers, sums and
products are not matrix products."""


def forward_flops(params, counts) -> float:
    H, I = int(params["hidden_channels"]), int(params["int_emb_size"])
    B, O = int(params["basis_emb_size"]), int(params["out_emb_size"])
    L, K = int(params["num_spherical"]), int(params["num_radial"])
    out, depth = int(params["target_dim"]), int(params["propagation_depth"])
    E, T, N = counts["edges"], counts["triplets"], counts["nodes"]
    init_e = E * (K * H + 3 * H * H + K * H)
    # lin_ji, lin_kj, lin, 1 residual before and 2 after the skip (2 each)
    per_edge = (3 + 2 * 3) * H * H + K * B + B * H + H * I + I * H + K * H
    per_triplet = L * K * B + B * I + L * L * K * B + B * I
    update_v = N * (H * O + 3 * O * O + O * out)
    return 2.0 * (init_e + update_v + depth * (
        E * per_edge + T * per_triplet + update_v))
