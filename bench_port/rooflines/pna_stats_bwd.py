"""Row 8, the PNA statistics' backward: the real message rows, the
cotangent rows out (padding included), the forward's mean / std /
encoding and the given cotangents ([N, D] bf16 each), the row pointers,
and the affine in and its cotangents out, each byte once; ~20 flops per
real message element."""
MODULE = "infomax3d_tpu_torch.ops.kernels.pna_stats_bwd"
GLOBALS = ("pna_stats_bwd_kernel",)


def record(x, row_ptr, max_deg, mean, std, enc, cots, affine):
    return {"N": row_ptr.shape[0] - 1, "E": x.shape[0], "D": x.shape[1],
            "row_ptr": row_ptr, "affine": affine is not None,
            "node_arrays": 3 + sum(c is not None for c in cots)}


def work(r, e_real):
    N, E, D = r["N"], r["E"], r["D"]
    nbytes = (e_real * D * 2 + E * D * 2 + r["node_arrays"] * N * D * 2
              + (N + 1) * 4 + (4 * D * 4 if r["affine"] else 0))
    return nbytes, 20.0 * e_real * D
