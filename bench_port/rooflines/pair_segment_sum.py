"""Row 5, the pair segment sum (the edge combine's backward): the real
cotangent rows, both row-pointer arrays, the sender permutation and the
two [N, D] outputs, each byte once; two adds per real element."""
MODULE = "infomax3d_tpu_torch.ops.kernels.pair_segment_sum"
GLOBALS = ("pair_segment_sum_kernel",)


def record(ct, row_ptr, csc_row_ptr, csc_perm, *_, **__):
    return {"N": row_ptr.shape[0] - 1, "D": ct.shape[1],
            "s": ct.element_size(), "row_ptr": row_ptr}


def work(r, e_real):
    N, D, s = r["N"], r["D"], r["s"]
    return (e_real * D * s + 2 * (N + 1) * 4 + e_real * 4 + 2 * N * D * s,
            2.0 * e_real * D)
