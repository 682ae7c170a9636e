"""Row 3, the receiver-keyed segment sum: the real rows, the row pointers
and one [N, D] output, each byte once."""
MODULE = "infomax3d_tpu_torch.ops.kernels.csr_segment_sum"
GLOBALS = ("csr_segment_sum_kernel",)


def record(ct, row_ptr, *_, **__):
    return {"N": row_ptr.shape[0] - 1, "D": ct.shape[1],
            "s": ct.element_size(), "row_ptr": row_ptr}


def work(r, e_real):
    N, D, s = r["N"], r["D"], r["s"]
    return e_real * D * s + (N + 1) * 4 + N * D * s, 1.0 * e_real * D
