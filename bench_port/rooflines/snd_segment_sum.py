"""Row 4, the sender-keyed segment sum: the real rows through the sender
permutation, the row pointers and one [N, D] output, each byte once."""
MODULE = "infomax3d_tpu_torch.ops.kernels.snd_segment_sum"
GLOBALS = ("snd_segment_sum_kernel",)


def record(ct, csc_row_ptr, csc_perm, *_, **__):
    return {"N": csc_row_ptr.shape[0] - 1, "D": ct.shape[1],
            "s": ct.element_size(), "row_ptr": csc_row_ptr}


def work(r, e_real):
    N, D, s = r["N"], r["D"], r["s"]
    return e_real * D * s + e_real * 4 + (N + 1) * 4 + N * D * s, \
        1.0 * e_real * D
