"""Row 2, the fused PNA statistics: the real message rows, the row
pointers, the folded affine and the bf16 sections out, each byte once;
per message element the affine, sum, square sum and extrema (~7), per
output element ~8."""
MODULE = "infomax3d_tpu_torch.ops.kernels.pna_stats"
GLOBALS = ("pna_stats_kernel",)


def record(messages, row_ptr, max_deg, affine, want_sum):
    return {"N": row_ptr.shape[0] - 1, "D": messages.shape[1],
            "row_ptr": row_ptr, "affine": affine is not None,
            "sections": 6 if want_sum else 5}


def work(r, e_real):
    N, D = r["N"], r["D"]
    nbytes = (e_real * D * 2 + (N + 1) * 4 + (2 * D * 4 if r["affine"] else 0)
              + r["sections"] * N * D * 2)
    return nbytes, 7.0 * e_real * D + 8.0 * N * D
