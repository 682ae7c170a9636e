"""Row 1, the multi-reduce: the real message rows, the row pointers and
four float32 [N, D] sections out, each byte once; sum, square sum and
extrema (~5 flops) per real element."""
MODULE = "infomax3d_tpu_torch.ops.kernels.multi_reduce"
GLOBALS = ("multi_reduce_kernel",)


def record(messages, row_ptr, *_, **__):
    return {"N": row_ptr.shape[0] - 1, "D": messages.shape[1],
            "s": messages.element_size(), "row_ptr": row_ptr}


def work(r, e_real):
    N, D = r["N"], r["D"]
    return e_real * D * r["s"] + (N + 1) * 4 + 4 * N * D * 4, 5.0 * e_real * D
