"""Row 7, the CSR sum: the real message rows, the row pointers and the
float32 [N, D] output, each byte once; one add per real element."""
MODULE = "infomax3d_tpu_torch.ops.kernels.csr_sum"
GLOBALS = ("csr_sum_kernel", "csr_sum_stream_kernel")


def record(messages, row_ptr, *_, **__):
    return {"N": row_ptr.shape[0] - 1, "D": messages.shape[1],
            "s": messages.element_size(), "row_ptr": row_ptr}


def work(r, e_real):
    N, D = r["N"], r["D"]
    return e_real * D * r["s"] + (N + 1) * 4 + N * D * 4, 1.0 * e_real * D
