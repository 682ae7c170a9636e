"""Row 6, the fused edge combine: two gathered node arrays, the per-edge
part, both index arrays and the output, each byte once; 2 adds per
output element."""
MODULE = "infomax3d_tpu_torch.ops.kernels.edge_combine"
GLOBALS = ("edge_combine_kernel",)


def record(hd, hs, pe, receivers, senders, *_, **__):
    return {"N": hd.shape[0], "E": pe.shape[0], "D": pe.shape[1],
            "s": pe.element_size()}


def work(r, e_real):
    N, E, D, s = r["N"], r["E"], r["D"], r["s"]
    return 2 * N * D * s + E * D * s + 2 * E * 4 + E * D * s, 2.0 * E * D
