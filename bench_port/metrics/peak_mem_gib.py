"""The largest `torch.cuda.max_memory_allocated` over the ranks, reset
after warm-up, read when the window has closed, in GiB."""


def read(ctx):
    return max(r["peak_bytes"] for r in ctx["ranks"]) / 2 ** 30
