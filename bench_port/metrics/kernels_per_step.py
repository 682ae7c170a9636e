"""Device kernel records per step on rank 0 in the traced log period
(copies and fills left out)."""


def read(ctx):
    p = ctx["ranks"][0]["profile"]
    return None if p is None else p["kernels"] / p["steps"]
