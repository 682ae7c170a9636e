"""1 minus the union of the device's records over the traced period's
length, averaged over the ranks, in %."""


def read(ctx):
    ps = [r["profile"] for r in ctx["ranks"] if r["profile"] is not None]
    if not ps:
        return None
    return sum(1.0 - p["busy_s"] / p["window_s"] for p in ps) / len(ps) * 100
