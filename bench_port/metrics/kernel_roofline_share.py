"""The port's kernel launches of rank 0's traced period: the sum of their
least times (`rooflines/`: each byte once at the memory rate, or the
float32 flops at their peak, the larger) over the sum of their profiled
device times, in %.  Nothing where no port kernel ran."""


def read(ctx):
    p = ctx["ranks"][0]["profile"]
    if p is None:
        return None
    ran = [k for k in p["port"].values() if k["launches"] and k["recorded"]]
    if not ran:
        return None
    return (sum(k["least_seconds"] for k in ran)
            / sum(k["seconds"] for k in ran) * 100.0)
