"""Host ms per step of the span ``smp.triplets`` (each SMP block's
triplet message, from the gather by ``idx_kj`` through the CSR sum onto
each edge j -> i, `propagation_depth` times a forward:
`models/smp.py::SMPUpdateE`) on rank 0 over the traced log period, from
the port's span tally (`infomax3d_tpu_torch/utils/spans.py`), read while
the profiler ran.  Nothing where the program keeps no such span, or
where its ``loop.step`` calls are not the traced steps."""


def read(ctx):
    p = ctx["ranks"][0]["profile"]
    if p is None:
        return None
    try:
        from infomax3d_tpu_torch.utils.spans import tally
    except ImportError:
        return None
    t = tally()
    steps = t["spans"].get("loop.step", {}).get("calls")
    if steps != p["steps"] or "smp.triplets" not in t["spans"]:
        return None
    return t["spans"]["smp.triplets"]["host_s"] / steps * 1e3
