"""Host ms per step of the span ``smp.bases`` (SMP's radial, angular and
torsion bases from the batch's geometry, once a forward:
`models/smp.py::SMP.bases`) on rank 0 over the traced log period, from
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
    if steps != p["steps"] or "smp.bases" not in t["spans"]:
        return None
    return t["spans"]["smp.bases"]["host_s"] / steps * 1e3
