"""Megabytes (1e6 bytes) per step of host arrays handed to the device
(the counter ``h2d_bytes``: every array `graphs/batch.py::to_tensors`
turns into one of the step's tensors) on rank 0 over the traced log
period, from the port's tally (`infomax3d_tpu_torch/utils/spans.py`).
Nothing where the program keeps no such counter, or where its
``loop.step`` calls are not the traced steps."""


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
    if steps != p["steps"] or "h2d_bytes" not in t["counters"]:
        return None
    return t["counters"]["h2d_bytes"] / steps * 1e-6
