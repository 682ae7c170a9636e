"""Host ms per step of the span ``step.forward`` (both models' forwards
and the loss: `train/supervised.py::TrainStep.loss_and_grads`) on rank 0
over the traced log period, from the port's span tally
(`infomax3d_tpu_torch/utils/spans.py`), read while the profiler ran, so
the profiler's own host cost is in it.  Nothing where the program keeps
no such tally, or where its ``loop.step`` calls are not the traced
steps."""


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
    if steps != p["steps"] or "step.forward" not in t["spans"]:
        return None
    return t["spans"]["step.forward"]["host_s"] / steps * 1e3
