"""The mean of rank 0's train steps' device ms over the window (a traced
run's profiled period left out), between the CUDA events the trainer
records around each step."""


def read(ctx):
    ms = ctx["ranks"][0]["step_ms"]
    return sum(ms) / len(ms) if ms else None
