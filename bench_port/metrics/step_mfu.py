"""The model FLOPs of a step (3 times the forward's matrix products, all
cards; `flops/`) per second of window time per step (a traced run's
profiled period left out), as a share of the cards' dense bf16 peak
(`peaks.json`), in %."""


def read(ctx):
    per_step_s = ctx["timed_s"] / ctx["timed_steps"]
    peak = ctx["peaks"]["bf16_dense_flops"] * len(ctx["ranks"])
    return ctx["step_flops"] / per_step_s / peak * 100.0
