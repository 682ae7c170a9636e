"""Real molecules of all steps completed in the window, over all ranks,
per second of the window (host clock, ended behind a synchronize)."""


def read(ctx):
    return ctx["graphs"] / ctx["window_s"]
