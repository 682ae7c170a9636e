"""The training loop's own host time per step on rank 0 (`Trainer.timing`
over the window, a traced run's profiled period left out: moving and
casting the batch, which waits for the previous step's work in stream
order, the metrics and the logging), in ms."""


def read(ctx):
    t = ctx["ranks"][0]["timing"]
    return (t["to_device"] + t["metrics"] + t["logging"]) \
        / ctx["timed_steps"] * 1e3
