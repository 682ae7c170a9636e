"""The learning rates of scheduler StepLR over the checked steps: the
port's trainer steps it once an epoch (`scheduler_step_per_batch:
False`) and each checked step is an epoch of one batch, so step k runs
at ``lr * gamma ** (k // step_size)``."""


def learning_rates(lr, params, steps):
    step_size, gamma = int(params["step_size"]), float(params.get("gamma",
                                                                  0.1))
    return [lr * gamma ** (k // step_size) for k in range(steps)]
