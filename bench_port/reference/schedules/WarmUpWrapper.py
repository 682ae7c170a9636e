"""The learning rates of scheduler WarmUpWrapper over the checked steps:
one linear warm-up phase, ramped as ``lr * (k - 1) / warmup`` at step k,
as the port's trainer steps it; the wrapped scheduler is not reached."""


def learning_rates(lr, params, steps):
    warm = params.get("warmup_steps")
    warm = warm if isinstance(warm, (list, tuple)) else [warm]
    if len(warm) != 1 or params.get("interpolation", "linear") != "linear":
        raise NotImplementedError("the reference ramps one linear warm-up "
                                  "phase")
    return [lr * min(k, int(warm[0])) / int(warm[0]) for k in range(steps)]
