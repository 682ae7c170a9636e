"""The reference of loss L1Loss (the supervised trainer's `L1Loss`): the
mean absolute error of the model's outputs against the targets over
every entry of [B, T]."""


def loss(params, outputs, batch):
    return (outputs["model"] - batch["targets"]).abs().mean()
