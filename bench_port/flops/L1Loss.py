"""Forward matrix-product FLOPs of L1Loss: none (a difference, an
absolute value and a mean)."""


def forward_flops(config, counts) -> float:
    return 0.0
