"""Forward matrix-product FLOPs of NT-Xent with several positives: the
similarities of B 2D embeddings with B * C conformer embeddings."""


def forward_flops(width, graphs, conformers) -> float:
    return 2.0 * graphs * graphs * conformers * width
