"""Forward matrix-product FLOPs of NT-Xent with several positives: the
similarities of B 2D embeddings with B * C conformer embeddings."""


def forward_flops(config, counts) -> float:
    graphs = counts["model"]["graphs"]
    conformers = int(config.get("num_conformers", 1))
    width = int(config["model_parameters"]["target_dim"])
    return 2.0 * graphs * graphs * conformers * width
