"""Embedding analysis (port of `infomax3d_tpu/cli/analysis.py`): the
singular-value spectrum of a model's fingerprints (reference
`singular_value_plots.py:1-110` and tensorboard_singular_value_plot,
`commons/utils.py:113-121`).

    python -m infomax3d_tpu_torch.cli.analysis --config=<cfg> --checkpoint=<ckpt> [--device=cpu]

Serves the fingerprints (`cli/inference.py`), then writes
`singular_values.json` (and a matplotlib PNG when matplotlib imports)
into `output_dir` (default `dataset`).
"""
from __future__ import annotations

import json
import os

import numpy as np

from infomax3d_tpu_torch.cli.inference import inference, parse_args


def singular_value_spectrum(embeddings: np.ndarray) -> np.ndarray:
    """Each singular value of the centred embeddings as a percentage of
    their sum, descending."""
    z = embeddings - embeddings.mean(axis=0, keepdims=True)
    s = np.linalg.svd(z, compute_uv=False)
    return 100.0 * s / s.sum()


def main(argv=None):
    args, device = parse_args(argv)
    fingerprints = inference(args, device=device)
    spectrum = singular_value_spectrum(fingerprints)
    out_dir = args.get("output_dir") or "dataset"
    os.makedirs(out_dir, exist_ok=True)
    payload = {"singular_values_pct": spectrum.tolist(),
               "cumsum_pct": np.cumsum(spectrum).tolist(),
               "n_samples": int(fingerprints.shape[0]),
               "dim": int(fingerprints.shape[1])}
    with open(os.path.join(out_dir, "singular_values.json"), "w") as f:
        json.dump(payload, f, indent=2)
    try:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
        fig, axes = plt.subplots(1, 2, figsize=(10, 4))
        axes[0].plot(spectrum)
        axes[0].set_title("singular values (%)")
        axes[1].plot(np.cumsum(spectrum))
        axes[1].set_title("cumulative (%)")
        fig.savefig(os.path.join(out_dir, "singular_values.png"), dpi=120)
        plt.close(fig)
    except ImportError:
        pass
    print(f"top-5 singular values (%): {np.round(spectrum[:5], 2).tolist()}")
    return payload


if __name__ == "__main__":
    main()
