"""Fingerprint inference (port of `infomax3d_tpu/cli/inference.py`): run the
2D model alone, in eval mode, over a set of molecules and save the
fingerprint matrix as `fingerprints.npy`.

Molecules come from the synthetic generator (`dataset_params`: num, seed,
n_min, n_max); SMILES input comes with a later slice.  Each batch is a
receiver-sorted CSR bucket sized from its own molecules, which is what the
kernels read.
"""
from __future__ import annotations

import os
from typing import Any, Dict, Iterator, Mapping, Optional

import numpy as np
import torch

from infomax3d_tpu_torch.data.synthetic import SyntheticMolecules
from infomax3d_tpu_torch.device import resolve_device
from infomax3d_tpu_torch.graphs.batch import (GraphBatch, batch_graphs,
                                              bucket_for, to_graph_batch)
from infomax3d_tpu_torch.interop import init_jax_variables, params_from_jax
from infomax3d_tpu_torch.models.pna import PNA
from infomax3d_tpu_torch.train.precision import (cast_parameters,
                                                 resolve_compute_dtype)


def build_model(args: Mapping[str, Any], device: torch.device) -> PNA:
    """`PNA(**args["model_parameters"])` on `device`, in eval mode, with
    weights from `args["state_dict"]` (the port's names), else from
    `args["jax_variables"]` (flax `params` / `batch_stats` numpy trees),
    else a seeded numpy init (`args["seed"]`); parameters cast to bf16 when
    `bf16_compute` resolves to it."""
    mp = dict(args["model_parameters"])
    model = PNA(**mp)
    if "state_dict" in args:
        sd = {k: torch.as_tensor(v) for k, v in args["state_dict"].items()}
    elif "jax_variables" in args:
        jv = args["jax_variables"]
        sd = params_from_jax(jv["params"], jv.get("batch_stats", {}))
    else:
        sd = params_from_jax(*init_jax_variables(mp, args.get("seed", 0)))
    model.load_state_dict(sd, strict=True)
    dtype = resolve_compute_dtype(args.get("bf16_compute", "auto"), device)
    return cast_parameters(model.to(device).eval(), dtype)


def batches(dataset, batch_size: int, device: torch.device
            ) -> Iterator[GraphBatch]:
    """Consecutive batches of `batch_size` molecules as CSR `GraphBatch`es."""
    for i in range(0, len(dataset), batch_size):
        graphs = [dataset.graph2d(j)
                  for j in range(i, min(i + batch_size, len(dataset)))]
        bucket = bucket_for(graphs, batch_size)
        yield to_graph_batch(batch_graphs(graphs, bucket), bucket, device)


def inference(args: Dict[str, Any], device: Optional[str] = None
              ) -> np.ndarray:
    """Serve fingerprints for the synthetic molecules of
    `args["dataset_params"]` with the model of `args["model_parameters"]`.
    Runs on the CUDA card unless `device` says otherwise (and raises when
    there is no card).  Returns the float32 [num_molecules, target_dim]
    matrix and saves it to `output_path`, or `output_dir`/fingerprints.npy
    (default directory `dataset`).  `smiles_txt_path` raises (ROADMAP
    queue 1, item 5)."""
    if args.get("smiles_txt_path"):
        raise NotImplementedError(
            "SMILES input to inference is not ported yet (ROADMAP queue 1, "
            "item 5)")
    device = resolve_device(device)
    model = build_model(args, device)
    dataset = SyntheticMolecules(**{"num": 2000,
                                    **args.get("dataset_params", {})})
    chunks = []
    with torch.inference_mode():
        for g in batches(dataset, args.get("batch_size", 500), device):
            z = model(g)
            chunks.append(z[g.graph_mask].float().cpu().numpy())
    fingerprints = np.concatenate(chunks, axis=0)
    out = args.get("output_path")
    if not out:
        out_dir = args.get("output_dir") or "dataset"
        os.makedirs(out_dir, exist_ok=True)
        out = os.path.join(out_dir, "fingerprints.npy")
    np.save(out, fingerprints)
    return fingerprints
