"""Fingerprint inference (port of `infomax3d_tpu/cli/inference.py`;
reference inference.py:169-220): read molecules, load a trained
checkpoint, run the 2D model in eval mode and save the fingerprint matrix
as `fingerprints.npy`.

    python -m infomax3d_tpu_torch.cli.inference --config=configs_clean/fingerprint_inference.yml --checkpoint=<ckpt> [--device=cpu]

Molecules come from `smiles_txt_path` when that file exists (RDKit when it
imports, else the port's `data/chem.py`; an invalid SMILES raises
`SmilesError`), else from the config's dataset (`cli/train.py::
build_dataset`).  Weights come from `checkpoint`: a torch `.pt` (the port's
own checkpoints, or the reference's payload, whose names the port uses)
or the JAX package's flax msgpack (`train/torch_interop.py`), loaded
strictly; with no checkpoint, from `state_dict` (the port's names) or
`jax_variables` (flax numpy trees), else the seeded initialization.  A
checkpoint's `train_arguments.yaml` supplies the model's arguments
(`load_config`).  PNA and OGBGNN are served.

Serving computes in float32, as the JAX CLI does (it never reads
`bf16_compute`): "auto" is float32 on every device; only an explicit
`bf16_compute: True` (or "bf16") casts the parameters to bf16.

The batches are receiver-sorted CSR buckets of `batch_size` molecules with
the JAX CLI's static caps (`serving_bucket`), collated on the loader's
prefetch thread; the run goes to the CUDA card unless `device` says "cpu".
"""
from __future__ import annotations

import argparse
import copy
import os
import time
from typing import Any, Dict, List, Mapping, Optional

import numpy as np
import torch

from infomax3d_tpu_torch.cli.config import (DEFAULTS, check_device,
                                            load_config)
from infomax3d_tpu_torch.device import resolve_device
from infomax3d_tpu_torch.interop import params_from_jax
from infomax3d_tpu_torch.train.precision import cast_parameters

SERVED = ("PNA", "OGBGNN")


class SmilesDataset:
    """A SMILES text file (one per line) as featurized bond graphs
    (reference InferenceDataset, datasets/inference_dataset.py:23-100)."""

    def __init__(self, path: str):
        from infomax3d_tpu_torch.data.chem import SmilesError
        with open(path) as f:
            self.smiles = [ln.strip() for ln in f if ln.strip()]
        try:
            from rdkit import Chem
            from infomax3d_tpu_torch.data.preprocess import mol_to_arrays

            def featurize(s):
                arr = mol_to_arrays(Chem.MolFromSmiles(s))
                if arr is None:
                    raise SmilesError(f"RDKit cannot parse {s!r}")
                return dict(node_feat=arr["atom_features"],
                            senders=arr["edge_index"][0].astype(np.int32),
                            receivers=arr["edge_index"][1].astype(np.int32),
                            edge_feat=arr["edge_features"])
        except ImportError:
            from infomax3d_tpu_torch.data.chem import \
                smiles_to_graph as featurize
        self.graphs = [featurize(s) for s in self.smiles]

    def __len__(self):
        return len(self.graphs)

    def node_counts(self):
        return np.array([g["node_feat"].shape[0] for g in self.graphs])

    def edge_counts(self):
        return np.array([max(g["senders"].shape[0], 1) for g in self.graphs])

    def max_in_degree(self) -> int:
        return max([int(np.bincount(g["receivers"]).max())
                    for g in self.graphs if len(g["receivers"])] + [1])

    def __getitem__(self, i):
        return {"graph2d": self.graphs[i]}


def serving_dtype(setting) -> Optional[torch.dtype]:
    """bf16 for an explicit `bf16_compute` request (True, "bf16",
    "bfloat16"), else float32 (None), "auto" included."""
    return torch.bfloat16 if setting is True or \
        setting in ("bf16", "bfloat16") else None


def _complete(args: Mapping[str, Any]) -> Dict[str, Any]:
    """`args` over the config defaults; without a `dataset` key (a caller
    that builds its dict by hand) the synthetic set of `dataset_params`."""
    return {**copy.deepcopy(DEFAULTS), "dataset": "synthetic", **args}


def _state_dict(args: Mapping[str, Any]) -> Optional[Mapping]:
    from infomax3d_tpu_torch.train import torch_interop as ti
    from infomax3d_tpu_torch.train.checkpoint import load_checkpoint
    ckpt = args.get("checkpoint")
    if ckpt:
        if ti.is_torch_checkpoint(ckpt):
            return load_checkpoint(ckpt)["model_state_dict"]
        v = ti.jax_model_variables(ti.load_jax_checkpoint(ckpt))
        return params_from_jax(v["params"], v["batch_stats"])
    if "state_dict" in args:
        return args["state_dict"]
    if "jax_variables" in args:
        jv = args["jax_variables"]
        return params_from_jax(jv["params"], jv.get("batch_stats", {}))
    return None


def build_model(args: Mapping[str, Any], device) -> torch.nn.Module:
    """The config's 2D model (`build_models(args)["model"]`, initialized
    under the seeded generator) with the weights of `_state_dict`, on
    `device`, in eval mode, its parameters cast to `serving_dtype`."""
    from infomax3d_tpu_torch.cli.train import build_models
    from infomax3d_tpu_torch.utils.setup import seed_all
    args = _complete(args)
    seed_all(args["seed"])
    model = build_models(args)["model"]
    if args["model_type"] not in SERVED:
        raise ValueError(f"model_type {args['model_type']!r} takes no bond "
                         f"graph batch; served: {SERVED}")
    sd = _state_dict(args)
    if sd is not None:
        model.load_state_dict(sd, strict=True)
    return cast_parameters(model.to(device).eval(),
                           serving_dtype(args.get("bf16_compute")))


def serving_bucket(dataset, bs: int):
    """The static CSR bucket of `bs` molecules of `dataset`: the JAX CLI's
    caps (nodes 1.3x the mean molecule's, rounded up to 256, plus the
    largest; edges 1.35x, rounded up to 512)."""
    from infomax3d_tpu_torch.graphs.batch import BucketSpec
    nodes = dataset.node_counts()
    n_cap = int(np.ceil(bs * float(nodes.mean()) * 1.3 / 256) * 256) \
        + int(nodes.max())
    e_cap = int(np.ceil(bs * float(dataset.edge_counts().mean()) * 1.35
                        / 512) * 512)
    return BucketSpec(bs, n_cap, e_cap, max_deg=dataset.max_in_degree(),
                      csr=True, nmax=int(nodes.max()))


def inference(args: Dict[str, Any], device=None,
              timing: Optional[Dict[str, Any]] = None) -> np.ndarray:
    """Serve the fingerprints of `args`' molecules.  Returns the float32
    [num_molecules, target_dim] matrix and saves it to `output_path`, or
    `output_dir`/fingerprints.npy (default directory `dataset`).  Runs on
    the CUDA card unless `device` says otherwise (and raises when there is
    no card).  `timing`, when given, receives the host seconds of reading
    and featurizing the molecules (`data_s`) and of collating them
    (`collate_s`, on the loader's thread), and each batch's forward ms
    (`forward_ms`: CUDA events on the card, the host clock on the CPU)."""
    from infomax3d_tpu_torch.cli.train import build_dataset
    from infomax3d_tpu_torch.data.loader import (GraphDataLoader,
                                                 graph_only_collate,
                                                 to_device)
    check_device(device)
    device = resolve_device(device)
    t0 = time.perf_counter()
    args = _complete(args)
    path = args.get("smiles_txt_path")
    if path and os.path.exists(path):
        dataset = SmilesDataset(path)
    else:
        dataset = build_dataset(args)
    data_s = time.perf_counter() - t0
    model = build_model(args, device)

    bs = args["batch_size"]
    bucket = serving_bucket(dataset, bs)
    collate_s = [0.0]

    def collate(items, bucket):
        t = time.perf_counter()
        out = graph_only_collate(items, bucket)
        collate_s[0] += time.perf_counter() - t
        return out
    loader = GraphDataLoader(dataset, bs, collate, bucket=bucket,
                             shuffle=False, prefetch=2)

    cuda = device.type == "cuda"
    chunks: List[np.ndarray] = []
    spans = []
    with torch.inference_mode():
        for batch in loader:
            g = to_device(batch["graph"], device)
            if cuda:
                span = (torch.cuda.Event(enable_timing=True),
                        torch.cuda.Event(enable_timing=True))
                span[0].record()
                z = model(g)
                span[1].record()
            else:
                t = time.perf_counter()
                z = model(g)
                span = (time.perf_counter() - t) * 1e3
            spans.append(span)
            chunks.append(z[g.graph_mask].float().cpu().numpy())
    fingerprints = np.concatenate(chunks, axis=0)[: len(dataset)]
    out = args.get("output_path")
    if not out:
        out_dir = args.get("output_dir") or "dataset"
        os.makedirs(out_dir, exist_ok=True)
        out = os.path.join(out_dir, "fingerprints.npy")
    np.save(out, fingerprints)
    if timing is not None:
        timing.update(
            data_s=data_s, collate_s=collate_s[0],
            forward_ms=[s[0].elapsed_time(s[1]) if cuda else s
                        for s in spans])
    print(f"saved {fingerprints.shape} fingerprints to {out}")
    return fingerprints


run_inference = inference   # public name used by tests/docs


def parse_args(argv=None) -> tuple:
    """(`load_config` of `--config` with `--checkpoint`, `--device`)."""
    p = argparse.ArgumentParser()
    p.add_argument("--config", type=str, default=None)
    p.add_argument("--checkpoint", type=str, default=None)
    p.add_argument("--device", type=str, default=None,
                   help="cuda (the default) or cpu")
    known, _ = p.parse_known_args(argv)
    overrides = {}
    if known.checkpoint:
        overrides["checkpoint"] = known.checkpoint
    return load_config(known.config, overrides), known.device


def main(argv=None, timing: Optional[Dict[str, Any]] = None):
    args, device = parse_args(argv)
    return inference(args, device=device, timing=timing)


if __name__ == "__main__":
    main()
