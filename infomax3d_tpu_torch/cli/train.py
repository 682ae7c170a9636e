"""Training entry point (port of `infomax3d_tpu/cli/train.py`, the
reference's `train.py` CLI).

    python -m infomax3d_tpu_torch.cli.train --config=configs_clean/pre-train_synthetic.yml --device=cpu

Reference parity: the YAML schema, dataset dispatch (every dataset name
the JAX package routes, served from the flat .npz caches under
`$INFOMAX3D_DATA` that `data/preprocess.py` builds), the split protocols
(`get_random_indices` with numpy seed 123, first 100k model pool, 10%
test; OGB scaffold splits; stored splits), the size-clustered train
samplers, metric names, trainer selection, pre-trained-weight transfer
with substring filtering, multi-seed runs and test evaluation.  `dataset:
synthetic` runs everything without chemistry data.

The run goes to the CUDA card unless `--device` (or the config's `device`)
says "cpu"; with neither set and no card, it raises.  `csr_buckets: False`
runs the flat collates on the non-CSR batch (the segment path);
`bucket_ladder: true` picks each batch's bucket from a ladder where the
JAX CLI does, and says so once where it leaves the ladder unused.
`remat: true` recomputes the training forwards in the backward.

Data parallelism (`n_shards: k`, item 9a) runs k ranks, one per shard
(`parallel/`), with the same command: without a launch in the environment
the CLI starts the k ranks itself on this host (rendezvous in a temporary
file store) and returns rank 0's results; under torchrun (or the JAX
package's COORDINATOR_ADDRESS / NUM_PROCESSES / PROCESS_ID) each process
is one rank, and the world size must be k.  The backend is NCCL, one card
per rank; `--dist_backend=gloo` names gloo (ranks on the CPU with
`--device=cpu`, or several ranks sharing the cards).

    torchrun --nproc_per_node=4 -m infomax3d_tpu_torch.cli.train --config=configs_clean/pre-train_QM9.yml --n_shards=4

The partitioned modes (`graph_shards: k`, the edges of each batch cut
over k ranks; `node_shards: k`, its nodes) run ``n_shards x k`` ranks the
same way, on the non-CSR batch (`parallel/`); the JAX CLI's refusals of
their combinations are reproduced (`check_parallel_modes`).
`node_el_pad` / `node_halo_pad` override the node shards' pads.

Tensor parallelism (`model_shards: k`, `parallel/tp.py`) runs ``n_shards
x k`` ranks the same way on one (data, model) grid: each rank holds the
column shards of the sharded parameters, their masters and Adam moments,
and every model rank of a data shard runs the whole forward on the same
batch, so it saves memory per rank and does not make a step faster.  It
excludes the partitioned modes (ValueError, as the JAX CLI).

    python -m infomax3d_tpu_torch.cli.train --config=configs_clean/pre-train_synthetic.yml --device=cpu --model_shards=2 --dist_backend=gloo
"""
from __future__ import annotations

import argparse
import ast
import os
import pickle
import tempfile
from concurrent.futures import ThreadPoolExecutor
from datetime import datetime
from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch
import torch.distributed as dist

from infomax3d_tpu_torch.cli.config import check_device, load_config
from infomax3d_tpu_torch.data.splits import (get_idx_split,
                                             get_random_indices,
                                             reference_split_indices)
from infomax3d_tpu_torch.device import resolve_device
from infomax3d_tpu_torch.interop import flax_paths
from infomax3d_tpu_torch.utils.setup import seed_all


def build_metrics(args: Dict[str, Any], dataset=None) -> Dict[str, Any]:
    """Reference metrics_dict (train.py:237-269) + dataset-specific
    additions."""
    from infomax3d_tpu_torch.train import metrics as M
    table = {
        "rsquared": M.Rsquared(),
        "mae": M.MAE(),
        "pearsonr": M.PearsonR(),
        "pcqm4m": M.PCQM4MEvaluatorWrapper(),
        "conformer_3d_variance": M.Conformer3DVariance(),
        "conformer_2d_variance": M.Conformer2DVariance(),
        "positive_similarity": M.PositiveSimilarity(),
        "positive_similarity_multiple_positives_separate2d":
            M.PositiveSimilarityMultiplePositivesSeparate2d(),
        "positive_prob": M.PositiveProb(),
        "negative_prob": M.NegativeProb(),
        "negative_similarity": M.NegativeSimilarity(),
        "negative_similarity_multiple_positives_separate2d":
            M.NegativeSimilarityMultiplePositivesSeparate2d(),
        "contrastive_accuracy": M.ContrastiveAccuracy(threshold=0.5009),
        "true_negative_rate": M.TrueNegativeRate(threshold=0.5009),
        "true_positive_rate": M.TruePositiveRate(threshold=0.5009),
        "uniformity": M.Uniformity(t=2),
        "alignment": M.Alignment(alpha=2),
        "batch_variance": M.BatchVariance(),
        "dimension_covariance": M.DimensionCovariance(),
    }
    ogb_metrics = {
        "ogbg-molhiv": ("rocauc", 1), "ogbg-molpcba": ("ap", 128),
        "ogbg-molbace": ("rocauc", 1), "ogbg-molbbbp": ("rocauc", 1),
        "ogbg-molclintox": ("rocauc", 2), "ogbg-moltoxcast": ("rocauc", 617),
        "ogbg-moltox21": ("rocauc", 12), "ogbg-mollipo": ("rmse", 1),
        "ogbg-molmuv": ("ap", 17), "ogbg-molsider": ("rocauc", 27),
        "ogbg-molfreesolv": ("rmse", 1), "ogbg-molesol": ("rmse", 1),
    }
    for name, (metric, tasks) in ogb_metrics.items():
        table[name] = M.OGBEvaluator(d_name=name, metric=metric,
                                     num_tasks=tasks)
    has_stats = dataset is not None and \
        getattr(dataset, "targets_mean", None) is not None

    def _denorm(cls, **kw):
        return cls(means=dataset.targets_mean, stds=dataset.targets_std,
                   ev2mev=getattr(dataset, "ev2mev", None), **kw)
    wanted = {}
    for name in args["metrics"]:
        if name == "mean_predictor_loss":
            # reference train.py:265: MeanPredictorLoss(loss_func(**params))
            from infomax3d_tpu_torch.losses import get_loss
            wanted[name] = M.MeanPredictorLoss(
                get_loss(args["loss_func"], **(args.get("loss_params") or {})))
        elif name == "qm9_properties" and has_stats:
            # reference train.py:600-605: one denormalized-L1 per target
            for ti, task in enumerate(getattr(dataset, "target_tasks", [])):
                wanted[task] = _denorm(M.QM9SingleTargetDenormalizedL1,
                                       task_index=ti)
        elif name in table:
            wanted[name] = table[name]
        elif name == "mae_denormalized" and has_stats:
            wanted[name] = _denorm(M.QM9DenormalizedL1)
        elif name == "mse_denormalized" and has_stats:
            wanted[name] = _denorm(M.QM9DenormalizedL2)
    if args["main_metric"] == "mae_denormalized" and \
            "mae_denormalized" not in wanted and has_stats:
        wanted["mae_denormalized"] = _denorm(M.QM9DenormalizedL1)
    return wanted


# all geomol fine-tune dataset names the reference dispatches
# (train.py:290-312)
GEOMOL_FINETUNE_SETS = (
    "bace_geomol", "bbbp_geomol", "bace_geomol_random", "bbbp_geomol_random",
    "esol_geomol", "lipo_geomol", "bace_geomol_qm9_featurization",
    "bbbp_geomol_qm9_featurization", "esol_geomol_qm9_featurization",
    "lipo_geomol_qm9_featurization",
)


def build_dataset(args: Dict[str, Any]):
    """Dataset dispatch, name-compatible with the reference
    (`train.py:271-287` routing into the per-family functions
    `train.py:289-612`), as the JAX package routes it.  Every family
    resolves to a prebuilt flat .npz cache under $INFOMAX3D_DATA (default
    `dataset`, built by data/preprocess.py); the file_loader_* names
    stream GEOM pickles directly when RDKit is present
    (data/file_loader.py), else fall back to their cache."""
    from infomax3d_tpu_torch.data.cached import (CachedMoleculeDataset,
                                                 GeomolFineTuneDataset,
                                                 QM9Dataset,
                                                 SyntheticDataset)
    name = args["dataset"]
    if name == "molhiv":
        # configs/pna_original_simple_molhiv.yml falls through every branch
        # of the reference's routing; its evident intent is ogbg-molhiv
        name = args["dataset"] = "ogbg-molhiv"
    params = dict(args.get("dataset_params") or {})
    data_dir = os.environ.get("INFOMAX3D_DATA", "dataset")
    needs_conformers = any("conform" in str(r) for r in args["required_data"]) \
        or "conformer" in args["collate_function"].lower()
    n_conf = args["num_conformers"] if needs_conformers else 1
    if needs_conformers:
        n_conf = max(n_conf,
                     int((args.get("collate_params") or {})
                         .get("num_conformers", 0)))
    if any(str(r) == "complete_graph_random_conformer"
           for r in args["required_data"]):
        params.setdefault("random_conformer", True)
        n_conf = 1
    if name == "synthetic":
        params.setdefault("num", 2000)
        params.setdefault("num_targets", max(len(args["targets"]), 1))
        params.setdefault("num_conformers", n_conf)
        return SyntheticDataset(**params)
    if name in GEOMOL_FINETUNE_SETS:
        return GeomolFineTuneDataset(
            os.path.join(data_dir, name, "processed.npz"), name)
    if name in ("qm9", "qm9_rdkit", "qm9_neuralconf"):
        # the variants differ only in where the conformers came from:
        # separate caches, same serving code
        sub = {"qm9": "QM9", "qm9_rdkit": "QM9_rdkit",
               "qm9_neuralconf": "QM9_neuralconf"}[name]
        return QM9Dataset(os.path.join(data_dir, sub, "processed.npz"),
                          target_tasks=args["targets"] or ["homo"],
                          num_conformers=n_conf)
    if name in ("qm9_geomol_feat", "qm9_geomol"):
        return QM9Dataset(os.path.join(data_dir, "qm9_geomol",
                                       "processed.npz"),
                          target_tasks=args["targets"] or ["homo"],
                          num_conformers=n_conf)
    if name in ("file_loader_qm9", "file_loader_drugs", "ot_pyg_geom_qm9"):
        # ot_pyg_geom_qm9 is the in-memory variant of file_loader_qm9: one
        # serving path
        split = "qm9" if name.endswith("qm9") else "drugs"
        pickle_root = os.path.join(
            data_dir, "GEOM_drugs" if split == "drugs" else "GEOM_qm9")
        try:
            from infomax3d_tpu_torch.data.file_loader import GeomFileLoader
            if os.path.exists(os.path.join(pickle_root,
                                           f"summary_{split}.json")):
                return GeomFileLoader(
                    pickle_root, split=split,
                    num_conformers=args["num_conformers"], **params)
        except ImportError:
            pass
        return CachedMoleculeDataset(
            os.path.join(data_dir, name, "processed.npz"),
            num_conformers=args["num_conformers"], **params)
    cache_names = {"qmugs": "QMugs", "drugs": "GEOM_Drugs",
                   "geom_qm9": "GEOM_QM9", "zinc": "ZINC"}
    if name in cache_names:
        return CachedMoleculeDataset(
            os.path.join(data_dir, cache_names[name], "processed.npz"),
            num_conformers=n_conf, **params)
    if name.startswith("ogbg") or name == "pcqm4m":
        return CachedMoleculeDataset(
            os.path.join(data_dir, name.replace("-", "_"), "processed.npz"),
            **params)
    raise KeyError(f"unknown dataset '{name}'")


def apply_dataset_protocol(args: Dict[str, Any], dataset) -> None:
    """Per-family arg mutations the reference drivers perform before
    building the trainer (ogbg: `train.py:448-452`; geomol fine-tune sets:
    `train.py:340-344`; pcqm4m: `train.py:419-421`)."""
    name = args["dataset"]
    if name.startswith("ogbg"):
        if name not in args["metrics"]:
            args["metrics"] = list(args["metrics"]) + [name]
        args["main_metric"] = name
        args["val_per_batch"] = False
        rmse = name in ("ogbg-mollipo", "ogbg-molfreesolv", "ogbg-molesol")
        args["main_metric_goal"] = "min" if rmse else "max"
    elif name in GEOMOL_FINETUNE_SETS:
        metric_name = dataset.ogb_metric_name
        if metric_name not in args["metrics"]:
            args["metrics"] = list(args["metrics"]) + [metric_name]
        args["main_metric"] = metric_name
        args["val_per_batch"] = False
        rmse = metric_name in ("ogbg-mollipo", "ogbg-molfreesolv",
                               "ogbg-molesol")
        args["main_metric_goal"] = "min" if rmse else "max"
    elif name == "pcqm4m":
        if "pcqm4m" not in args["metrics"]:
            args["metrics"] = list(args["metrics"]) + ["pcqm4m"]
        args["main_metric"] = "pcqm4m"
        args["main_metric_goal"] = "min"


FLAT_COLLATES = {
    "graph_collate", "graph_only_collate", "contrastive_collate",
    "contrastive_collate_ae", "conformer_collate", "graphcl_collate",
    "node_drop_3d_collate", "node_drop_2d3d_collate",
    "noised_distances_collate", "noised_coordinates_collate",
    "pairwise_distance_collate",
}
# the flat collates the JAX package batches without CSR arrays where
# `csr_buckets` is off (its `flat_collates`); the others keep their CSR
# buckets
NON_CSR_COLLATES = FLAT_COLLATES - {"pairwise_distance_collate"}
# the collates the node-sharded mode takes (JAX cli/train.py:690-698)
NODE_SHARD_COLLATES = ("graph_collate", "graph_only_collate",
                       "contrastive_collate", "contrastive_collate_ae",
                       "conformer_collate")


def resolve_fast_paths(args: Dict[str, Any]) -> None:
    """Resolve the batch-layout knobs once (read by build_models and
    make_loaders), on every device as the JAX CLI on an accelerator:

    * ``_csr`` (receiver-sorted CSR batches, the kernels' path) is on for
      the flat collates with ``csr_buckets`` 'auto' or True; ``False``
      turns it off for the JAX package's flat collates
      (`NON_CSR_COLLATES`), whose batch then takes the segment path;
    * ``_dense_3d`` (Net3DDense on the dense 3D batch) is on for a Net3D /
      Net3DDense 3D model with `contrastive_collate`, unless the config
      sets ``dense_3d: False``, which runs the flat Net3D on the complete
      graph; `conformer_collate` always runs the flat Net3D.
    The partitioned modes (``graph_shards``, ``node_shards`` > 1) turn
    both off, as the JAX CLI does (cli/train.py:252-261): their shards
    index local orderings, and the segment path carries the completions."""
    if args.get("graph_shards", 1) > 1 or args.get("node_shards", 1) > 1:
        args["csr_buckets"] = False
        args["dense_3d"] = False
    collate = args.get("collate_function")
    args["_csr"] = collate in FLAT_COLLATES and not (
        args.get("csr_buckets", "auto") is False
        and collate in NON_CSR_COLLATES)
    eligible = (args.get("model3d_type") in ("Net3D", "Net3DDense") and
                args.get("collate_function") == "contrastive_collate")
    args["_dense_3d"] = (eligible
                         and args.get("dense_3d", "auto") is not False)


# the models whose input width the JAX module infers from the data (flax
# `Dense`), and the field that holds it here: the batch's node features
INPUT_WIDTH = {"EGNN": "node_dim", "EGNNTorch": "in_node_nf"}
# the OGB atom codes of the synthetic and cached molecules
ATOM_CODES = 9


def _with_feature_dims(name: str, mp: Dict[str, Any], dataset
                       ) -> Dict[str, Any]:
    """`mp` with a model's `node_dim` / `edge_dim` fields, where the config
    leaves them out, read off the dataset's first 2D graph (its feature
    matrices' widths), as the JAX CLI's `_adapt_model_params` infers them
    (GeomolGNNWrapper on `qm9_geomol`'s float features)."""
    from infomax3d_tpu_torch.models.registry import (JAX_FIELDS,
                                                     MODEL_ALIASES)
    fields = JAX_FIELDS.get(MODEL_ALIASES.get(name, name), ())
    if dataset is None or not {"node_dim", "edge_dim"} & set(fields):
        return mp
    mp = dict(mp)
    g0 = dataset[0]["graph2d"]
    for field, key in (("node_dim", "node_feat"), ("edge_dim", "edge_feat")):
        feat = g0.get(key)
        if field in fields and field not in mp and feat is not None \
                and feat.ndim == 2:
            mp[field] = int(feat.shape[1])
    return mp


def _with_input_width(name: str, mp: Dict[str, Any], dataset,
                      view: str) -> Dict[str, Any]:
    """`mp` with the input width of `INPUT_WIDTH`'s models set from the
    dataset's first item (its `view`'s node features; the atom codes'
    width without a dataset), as flax infers it; for the other 2D models
    `_with_feature_dims`."""
    if name not in INPUT_WIDTH:
        return _with_feature_dims(name, mp, dataset) \
            if view == "graph2d" else mp
    width = ATOM_CODES
    if dataset is not None:
        feat = dataset[0][view]["node_feat"]
        width = int(feat.shape[1]) if feat.ndim == 2 else 1
    return dict(mp, **{INPUT_WIDTH[name]: width})


def _byol_wrap(type_name: str, params: Mapping[str, Any], dataset,
               view: str):
    """The BYOL wrapper the JAX CLI's `_byol_wrap` builds: a config names
    the wrapper with the wrapped `model_type` / `model_parameters` nested
    inside (configs/byol.yml), or names the wrapped model itself under
    the byol trainer (its parameters then the model's, the predictor's at
    their defaults)."""
    from infomax3d_tpu_torch.models.registry import build_model
    inner_type = params.get("model_type", type_name)
    inner = params.get("model_parameters") or (
        {} if inner_type != type_name else params)
    wp = {k: v for k, v in params.items()
          if k not in ("model_type", "model_parameters")}
    wp.update(model_type=inner_type, model_parameters=_with_input_width(
        inner_type, dict(inner), dataset, view))
    return build_model("BYOLwrapper", wp)


def build_models(args: Dict[str, Any], dataset=None
                 ) -> Dict[str, torch.nn.Module]:
    """The config's models as the port's modules (`models/registry.py`),
    built with torch's default initialization under the seeded global
    generator.  Under the byol trainer, or where a config names
    ``BYOLwrapper``, each model is a BYOL wrapper (`_byol_wrap`); the 3D
    side is then the flat Net3D on the CSR complete graph, since the
    wrapper is not a Net3D (`resolve_fast_paths`), as in JAX."""
    from infomax3d_tpu_torch.models.registry import build_model
    byol = args["trainer"] == "byol"
    models = {}
    for key, view in (("model", "graph2d"), ("model3d", "graph3d")):
        name = args.get(f"{key}_type")
        if not name:
            continue
        mp = args.get(f"{key}_parameters") or {}
        if name == "BYOLwrapper" or byol:
            models[key] = _byol_wrap(name, mp, dataset, view)
            continue
        if key == "model3d" and args.get("_dense_3d") and name == "Net3D":
            name = "Net3DDense"       # parameter-compatible dense path
        models[key] = build_model(name, _with_input_width(name, mp, dataset,
                                                          view))
    if args.get("critic_type"):
        # flax infers the critic's input width at init, where the JAX
        # philosophy trainer feeds it `critic_in_dim` columns
        models["critic"] = build_model(
            args["critic_type"], args.get("critic_parameters") or {},
            in_dim=int(args.get("critic_in_dim", 256)))
    return models


def transfer_pretrained(trainer, args: Dict[str, Any]) -> int:
    """Pre-trained weight transfer (reference load_model, train.py:
    207-231) from a port / reference `.pt` checkpoint or a JAX package
    flax-msgpack one (`train/torch_interop.py`) into the trainer's
    ``model``: each parameter and running statistic whose name contains a
    `transfer_layers` token and no `exclude_from_transfer` token (nor
    'teacher'), and whose shape matches the source's, is copied.  Tokens
    are substrings of torch's dot-joined names; they are matched on each
    tensor's flax path ('.' read as '/', BatchNorm spelled both
    'MaskedBatchNorm' and 'batch_norm'), so the selection equals the JAX
    package's.  `transfer_3d` takes the source's 3D network.  Prints and
    returns the number of parameter tensors transferred."""
    from infomax3d_tpu_torch.parallel import tp
    from infomax3d_tpu_torch.train import torch_interop as ti
    from infomax3d_tpu_torch.train.checkpoint import load_checkpoint
    path = args["pretrain_checkpoint"]
    key = "model3d" if args.get("transfer_3d") else "model"
    model = trainer.models["model"]
    paths = flax_paths(model, running_stats=True)
    if ti.is_torch_checkpoint(path):
        src = ti.rename_torch_keys(
            load_checkpoint(path).get(f"{key}_state_dict") or {})
    else:
        src = ti.flax_transfer_source(ti.load_jax_checkpoint(path), key,
                                      paths)
    transfer = [t.replace(".", "/") for t in (args["transfer_layers"] or [])]
    exclude = [t.replace(".", "/") for t in
               (args["exclude_from_transfer"] or [])] + ["teacher"]
    params = dict(model.named_parameters())
    tensors = {**dict(model.named_buffers()), **params}
    n_hit = 0
    with torch.no_grad():
        for name, fpath in paths.items():
            s = fpath + "|" + fpath.replace("MaskedBatchNorm", "batch_norm")
            if not (any(t in s for t in transfer)
                    and not any(x in s for x in exclude)):
                continue
            dst = tensors[name]
            # a tensor-parallel rank copies its part of each sharded leaf
            if name in src and tuple(src[name].shape) == tp.whole_shape(
                    model, name, dst):
                dst.copy_(tp.shard_of(model, name, src[name]).to(
                    dst.device, dst.dtype))
                n_hit += name in params
    print(f"transferred {n_hit} parameter tensors from {path}")
    return n_hit


def make_splits(args: Dict[str, Any], dataset):
    """(train_idx, val_idx, test_idx) per the reference's per-family
    protocol: scaffold `get_idx_split` for OGB sets (train.py:428-440),
    stored splits for pre-split sets (ZINC, geomol fine-tune, pcqm4m),
    family-parameterized random splits otherwise (data/splits.py)."""
    name = args["dataset"]
    n = len(dataset)
    if name.startswith("ogbg"):
        split = get_idx_split(dataset, getattr(dataset, "cache_dir", None))
        if args.get("force_random_split"):
            all_idx = get_random_indices(n, args["seed_data"])
            nt, nv = len(split["train"]), len(split["valid"])
            split = {"train": all_idx[:nt], "valid": all_idx[nt:nt + nv],
                     "test": all_idx[nt + nv:]}
        return split["train"], split["valid"], split["test"]
    stored = getattr(dataset, "split_indices", None)
    if stored:
        tr = stored["train"]
        if name == "pcqm4m" and args["num_train"] > 0:
            tr = tr[: args["num_train"]]     # reference train.py:402
        return tr, stored["valid"], stored["test"]
    return reference_split_indices(args, n)


def make_loaders(args: Dict[str, Any], dataset, rank: int = 0, grid=None):
    """Train / validation / test `GraphDataLoader`s of data-parallel shard
    `rank` (of `n_shards`; the whole batch for one): one static bucket
    (CSR where ``_csr``, as the JAX CLI sizes it otherwise) sized to cover
    a random batch with overwhelming probability (`_cap`), and for a flat
    3D side or a pair view one for its complete graphs (CSR: `max_deg` the
    largest n - 1; C times as large for `conformer_collate`); shuffled
    train batches (seed `seed`) or, with `train_sampler`, the batches of a
    size-clustered sampler (data/samplers.py); full batches for the
    contrastive collates.  The dense collates take the bucket's graph
    count and `max_nodes` slots per graph; `smp_collate` takes a radius
    graph bucket (in-degree below the largest molecule) and a triplet
    count sized from a sample.  With `n_shards` > 1 every loader drops
    partial batches and each shard collates its slice into the buckets
    cut `n_shards` ways (`GraphDataLoader`).  `bucket_ladder` replaces the
    bucket by a ladder where the JAX CLI builds one.  Given a `grid` (the
    partitioned modes), `rank` is its data index and each rank's graph
    views are cut to its edge or node shard (`partition_collate`)."""
    from infomax3d_tpu_torch.data.loader import (DENSE_COLLATES,
                                                 GraphDataLoader,
                                                 get_collate,
                                                 partition_collate)
    from infomax3d_tpu_torch.graphs.batch import (BucketSpec,
                                                  make_bucket_ladder)

    train_idx, val_idx, test_idx = make_splits(args, dataset)
    bs = args["batch_size"]
    nodes = dataset.node_counts()
    max_n = int(nodes.max())

    def _cap(per_mol, granularity, slack=1.1, n_sigma=5.0):
        """Static bucket size covering a random batch of `bs` molecules:
        mean + n_sigma x batch std + one max-size molecule, rounded up to
        the granularity."""
        per_mol = np.asarray(per_mol, np.float64)
        need = (bs * per_mol.mean() * slack
                + n_sigma * np.sqrt(bs) * per_mol.std() + per_mol.max())
        return int(np.ceil(need / granularity) * granularity)

    n_cap, e3_cap = _cap(nodes, 256), _cap(nodes * (nodes - 1), 2048)
    collate = args["collate_function"]
    # the non-flat collates keep their CSR buckets; a non-CSR bucket has
    # no degree bound (the JAX CLI's BucketSpec(bs, n_cap, e_cap, nmax))
    csr = args.get("_csr", True) or collate not in FLAT_COLLATES
    bucket = BucketSpec(bs, n_cap, _cap(dataset.edge_counts(), 512),
                        max_deg=int(dataset.max_in_degree()) if csr else 0,
                        csr=csr, nmax=max_n)
    ckw = dict(args.get("collate_params") or {})
    contrastive = collate in ("contrastive_collate", "conformer_collate",
                              "contrastive_collate_ae")
    if collate == "smp_collate":
        # the radius graph (cutoff 5 angstrom by default) is denser than the
        # bond graph and sparser than the complete graph: size its edges
        # and triplets from a sample of 32 molecules with 2x headroom (JAX
        # cli/train.py:513-540; a batch that still overflows raises:
        # set collate_params.n_triplets)
        from infomax3d_tpu_torch.data.smp_featurize import smp_featurize
        cutoff = float(ckw.get("cutoff", 5.0))
        sample = np.linspace(0, len(dataset) - 1,
                             num=min(32, len(dataset))).astype(int)
        se, st = [], []
        for i in sample:
            it = dataset[int(i)]
            mol = it["graph2d"] if "coords" in it["graph2d"] else \
                it["graph3d"]
            f = smp_featurize(mol["coords"], cutoff=cutoff)
            se.append(len(f["senders"]))
            st.append(int(f["tri_count"]))
        bucket = BucketSpec(bs, n_cap, min(_cap(se, 512, slack=2.0), e3_cap),
                            max_deg=max(max_n - 1, 1), csr=True, nmax=max_n)
        ckw.setdefault("n_triplets", _cap(st, 2048, slack=2.0))

    def bucket3d(copies):
        if not csr:
            # the JAX CLI's: the readout regroup for one conformer, the
            # segment readout for C (cli/train.py:505, :547)
            return BucketSpec(bs * copies, n_cap * copies, e3_cap * copies,
                              nmax=max_n if copies == 1 else 0)
        return BucketSpec(bs * copies, n_cap * copies, e3_cap * copies,
                          max_deg=max(max_n - 1, 1), csr=True, nmax=max_n)
    if collate == "conformer_collate":
        # one conformer count for the packing and the bucket: the
        # dataset's, capped by collate_params.num_conformers (the JAX
        # package's cli/train.py:537-547)
        C = max(int(getattr(dataset, "num_conformers",
                            args["num_conformers"])), 1)
        if ckw.get("num_conformers"):
            C = min(C, int(ckw["num_conformers"]))
        ckw["num_conformers"] = C
        ckw.setdefault("bucket3d", bucket3d(C))
    elif args.get("_dense_3d") and collate == "contrastive_collate":
        ckw.setdefault("dense_3d", True)
        ckw.setdefault("max_nodes3d", max_n)
    elif collate in ("contrastive_collate", "contrastive_collate_ae",
                     "pairwise_distance_collate"):
        ckw.setdefault("bucket3d", bucket3d(1))
        if collate == "pairwise_distance_collate" and any(
                str(r) == "complete_graph3d" for r in args["required_data"]):
            # the pair view is the model's input (JAX cli/train.py:550-552)
            ckw.setdefault("graph_3d", True)
    if collate in DENSE_COLLATES:
        # the larger of the config's max_nodes and the largest molecule
        # (JAX cli/train.py:556-558)
        ckw.setdefault("max_nodes", max(args["max_nodes"], max_n))
    if collate == "ot_collate":
        hp = (args.get("model_parameters") or {}).get("hyperparams") or {}
        ckw.setdefault("n_true_confs",
                       int(hp.get("n_true_confs", args["num_conformers"])))
    n_shards = int(args.get("n_shards", 1))
    # `bucket_ladder: true`: a per-batch bucket from a small ladder of
    # non-CSR shapes (less padding), where the JAX CLI builds one
    # (cli/train.py:567-579); elsewhere it says so once
    ladder = None
    if args.get("bucket_ladder"):
        if not args.get("_csr") and n_shards == 1 and collate in (
                "graph_collate", "graph_only_collate"):
            ladder = make_bucket_ladder(bs, nodes, dataset.edge_counts(),
                                        nmax=max_n)
            bucket = None
        else:
            print("bucket_ladder: unused (the JAX CLI builds the ladder "
                  "only for graph_collate / graph_only_collate without CSR "
                  "buckets and without n_shards); one static bucket")

    collate_fn = get_collate(collate)
    if grid is not None and grid.mode == "edge":
        from infomax3d_tpu_torch.parallel.edge_partition import \
            shard_batch_edges
        collate_fn = partition_collate(
            collate_fn, lambda v: shard_batch_edges(v, grid.k,
                                                    grid.graph_index))
    elif grid is not None and grid.mode == "node":
        # static pads per bucket, as the JAX CLI's (cli/train.py:581-603):
        # edges at 1.5x the even split, the halo at one largest molecule
        # per round
        from infomax3d_tpu_torch.parallel.node_partition import \
            shard_graph_batch
        halo_pad = int(args.get("node_halo_pad") or
                       int(np.ceil(max_n / 8) * 8))

        def node_cut(v):
            el_pad = int(args.get("node_el_pad") or int(np.ceil(
                v["senders"].shape[0] * 1.5 / grid.k / 8) * 8))
            return shard_graph_batch(v, grid.k, grid.graph_index, el_pad,
                                     halo_pad)
        collate_fn = partition_collate(collate_fn, node_cut)

    def mk(indices, shuffle, seed, batch_sampler=None):
        return GraphDataLoader(dataset, bs, collate_fn, bucket=bucket,
                               shuffle=shuffle, drop_last=contrastive,
                               seed=seed, indices=indices,
                               collate_kwargs=ckw,
                               batch_sampler=batch_sampler,
                               n_shards=n_shards, shard=rank, ladder=ladder)

    sampler = None
    if args.get("train_sampler"):
        # reference train.py:470-473 / 535-540: the train loader takes a
        # size-clustered batch sampler
        from infomax3d_tpu_torch.data import samplers
        sampler_cls = getattr(samplers, args["train_sampler"], None)
        if sampler_cls is None:
            raise KeyError(f"unknown train_sampler '{args['train_sampler']}'")
        sampler = sampler_cls(nodes, bs, indices=train_idx,
                              seed=args["seed"],
                              drop_last=contrastive or n_shards > 1)

    return (mk(train_idx, True, args["seed"], batch_sampler=sampler),
            mk(val_idx, False, args["seed"] + 1),
            mk(test_idx, False, args["seed"] + 2))


def resolve_collate(args: Dict[str, Any]) -> None:
    """Canonicalize the config's collate name and apply the reference's
    routing rules (aliases; `san_graph` -> san_collate; OT configs ->
    ot_collate; SMP -> smp_collate)."""
    from infomax3d_tpu_torch.data.loader import COLLATE_ALIASES
    args["collate_function"] = COLLATE_ALIASES.get(
        args["collate_function"], args["collate_function"])
    if any(str(r) == "san_graph" for r in args["required_data"]) and \
            args["collate_function"] == "graph_collate":
        args["collate_function"] = "san_collate"
    if args["trainer"] == "optimal_transport" and \
            args["collate_function"] in ("graph_only_collate",
                                         "graph_collate"):
        args["collate_function"] = "ot_collate"
    if args["model_type"] == "SMP" and \
            args["collate_function"] == "graph_collate":
        args["collate_function"] = "smp_collate"


def trainer_class(args: Dict[str, Any]):
    """The trainer class of a resolved config (reference get_trainer,
    train.py:166-204): the SSL flavour only applies with a 3D model;
    otherwise the supervised Trainer."""
    from infomax3d_tpu_torch.train.trainer import get_trainer_class
    if args.get("model3d_type"):
        return get_trainer_class(args["trainer"])
    if args["trainer"] in ("graphcl_trainer", "distance_predictor",
                           "optimal_transport"):
        return get_trainer_class(args["trainer"])
    if args["collate_function"] == "pairwise_distance_collate":
        return get_trainer_class("distance_predictor")
    return get_trainer_class("default")


def grid_mode(args: Dict[str, Any]):
    """(mode, k) of the grid's second axis: ("edge", graph_shards),
    ("node", node_shards), ("model", model_shards), or (None, 1)."""
    if int(args.get("graph_shards", 1)) > 1:
        return "edge", int(args["graph_shards"])
    if int(args.get("node_shards", 1)) > 1:
        return "node", int(args["node_shards"])
    if int(args.get("model_shards", 1)) > 1:
        return "model", int(args["model_shards"])
    return None, 1


def check_parallel_modes(args: Dict[str, Any]) -> None:
    """The JAX CLI's refusals (cli/train.py:686-716), each with its
    exception type, on a resolved config: the two partitions together,
    `node_shards`' collates and pairwise distances, `model_shards` with a
    partition."""
    graph_shards = int(args.get("graph_shards", 1))
    node_shards = int(args.get("node_shards", 1))
    if graph_shards > 1 and node_shards > 1:
        raise ValueError("graph_shards (edge partitioning) and node_shards "
                         "(node-sharded halo partitioning) both claim the "
                         "'graph' axis — pick one")
    if node_shards > 1:
        if args.get("collate_function") not in NODE_SHARD_COLLATES:
            raise ValueError("node_shards currently supports the pure-"
                             "GraphBatch collates (graph_collate, "
                             "graph_only_collate, contrastive_collate[_ae], "
                             "conformer_collate)")
        if (args.get("model_parameters") or {}).get("pairwise_distances"):
            raise NotImplementedError(
                "node_shards: PNA pairwise_distances gathers coords by "
                "sender inside the model — ghost coordinates are not "
                "exchanged on that path")
    if int(args.get("model_shards", 1)) > 1:
        if graph_shards > 1 or node_shards > 1:
            raise ValueError("model_shards cannot combine with graph_shards/"
                             "node_shards — pick one graph-parallel mode")


def run_training(args: Dict[str, Any], device=None,
                 init_variables: Optional[Mapping[str, Mapping]] = None,
                 group=None, grid=None) -> Dict[str, float]:
    """One training run.  `device` wins over `args["device"]`; with both
    None the run goes to the CUDA card (and raises without one).
    `init_variables` maps model keys to flax numpy trees to start from
    (otherwise torch's default initialization, seeded by `seed`).  With
    `n_shards` > 1 (or a partitioned mode) and no `group` / `grid`,
    `run_data_parallel` starts (or joins) the ranks; given the
    data-parallel `group` or the partitioned run's `grid`, this is one
    rank's run (`device` its device), and only rank 0 writes the run
    directory."""
    resolve_collate(args)
    check_parallel_modes(args)
    parallel = int(args.get("n_shards", 1)) > 1 or grid_mode(args)[1] > 1
    if parallel and group is None and grid is None:
        return run_data_parallel(args, device, init_variables)
    check_device(args.get("device"))
    if group is None and grid is None:
        check_device(device)
    device = resolve_device(device if device is not None
                            else args.get("device"))
    seed_all(args["seed"])
    from infomax3d_tpu_torch.losses import SUPERVISED_LOSSES, get_loss

    dataset = build_dataset(args)
    apply_dataset_protocol(args, dataset)
    metrics = build_metrics(args, dataset)
    resolve_fast_paths(args)
    loss_name = args["loss_func"]
    loss_func = None if loss_name in SUPERVISED_LOSSES else \
        get_loss(loss_name, **(args.get("loss_params") or {}))
    trainer_cls = trainer_class(args)
    models = build_models(args, dataset)
    world = grid.step if grid is not None else group
    rank = 0 if world is None else dist.get_rank(world)
    run_dir = [None]
    if rank == 0:
        run_dir[0] = _claim_run_dir(args)
    if world is not None:
        dist.broadcast_object_list(run_dir, src=dist.get_global_rank(
            world, 0), group=world)
    run_dir = run_dir[0]
    kw: Dict[str, Any] = {}
    if args["trainer"] == "philosophy":
        kw["critic_loss"] = get_loss(args["critic_loss"],
                                     **(args.get("critic_loss_params") or {}))
    if args["trainer"] == "byol":
        # the 2D wrapper's `ma_decay` (JAX cli/train.py:775-779); only the
        # 2D teacher moves by EMA unless `byol_ema_all`
        kw["ma_decay"] = (args.get("model_parameters") or {}).get(
            "ma_decay", 0.99)
        kw["ema_all"] = bool(args.get("byol_ema_all", False))
    trainer = trainer_cls(
        models, args, metrics=metrics, main_metric=args["main_metric"],
        run_dir=run_dir, loss_func=loss_func, loss_name=loss_name,
        main_metric_goal=args["main_metric_goal"],
        scheduler_step_per_batch=args["scheduler_step_per_batch"],
        device=device, use_tensorboard=args.get("use_tensorboard", True),
        init_variables=init_variables, group=group, grid=grid, **kw)
    train_loader, val_loader, test_loader = make_loaders(
        args, dataset, rank if grid is None else grid.data_index, grid)
    if args.get("pretrain_checkpoint"):
        trainer.init_state(next(iter(train_loader)))
        transfer_pretrained(trainer, args)
    val_metrics = trainer.train(train_loader, val_loader)
    result = dict(val_metrics)
    if args["eval_on_test"] and len(test_loader.indices) > 0:
        test_metrics = trainer.evaluation(test_loader, "test")
        result.update({f"test_{k}": v for k, v in test_metrics.items()})
    trainer.write_timing()
    trainer.logger.close()
    return result


def _claim_run_dir(args: Dict[str, Any]) -> str:
    """Create the run's directory, named by model, dataset, experiment,
    seed and time, atomically (same-second runs would collide)."""
    run_dir = os.path.join(
        args["logdir"],
        f"{args['model_type']}_{args['dataset']}_{args['experiment_name']}_"
        f"{args['seed']}_{datetime.now().strftime('%d-%m_%H-%M-%S')}")
    base_run_dir, n_dup = run_dir, 1
    while True:
        try:
            os.makedirs(run_dir)
            return run_dir
        except FileExistsError:
            run_dir = f"{base_run_dir}_{n_dup}"
            n_dup += 1


def run_data_parallel(args: Dict[str, Any], device=None,
                      init_variables: Optional[Mapping[str, Mapping]] = None
                      ) -> Dict[str, float]:
    """The ranks of one run (module docstring): `n_shards` times the
    partition's k.  Under a launch in the environment
    (`parallel.multihost.launch_environment`) this process is one rank
    and the world size must be that count; otherwise the ranks start
    here, one process each, after the kernels are built once, and rank
    0's results are returned.  `dist_backend` (default "nccl") names the
    backend; NCCL with fewer cards than ranks raises."""
    from infomax3d_tpu_torch.parallel import (close_group,
                                              initialize_multihost,
                                              rank_devices)
    from infomax3d_tpu_torch.parallel.multihost import launch_environment
    k = int(args.get("n_shards", 1)) * grid_mode(args)[1]
    backend = args.get("dist_backend", "nccl")
    check_device(args.get("device"))
    check_device(device)
    dev = resolve_device(device if device is not None else args.get("device"))
    resolve_collate(args)
    refusal = trainer_class(args).NO_DATA_PARALLEL
    if refusal and (int(args.get("n_shards", 1)) > 1
                    or grid_mode(args)[0] != "model"):
        raise NotImplementedError(refusal)
    launch = launch_environment()
    if launch is not None:
        if launch["world"] != k:
            raise ValueError(f"the launch has {launch['world']} processes, "
                             f"the config n_shards x graph / node shards "
                             f"{k}: they must be equal")
        group, rank_dev = initialize_multihost(backend, dev.type)
        try:
            return _run_rank(args, rank_dev, init_variables, group)
        finally:
            close_group()
    rank_devices(k, backend, dev.type)
    if dev.type == "cuda":
        from infomax3d_tpu_torch.ops.kernels import _build
        _build.build_all()          # once, before the ranks start
    threads = max(1, torch.get_num_threads() // k)
    with tempfile.TemporaryDirectory(prefix="infomax3d_dp_") as tmp:
        torch.multiprocessing.start_processes(
            _rank_main, args=(k, backend, dev.type, args, init_variables,
                              tmp, threads),
            nprocs=k, start_method="spawn")
        with open(os.path.join(tmp, "result.pkl"), "rb") as f:
            return pickle.load(f)


def _run_rank(args: Dict[str, Any], device, init_variables, group):
    """This rank's run in the joined default `group`: data parallel, or
    under the (data, graph) grid of a partitioned mode or the (data,
    model) grid of tensor parallelism."""
    from infomax3d_tpu_torch.parallel import make_grid
    mode, k = grid_mode(args)
    if mode is None:
        return run_training(args, device, init_variables, group=group)
    grid = make_grid(int(args.get("n_shards", 1)), k, mode)
    return run_training(args, device, init_variables, grid=grid)


def _rank_main(rank: int, k: int, backend: str, device_type: str,
               args: Dict[str, Any], init_variables, tmp: str,
               threads: int) -> None:
    """One rank started by `run_data_parallel` (rendezvous in a file store
    under `tmp`; rank 0 leaves its results there)."""
    from infomax3d_tpu_torch.parallel import close_group, make_group
    torch.set_num_threads(threads)
    group, dev = make_group(k, rank, f"file://{tmp}/store", backend,
                            device_type)
    try:
        result = _run_rank(dict(args), dev, init_variables, group)
    finally:
        close_group()
    if rank == 0:
        with open(os.path.join(tmp, "result.pkl"), "wb") as f:
            pickle.dump(result, f)


def train(args: Dict[str, Any], device=None,
          init_variables: Optional[Mapping[str, Mapping]] = None):
    """Reference __main__ behaviour incl. the multi-seed thread pool
    (train.py:647-698)."""
    seeds = args.get("multithreaded_seeds") or []
    if not seeds:
        return run_training(args, device, init_variables)
    if int(args.get("n_shards", 1)) * grid_mode(args)[1] > 1:
        raise NotImplementedError(
            "multithreaded_seeds with several ranks: each seed's ranks "
            "would claim the same cards; run the seeds one after the other")
    with ThreadPoolExecutor(max_workers=len(seeds)) as ex:
        futures = []
        for s in seeds:
            a = dict(args)
            a["seed"] = s
            a["multithreaded_seeds"] = []
            futures.append(ex.submit(run_training, a, device,
                                     init_variables))
        results = [f.result() for f in futures]
    agg = {}
    keys = set().union(*[r.keys() for r in results])
    for k in keys:
        vals = np.array([r[k] for r in results if k in r], dtype=np.float64)
        agg[f"{k}_mean"] = float(np.nanmean(vals))
        agg[f"{k}_std"] = float(np.nanstd(vals))
        agg[f"{k}_stderr"] = float(np.nanstd(vals) / np.sqrt(len(vals)))
    os.makedirs(args["logdir"], exist_ok=True)
    with open(os.path.join(args["logdir"],
                           "multiple_seed_validation_statistics.txt"),
              "w") as f:
        for k in sorted(agg):
            f.write(f"{k}: {agg[k]}\n")
    print(agg)
    return agg


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--config", type=str, default=None)
    p.add_argument("--checkpoint", type=str, default=None)
    p.add_argument("--device", type=str, default=None,
                   help="cuda (the default) or cpu")
    known, unknown = p.parse_known_args(argv)
    overrides: Dict[str, Any] = {}
    if known.checkpoint:
        overrides["checkpoint"] = known.checkpoint
    for tok in unknown:
        if tok.startswith("--") and "=" in tok:
            k, v = tok[2:].split("=", 1)
            try:
                overrides[k] = ast.literal_eval(v)
            except (ValueError, SyntaxError):
                overrides[k] = v
    args = load_config(known.config, overrides)
    return train(args, device=known.device)


if __name__ == "__main__":
    main()
