"""Config system (port of `infomax3d_tpu/cli/config.py`): the reference's
argparse defaults with a YAML config laid over them, so the configs under
`configs/` and `configs_clean/` drive the port unmodified.  YAML is read by
the port's own `yaml_lite`.

Quirks kept from the reference:
- list-valued YAML entries APPEND to the default list rather than replacing
  it (reference train.py:620-625),
- a checkpoint's saved `train_arguments.yaml` re-hydrates args, with the
  explicit config winning (train.py:629-639).

Every key of the JAX package's `DEFAULTS` is here.  One default differs:
`device` is None, which the CLI hands to `device.resolve_device` (the CUDA
card, raising when there is none); "cuda" and "cpu" are taken as given and
any other value raises (`check_device`).
"""
from __future__ import annotations

import copy
import os
from typing import Any, Dict, Optional

from infomax3d_tpu_torch.cli import yaml_lite

DEFAULTS: Dict[str, Any] = dict(
    config=None,
    experiment_name="",
    logdir="runs",
    num_epochs=2500,
    batch_size=1024,
    patience=20,
    minimum_epochs=0,
    dataset="qm9",
    num_train=-1,
    seed=123,
    num_val=None,
    multithreaded_seeds=[],
    seed_data=123,
    loss_func="MSELoss",
    loss_params={},
    critic_loss="MSELoss",
    critic_loss_params={},
    optimizer="Adam",
    optimizer_params=None,
    lr_scheduler=None,
    lr_scheduler_params=None,
    scheduler_step_per_batch=True,
    log_iterations=-1,
    expensive_log_iterations=100,
    eval_per_epochs=0,
    linear_probing_samples=500,
    num_conformers=3,
    metrics=[],
    main_metric="mae_denormalized",
    main_metric_goal="min",
    val_per_batch=True,
    tensorboard_functions=[],
    checkpoint=None,
    pretrain_checkpoint=None,
    transfer_layers=[],
    frozen_layers=[],
    exclude_from_transfer=[],
    transferred_lr=None,
    num_epochs_local_only=1,
    required_data=[],
    collate_function="graph_collate",
    # fast-path knobs (not in the reference CLI): see
    # cli/train.py::resolve_fast_paths
    csr_buckets="auto",
    dense_3d="auto",
    # pick per-batch static shapes from a small ladder (less padding, a few
    # extra compiles) — plain flat collates only (cli/train.py::make_loaders)
    bucket_ladder=False,
    bf16_compute="auto",
    collate_params={},
    use_e_features=True,
    targets=[],
    # None: the CUDA card (device.resolve_device); "cuda" or "cpu"
    device=None,
    dist_embedding=False,
    num_radial=6,
    models_to_save=[],
    model_type="PNA",
    model_parameters=None,
    model3d_type=None,
    model3d_parameters=None,
    critic_type=None,
    critic_parameters=None,
    trainer="contrastive",
    train_sampler=None,
    eval_on_test=True,
    force_random_split=False,
    reuse_pre_train_data=False,
    transfer_3d=False,
    # JAX-package additions (absent keys in reference configs are fine)
    n_shards=1,
    # edge-partitioned graph parallelism factor: the batch's edge set is
    # split over a second 'graph' mesh axis inside the train step
    # (parallel/edge_partition.py); total devices = n_shards * graph_shards
    graph_shards=1,
    # tensor parallelism factor: params column-sharded over a 'model' mesh
    # axis, the jit step auto-partitions via GSPMD (parallel/tp.py)
    model_shards=1,
    # node-sharded halo partitioning factor: per-device node/edge arrays
    # shrink ~1/k, sender gathers halo-exchange ghost rows via ppermute
    # (parallel/node_partition.py); mutually exclusive with graph_shards
    node_shards=1,
    # rematerialize the forward in the backward (jax.checkpoint): trades
    # ~1 extra forward of FLOPs for not storing activations — for
    # HBM-limited scaling (deep stacks / giant node-sharded graphs)
    remat=False,
    # BYOL: EMA-update BOTH teachers each step (symmetric BYOL).  Default
    # False = reference-exact: after_optim_step touches only the 2D
    # teacher (byol_trainer.py:24), the 3D teacher stays at init
    byol_ema_all=False,
    dataset_params={},
    max_nodes=40,
    use_tensorboard=True,
)


DEVICES = (None, "cuda", "cpu")


def check_device(device) -> None:
    """The `device` values the port takes: None (the card), "cuda", "cpu"."""
    if device not in DEVICES:
        raise ValueError(f"device {device!r}: the port runs on 'cuda' (the "
                         f"default, None) or 'cpu'")


def merge_config(base: Dict[str, Any], overlay: Dict[str, Any]) -> Dict[str, Any]:
    out = copy.deepcopy(base)
    for key, value in (overlay or {}).items():
        if isinstance(value, list) and isinstance(out.get(key), list):
            out[key] = list(out[key]) + list(value)   # reference append quirk
        else:
            out[key] = value
    return out


def load_config(config_path: Optional[str] = None,
                overrides: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
    """Reference get_arguments semantics (train.py:615-641), exactly:

    1. defaults <- YAML config, list values APPENDED (the quirk),
    2. checkpoint `train_arguments.yaml` for keys NOT set by the config
       (lists appended there too, train.py:629-639),
    3. programmatic/CLI overrides REPLACE (no append analog upstream)."""
    args = copy.deepcopy(DEFAULTS)
    config_dict: Dict[str, Any] = {}
    if config_path:
        with open(config_path) as f:
            config_dict = yaml_lite.safe_load(f) or {}
    args = merge_config(args, config_dict)
    ckpt = (overrides or {}).get("checkpoint") or config_dict.get("checkpoint")
    if ckpt:
        saved = os.path.join(os.path.dirname(ckpt), "train_arguments.yaml")
        if os.path.exists(saved):
            with open(saved) as f:
                saved_dict = yaml_lite.safe_load(f) or {}
            args = merge_config(args, {k: v for k, v in saved_dict.items()
                                       if k not in config_dict})
    for k, v in (overrides or {}).items():
        args[k] = v
    args["config"] = config_path
    return args
