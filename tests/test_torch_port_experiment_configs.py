"""Every experiment config of `configs/` through the port's resolution layer
(the twin of `tests/test_experiment_configs.py`'s `test_config_resolves`):
`load_config`, the collate routing, the models (`build_models`, built on
torch's meta device, so no weights are made), `get_loss`, `get_collate`,
the trainer class and `build_metrics`.  No model is trained.

Each config's outcome is set by a table: it resolves (every model,
loss and trainer a config names is ported; the tables of what raises a
ROADMAP queue 1 item, `ITEM_7` and `ITEM_8`, are empty), or it fails as
the JAX package fails on it: `pnatransformersimple_ogbg.yml`'s width 80 is no multiple of its 32
heads; `PNASelfAttentionReadout` is registered in neither package
(`KeyError`); the checkpoint pointers (`1.yml` to `8.yml`) carry no
model parameters, so both packages' `PNA` lacks its required arguments
(`TypeError`).  The JAX test's `SKIP` entry for `continue.yml` is kept.
`GeomolGNNWrapper` reads its `node_dim` / `edge_dim` off the dataset, as
in JAX: its config resolves against one float-featured molecule.
"""
import glob
import os

import numpy as np
import pytest
import torch

from infomax3d_tpu.cli import train as jax_cli
from infomax3d_tpu.cli.config import load_config as jax_load_config
from infomax3d_tpu_torch.cli import train as port_cli
from infomax3d_tpu_torch.cli.config import load_config
from infomax3d_tpu_torch.data.loader import get_collate
from infomax3d_tpu_torch.losses import SUPERVISED_LOSSES, get_loss
from infomax3d_tpu_torch.train.trainer import get_trainer_class

CONFIG_DIR = os.path.join(os.path.dirname(__file__), "..", "configs")
ALL_CONFIGS = sorted(os.path.basename(p) for p in
                     glob.glob(os.path.join(CONFIG_DIR, "*.yml")))
SKIP = {"continue.yml": "bare checkpoint pointer into a run dir the "
                        "reference does not ship (reference "
                        "configs/continue.yml)"}
# the models the port has not ported yet, by ROADMAP queue 1 item: none
ITEM_7 = {}
ITEM_8 = set()
# what fails in the JAX package too
WIDTH = {"pnatransformersimple_ogbg.yml"}
UNKNOWN = {"contrastive_training_pna_self_attention_readout.yml"}
POINTERS = {f"{i}.yml" for i in range(1, 9)}
# the configs the last slices opened (BYOL, 8a; SAN, 7e; EGNN, 7f; the
# GeoMol wrapper, 7g): none of them raises
SLICE = ("byol.yml", "san.yml", "san_ogbg.yml", "0.yml",
         "tune_from_ot_geomoL_feat.yml")
# one molecule of `qm9_geomol`'s float features (the chemprop widths)
FLOAT_FEATURES = [{"graph2d": {"node_feat": np.zeros((3, 44), np.float32),
                               "edge_feat": np.zeros((4, 4), np.float32)}}]
# as the JAX test: metrics that need a dataset in hand, and one that the
# reference's own lookup fails on
DATASET_DEPENDENT_METRICS = {"qm9_properties", "mae_denormalized",
                             "mse_denormalized"}
UPSTREAM_BROKEN_METRICS = {"0.yml": {"f1_contrastive"}}


def resolve(name):
    """The port's resolution of config `name`; raises where it stops."""
    args = load_config(os.path.join(CONFIG_DIR, name))
    port_cli.resolve_collate(args)
    dataset = FLOAT_FEATURES if args["dataset"] == "qm9_geomol" else None
    with torch.device("meta"):
        models = port_cli.build_models(args, dataset)
    if args["loss_func"] not in SUPERVISED_LOSSES:
        get_loss(args["loss_func"], **(args.get("loss_params") or {}))
    get_collate(args["collate_function"])
    get_trainer_class(args["trainer"])
    ms = [m for m in args["metrics"]
          if m not in DATASET_DEPENDENT_METRICS
          and m not in UPSTREAM_BROKEN_METRICS.get(name, set())]
    built = port_cli.build_metrics({**args, "metrics": ms})
    assert set(built) == set(ms), set(ms) - set(built)
    return models


def test_outcome_table():
    """The table's counts after this slice, each name a config of
    `configs/`, no config in two rows: 79 configs resolve, the last
    slices' five among them; no config raises a queue 1 item."""
    assert len(ALL_CONFIGS) == 90
    assert len(ITEM_7) == 0 and len(ITEM_8) == 0
    rows = [set(ITEM_7), ITEM_8, WIDTH, UNKNOWN, POINTERS, set(SKIP),
            set(SLICE)]
    assert sum(len(r) for r in rows) == len(set().union(*rows))
    assert set().union(*rows) <= set(ALL_CONFIGS)
    assert len(ALL_CONFIGS) - len(set().union(*rows)) + len(SLICE) == 79


def test_critic_type_names_item_8b():
    """A config's `critic_type` (the philosophy trainer's critic, ROADMAP
    queue 1 item 8b, ported) builds the critic from `critic_parameters`,
    its input `critic_in_dim` wide (default 256, the JAX trainer's), as
    the JAX CLI builds it; `BasicCritic` names the same class."""
    for name in ("Critic", "BasicCritic"):
        args = load_config(os.path.join(CONFIG_DIR, "0.yml"),
                           {"critic_type": name, "trainer": "philosophy",
                            "critic_parameters": {"metric_dim": 16,
                                                  "repeats": 2}})
        with torch.device("meta"):
            critic = port_cli.build_models(args)["critic"]
        jax_critic = jax_cli.build_models(
            jax_load_config(os.path.join(CONFIG_DIR, "0.yml"),
                            {"critic_type": name,
                             "critic_parameters": {"metric_dim": 16,
                                                   "repeats": 2}}))["critic"]
        assert type(critic).__name__ == type(jax_critic).__name__ == "Critic"
        first = critic.mlp.fully_connected[0].linear
        last = critic.mlp.fully_connected[-1].linear
        assert (first.in_features, last.out_features) == (256, 32)
        assert (jax_critic.metric_dim, jax_critic.repeats) == (16, 2)
        get_trainer_class(args["trainer"])


@pytest.mark.parametrize("name", ALL_CONFIGS)
def test_config_resolves_through_the_port(name):
    if name in SKIP:
        pytest.skip(SKIP[name])
    if name in ITEM_7:
        with pytest.raises(NotImplementedError,
                           match=f"item {ITEM_7[name]}"):
            resolve(name)
    elif name in ITEM_8:
        with pytest.raises(NotImplementedError, match="item 8"):
            resolve(name)
    elif name in WIDTH:
        with pytest.raises(ValueError, match="not a multiple of nhead"):
            resolve(name)
    elif name in UNKNOWN:
        with pytest.raises(KeyError, match="PNASelfAttentionReadout"):
            resolve(name)
        args = jax_load_config(os.path.join(CONFIG_DIR, name))
        with pytest.raises(KeyError, match="PNASelfAttentionReadout"):
            jax_cli.build_models(args)
    elif name in POINTERS:
        with pytest.raises(TypeError, match="missing"):
            resolve(name)
        args = jax_load_config(os.path.join(CONFIG_DIR, name))
        with pytest.raises(TypeError, match="missing"):
            jax_cli.build_models(args)
    else:
        assert resolve(name)["model"] is not None
