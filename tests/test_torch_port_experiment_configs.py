"""Every experiment config of `configs/` through the port's resolution layer
(the twin of `tests/test_experiment_configs.py`'s `test_config_resolves`):
`load_config`, the collate routing, the models (`build_models`, built on
torch's meta device, so no weights are made), `get_loss`, `get_collate`,
the trainer class and `build_metrics`.  No model is trained.

Each config's outcome is set by a table: it resolves, or it raises what
the port does not have yet (the `NotImplementedError` of its ROADMAP queue
1 item: 7g for `GeomolGNNWrapper`; item 8's trainers, none of which a
config names, raise 8b), or it fails as the JAX package fails on
it: `pnatransformersimple_ogbg.yml`'s width 80 is no multiple of its 32
heads; `PNASelfAttentionReadout` is registered in neither package
(`KeyError`); the checkpoint pointers (`1.yml` to `8.yml`) carry no
model parameters, so both packages' `PNA` lacks its required arguments
(`TypeError`).  The JAX test's `SKIP` entry for `continue.yml` is kept.
"""
import glob
import os

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
# the models the port has not ported yet, by ROADMAP queue 1 item
ITEM_7 = {"tune_from_ot_geomoL_feat.yml": "7g"}
ITEM_8 = set()
# what fails in the JAX package too
WIDTH = {"pnatransformersimple_ogbg.yml"}
UNKNOWN = {"contrastive_training_pna_self_attention_readout.yml"}
POINTERS = {f"{i}.yml" for i in range(1, 9)}
# the configs this slice opens (BYOL, 8a; SAN, 7e; EGNN, 7f): none of
# them raises
SLICE = ("byol.yml", "san.yml", "san_ogbg.yml", "0.yml")
# as the JAX test: metrics that need a dataset in hand, and one that the
# reference's own lookup fails on
DATASET_DEPENDENT_METRICS = {"qm9_properties", "mae_denormalized",
                             "mse_denormalized"}
UPSTREAM_BROKEN_METRICS = {"0.yml": {"f1_contrastive"}}


def resolve(name):
    """The port's resolution of config `name`; raises where it stops."""
    args = load_config(os.path.join(CONFIG_DIR, name))
    port_cli.resolve_collate(args)
    with torch.device("meta"):
        models = port_cli.build_models(args)
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
    `configs/`, no config in two rows: 78 configs resolve, the slice's
    four among them; item 7 raises for one (7g), item 8 for none."""
    assert len(ALL_CONFIGS) == 90
    assert len(ITEM_7) == 1 and len(ITEM_8) == 0
    assert sorted(ITEM_7.values()) == ["7g"]
    rows = [set(ITEM_7), ITEM_8, WIDTH, UNKNOWN, POINTERS, set(SKIP),
            set(SLICE)]
    assert sum(len(r) for r in rows) == len(set().union(*rows))
    assert set().union(*rows) <= set(ALL_CONFIGS)
    assert len(ALL_CONFIGS) - len(set().union(*rows)) + len(SLICE) == 78


def test_critic_type_names_item_8b():
    """A config's `critic_type` (the philosophy trainer's critic) raises
    naming ROADMAP queue 1, item 8b."""
    args = load_config(os.path.join(CONFIG_DIR, "0.yml"),
                       {"critic_type": "Critic"})
    with pytest.raises(NotImplementedError, match=r"item 8b\)"):
        with torch.device("meta"):
            port_cli.build_models(args)


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
