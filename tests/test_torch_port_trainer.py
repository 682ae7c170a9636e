"""The parts of the port's trainer against the JAX package's, on the CPU:
the schedulers (lr sequences equal exactly), the metrics of `build_metrics`
(1e-6 of max(|JAX value|, 1)), the optimizer's group labels (equal to
`label_params`' through `interop`'s name table), Adam / AdamW / SGD with
momentum against `GroupedOptimizer.update` (1e-6 of each parameter's max
over three steps), the random splits and `GraphDataLoader` (array-equal),
the port's checkpoint read and transferred by the JAX package (equal
tensors), and resuming from `last_checkpoint.pt` (bit for bit)."""
import glob
import json
import os
import types
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from infomax3d_tpu.cli.train import build_metrics as jax_build_metrics
from infomax3d_tpu.cli.train import transfer_pretrained as jax_transfer
from infomax3d_tpu.data.cached import SyntheticDataset as JaxSynthetic
from infomax3d_tpu.data.loader import GraphDataLoader as JaxLoader
from infomax3d_tpu.data.splits import \
    reference_split_indices as jax_split_indices
from infomax3d_tpu.graphs.batch import BucketSpec as JaxBucket
from infomax3d_tpu.train import schedulers as jax_schedulers
from infomax3d_tpu.train.optim import GROUP_ORDER as JAX_GROUP_ORDER
from infomax3d_tpu.train.optim import GroupedOptimizer
from infomax3d_tpu.train.optim import label_params as jax_label_params
from infomax3d_tpu.train.state import TrainState
from infomax3d_tpu_torch.cli.config import load_config
from infomax3d_tpu_torch.cli.train import build_metrics, run_training
from infomax3d_tpu_torch.cli.train import transfer_pretrained
from infomax3d_tpu_torch.data.cached import SyntheticDataset
from infomax3d_tpu_torch.data.loader import GraphDataLoader
from infomax3d_tpu_torch.data.splits import reference_split_indices
from infomax3d_tpu_torch.graphs.batch import BucketSpec
from infomax3d_tpu_torch.interop import (_flatten, _torch_name,
                                         init_jax_variables, load_variables,
                                         params_from_jax)
from infomax3d_tpu_torch.models.registry import build_model
from infomax3d_tpu_torch.train import checkpoint, schedulers
from infomax3d_tpu_torch.train.optim import GROUP_ORDER, build_optimizer
from infomax3d_tpu_torch.train.trainer import Trainer

# --------------------------------------------------------------- schedulers

START_LRS = [1e-3, 2e-3, 5e-4]
SCHEDULES = {
    "plateau_min": ("ReduceLROnPlateau", dict(mode="min", factor=0.5,
                                              patience=1, cooldown=1,
                                              min_lr=1e-4, threshold=1e-3)),
    "plateau_max_abs": ("ReduceLROnPlateau", dict(
        mode="max", factor=0.3, patience=0, threshold_mode="abs",
        threshold=0.01)),
    "cosine": ("CosineAnnealingLR", dict(T_max=7, eta_min=1e-5)),
    "step": ("StepLR", dict(step_size=3, gamma=0.5)),
    "exponential": ("ExponentialLR", dict(gamma=0.9)),
    "one_cycle": ("OneCycleLR", dict(max_lr=1e-2, total_steps=30,
                                     pct_start=0.3)),
    "one_cycle_linear": ("OneCycleLR", dict(
        max_lr=[1e-2, 2e-2, 5e-3], epochs=5, steps_per_epoch=6,
        anneal_strategy="linear")),
    "warmup_3_groups_linear": ("WarmUpWrapper", dict(
        warmup_steps=[3, 4, 2], interpolation="linear",
        wrapped_scheduler="ReduceLROnPlateau", factor=0.5, patience=1,
        min_lr=1e-6, mode="min", verbose=True)),
    "warmup_3_groups_cosine": ("WarmUpWrapper", dict(
        warmup_steps=[2, 0, 5], interpolation="cosine",
        wrapped_scheduler="CosineAnnealingLR", T_max=4)),
    "warmup_single": ("WarmUpWrapper", dict(
        warmup_steps=[5], wrapped_scheduler="StepLR", step_size=2)),
    "none": (None, None),
}


def _drive(mod, name, params, per_batch):
    c = mod.LRController(START_LRS, name, params, step_per_batch=per_batch)
    metrics = np.random.default_rng(3).normal(1.0, 0.2, 8).cumsum()[::-1]
    seq = [list(c.lrs)]
    for epoch in range(8):
        for _ in range(4):
            c.after_optim_step()
            seq.append(list(c.lrs))
        c.after_epoch(float(metrics[epoch]))
        seq.append(list(c.lrs))
    return seq, c.state_dict()


@pytest.mark.parametrize("per_batch", [False, True])
@pytest.mark.parametrize("case", sorted(SCHEDULES))
def test_scheduler_lr_sequences_equal(case, per_batch):
    name, params = SCHEDULES[case]
    want, want_sd = _drive(jax_schedulers, name, params, per_batch)
    got, got_sd = _drive(schedulers, name, params, per_batch)
    assert got == want
    assert got_sd == want_sd


def test_scheduler_state_round_trip():
    """A controller restored from a state_dict continues the sequence."""
    name, params = SCHEDULES["warmup_3_groups_linear"]
    a = schedulers.LRController(START_LRS, name, dict(params), False)
    for _ in range(5):
        a.after_optim_step()
    sd = a.state_dict()
    b = schedulers.LRController(START_LRS, name, dict(params), False)
    b.load_state_dict({**sd, "wrapped": dict(sd["wrapped"])})
    for c in (a, b):
        for _ in range(6):
            c.after_optim_step()
        c.after_epoch(0.5)
    assert a.lrs == b.lrs


# ------------------------------------------------------------------ metrics

class _Stats:
    targets_mean = np.array([0.3, -1.2, 2.0], np.float32)
    targets_std = np.array([1.5, 0.7, 3.0], np.float32)
    ev2mev = np.array([1.0, 27.2, 1.0], np.float32)
    target_tasks = ["t0", "t1", "t2"]


OGB = {"ogbg-molhiv": 1, "ogbg-molpcba": 128, "ogbg-molbace": 1,
       "ogbg-molbbbp": 1, "ogbg-molclintox": 2, "ogbg-moltoxcast": 617,
       "ogbg-moltox21": 12, "ogbg-mollipo": 1, "ogbg-molmuv": 17,
       "ogbg-molsider": 27, "ogbg-molfreesolv": 1, "ogbg-molesol": 1}
METRIC_ARGS = {"metrics": [
    "rsquared", "mae", "pearsonr", "pcqm4m", "conformer_3d_variance",
    "conformer_2d_variance", "positive_similarity",
    "positive_similarity_multiple_positives_separate2d", "positive_prob",
    "negative_prob", "negative_similarity",
    "negative_similarity_multiple_positives_separate2d",
    "contrastive_accuracy", "true_negative_rate", "true_positive_rate",
    "uniformity", "alignment", "batch_variance", "dimension_covariance",
    "mean_predictor_loss", "qm9_properties", "mae_denormalized",
    "mse_denormalized", *OGB],
    "main_metric": "mae_denormalized", "loss_func": "L1Loss",
    "loss_params": {}}
METRIC_NAMES = sorted(jax_build_metrics(dict(METRIC_ARGS), _Stats()))


def _metric_inputs(name, rng):
    if name in OGB:
        t = OGB[name]
        preds = rng.normal(size=(80, t))
        if name in ("ogbg-mollipo", "ogbg-molfreesolv", "ogbg-molesol"):
            targets = rng.normal(size=(80, t))
        else:
            targets = (rng.uniform(size=(80, t)) < 0.4).astype(np.float64)
            targets[rng.uniform(size=(80, t)) < 0.2] = np.nan
        return preds, targets
    if "separate2d" in name:
        return rng.normal(size=(16, 24)), rng.normal(size=(48, 8))
    if name in ("conformer_3d_variance",):
        return rng.normal(size=(16, 8)), rng.normal(size=(48, 8))
    if name in ("conformer_2d_variance", "positive_prob", "negative_prob"):
        return rng.normal(size=(16, 16)) * 0.5, rng.normal(size=(48, 8))
    contrastive = ("similarity", "accuracy", "rate", "uniformity",
                   "alignment", "variance", "covariance")
    if any(c in name for c in contrastive):
        x1 = rng.normal(size=(32, 16))
        return x1, x1 + rng.normal(size=(32, 16))
    return rng.normal(size=(64, 3)), rng.normal(size=(64, 3))


def test_metric_table_has_every_name():
    assert sorted(build_metrics(dict(METRIC_ARGS), _Stats())) == METRIC_NAMES
    assert len(METRIC_NAMES) == 37


@pytest.mark.parametrize("name", METRIC_NAMES)
def test_metric_matches_jax(name):
    rng = np.random.default_rng(zlib.crc32(name.encode()))
    p, t = (a.astype(np.float32) for a in _metric_inputs(name, rng))
    want = float(jax_build_metrics(dict(METRIC_ARGS), _Stats())[name](
        jnp.asarray(p), jnp.asarray(t)))
    got = float(build_metrics(dict(METRIC_ARGS), _Stats())[name](p, t))
    assert np.isfinite(want)
    assert abs(got - want) <= 1e-6 * max(abs(want), 1.0), (got, want)


# ------------------------------------------------------------ group labels

PNA_TUNE = dict(target_dim=1, hidden_dim=16, mid_batch_norm=True,
                last_batch_norm=True, readout_batchnorm=True,
                batch_norm_momentum=0.1, readout_hidden_dim=16,
                readout_layers=2, dropout=0.0, propagation_depth=2,
                aggregators=["mean", "max", "min", "std"],
                scalers=["identity", "amplification", "attenuation"],
                readout_aggregators=["min", "max", "mean", "sum"],
                pretrans_layers=2, posttrans_layers=1, residual=True)
NET3D = dict(target_dim=8, hidden_dim=4, node_wise_output_layers=0,
             message_net_layers=1, update_net_layers=1, reduce_func="mean",
             fourier_encodings=2, propagation_depth=1, batch_norm=True,
             readout_batchnorm=True, readout_layers=1,
             readout_aggregators=["min", "max", "mean"])
GIN = dict(target_dim=1, num_layers=2, hidden_dim=8, virtual_node=False)
LABEL_CASES = {
    # configs_clean/tune_QM9_homo.yml's tokens
    "pna_tune_qm9_homo": ({"model": ("PNA", PNA_TUNE)},
                          dict(transfer_layers=["gnn"],
                               exclude_from_transfer=["batch_norm"])),
    "ogbgnn_frozen": ({"model": ("OGBGNN", GIN)},
                      dict(transfer_layers=["node_gnn"],
                           exclude_from_transfer=["batch_norm"],
                           frozen_layers=["atom_encoder"])),
    "pna_net3d_gnn_dot": ({"model": ("PNA", dict(PNA_TUNE, target_dim=8)),
                           "model3d": ("Net3DDense", NET3D)},
                          dict(transfer_layers=["gnn."],
                               frozen_layers=["input"])),
}


def _jax_labels(models, tokens):
    """`label_params` of the JAX package on the joint tree, by torch
    name."""
    tree = {k: init_jax_variables(mp, 0, t)[0]
            for k, (t, mp) in models.items()}
    labels, active = jax_label_params(
        jax.tree_util.tree_map(jnp.asarray, tree), **tokens)
    out = {}
    for k in models:
        for path, v in _flatten(jax.device_get(labels[k])):
            out[f"{k}.{_torch_name('params', path)}"] = \
                JAX_GROUP_ORDER[int(v)]
    return out, active


def _port_trainer(models, tokens, tmp_path, cls=Trainer):
    mods = {k: build_model(t, mp) for k, (t, mp) in models.items()}
    args = dict(tokens, optimizer="Adam", optimizer_params={"lr": 1e-3})
    tr = cls.__new__(cls)
    tr.models, tr.args, tr.MODEL_KEYS = mods, args, tuple(models)
    tr.lr_controllers, tr.active_groups = {}, {}
    tr.scheduler_step_per_batch = False
    tr._build_optimizer()
    return tr


@pytest.mark.parametrize("case", sorted(LABEL_CASES))
def test_group_labels_match_jax(case, tmp_path):
    models, tokens = LABEL_CASES[case]
    want, active = _jax_labels(models, tokens)
    tr = _port_trainer(models, tokens, tmp_path)
    assert tr.labels == want
    assert tr.active_groups["main"] == active
    assert [g["name"] for g in tr.optimizer.param_groups] == active


def test_gin_groups_follow_the_jax_labels(tmp_path):
    """A GINConv's MaskedBatchNorm_0 (`mlp.1`) is `batch_norm`; the node
    stack's `batch_norms.{i}` are `new`."""
    tr = _port_trainer({"model": ("OGBGNN", GIN)}, {}, tmp_path)
    assert tr.labels["model.node_gnn.convs.0.mlp.1.weight"] == "batch_norm"
    assert tr.labels["model.node_gnn.batch_norms.0.weight"] == "new"


# --------------------------------------------------------------- optimizers

OPT_CASES = {"Adam": dict(weight_decay=0.01),
             "AdamW": dict(weight_decay=0.05, betas=(0.8, 0.99)),
             "SGD": dict(weight_decay=0.01, momentum=0.9)}
# per step, lrs in GROUP_ORDER (batch_norm, new, transferred, frozen)
STEP_LRS = [[1e-3, 2e-3, 0.0, 0.0], [1e-3, 0.0, 5e-4, 0.0],
            [2e-3, 1e-3, 1e-3, 0.0]]


@pytest.mark.parametrize("name", sorted(OPT_CASES))
def test_optimizer_matches_grouped_optimizer(name, tmp_path):
    """Three steps of the port's torch optimizer over the four groups
    against `GroupedOptimizer.update` on the same gradients and per-group
    lrs (frozen at 0 throughout, the others at 0 in some steps)."""
    models, tokens = LABEL_CASES["ogbgnn_frozen"]
    params, stats = init_jax_variables(GIN, 0, "OGBGNN")
    kw = dict(OPT_CASES[name])
    jparams = {"model": jax.tree_util.tree_map(jnp.asarray, params)}
    labels, active = jax_label_params(jparams, **tokens)
    assert active == list(GROUP_ORDER)
    opt = GroupedOptimizer(labels, name=name, lr=1e-3,
                           transferred_lr=5e-4, **kw)
    state = opt.init(jparams)
    model = load_variables(build_model("OGBGNN", GIN),
                           {"params": params, "batch_stats": stats})
    tr = _port_trainer(models, tokens, tmp_path)
    port_opt = build_optimizer(
        [(f"model.{n}", p) for n, p in model.named_parameters()],
        tr.labels, name, lr=1e-3, transferred_lr=5e-4, **kw)
    rng = np.random.default_rng(11)
    for lrs in STEP_LRS:
        grads = jax.tree_util.tree_map(
            lambda a: rng.normal(size=np.shape(a)).astype(np.float32),
            params)
        upd, state = opt.update({"model": jax.tree_util.tree_map(
            jnp.asarray, grads)}, state, jparams, jnp.asarray(lrs))
        jparams = jax.tree_util.tree_map(lambda p, u: p + u, jparams, upd)
        tgrads = params_from_jax(grads, {})
        for n, p in model.named_parameters():
            p.grad = tgrads[n].clone()
        for g in port_opt.param_groups:
            g["lr"] = lrs[GROUP_ORDER.index(g["name"])]
        port_opt.step()
    want = params_from_jax(jax.device_get(jparams["model"]), {})
    got = dict(model.named_parameters())
    moved = 0
    for n, w in want.items():
        w = w.numpy()
        assert np.abs(got[n].detach().numpy() - w).max() <= \
            1e-6 * max(np.abs(w).max(), 1.0), n
        moved += not np.array_equal(
            w, params_from_jax(params, {})[n].numpy())
    frozen = [n for n in want if tr.labels[f"model.{n}"] == "frozen"]
    assert frozen and all(np.array_equal(
        got[n].detach().numpy(), params_from_jax(params, {})[n].numpy())
        for n in frozen)
    assert moved == len(want) - len(frozen)


# ------------------------------------------------------------------ splits

@pytest.mark.parametrize("args,n", [
    (dict(dataset="synthetic", seed_data=123, num_train=1000), 5000),
    (dict(dataset="qm9", seed_data=123, num_train=-1), 130831),
    (dict(dataset="qm9", seed_data=5, num_train=200, num_val=50), 1000),
    (dict(dataset="drugs", seed_data=123, num_train=300, num_val=40), 900),
    (dict(dataset="file_loader_qm9", seed_data=7, num_train=-1), 3000),
    (dict(dataset="qmugs", seed_data=123, num_train=100), 700_000),
])
def test_reference_split_indices_equal(args, n):
    for got, want in zip(reference_split_indices(args, n),
                         jax_split_indices(args, n)):
        assert np.array_equal(got, want)


# ------------------------------------------------------------------ loader

class _Logged:
    """A dataset that records the order of its item reads."""

    def __init__(self, ds):
        self.ds, self.log = ds, []

    def __len__(self):
        return len(self.ds)

    def __getitem__(self, i):
        self.log.append(i)
        return self.ds[i]


def _same_arrays(port_view, jax_batch):
    fields = {**{k: v for k, v in vars(jax_batch).items()
                 if k != "extras" and v is not None},
              **getattr(jax_batch, "extras", {})}
    if "graph_mask" not in fields:                      # a dense batch
        fields["graph_mask"] = jax_batch.graph_mask
    for k, v in port_view.items():
        if k in ("max_deg", "nmax"):
            continue
        w = np.asarray(fields[k])
        assert v.dtype == w.dtype or k == "csr_pos", (k, v.dtype, w.dtype)
        assert np.array_equal(v, w, equal_nan=v.dtype.kind == "f"), k


@pytest.mark.parametrize("collate", ["graph_collate", "contrastive_collate"])
def test_loader_matches_jax(collate):
    """Two epochs of shuffled batches (drop_last for the contrastive
    collate): the same item order and array-equal batches."""
    kw = dict(num=70, seed=3, n_max=20)
    port_ds, jax_ds = _Logged(SyntheticDataset(**kw)), \
        _Logged(JaxSynthetic(**kw))
    idx = np.arange(5, 65)
    G, N, E = 16, 512, 1024
    ckw = {}
    if collate == "contrastive_collate":
        ckw = dict(dense_3d=True, max_nodes3d=20)
    deg = port_ds.ds.max_in_degree()
    loaders = (
        GraphDataLoader(port_ds, G, collate, bucket=BucketSpec(
            G, N, E, max_deg=deg, csr=True, nmax=20), seed=9, indices=idx,
            drop_last=bool(ckw), collate_kwargs=ckw),
        JaxLoader(jax_ds, G, collate, bucket=JaxBucket(
            G, N, E, max_deg=deg, csr=True, nmax=20), seed=9, indices=idx,
            drop_last=bool(ckw), collate_kwargs=ckw))
    for _ in range(2):
        for pb, jb in zip(*loaders, strict=True):
            for view in pb:
                _same_arrays(pb[view], jb[view])
    assert port_ds.log == jax_ds.log and len(port_ds.log) >= 96


def test_loader_reraises_collate_errors():
    ds = SyntheticDataset(num=8)
    loader = GraphDataLoader(ds, 4, "graph_collate", bucket=BucketSpec(
        4, 8, 8, max_deg=4, csr=True, nmax=28))
    with pytest.raises(ValueError, match="bucket"):
        list(loader)


# ---------------------------------------------------- checkpoint interop

PNA_PRE = dict(PNA_TUNE, target_dim=8,
               readout_aggregators=["min", "max", "mean"])


@pytest.mark.parametrize("tokens,stats_move", [
    (dict(transfer_layers=["gnn"], exclude_from_transfer=["batch_norm"]),
     False),
    (dict(transfer_layers=["node_gnn"], exclude_from_transfer=[]), True),
    (dict(transfer_layers=["gnn."], exclude_from_transfer=["posttrans"]),
     True),
    # torch-style indices never match the flax paths, in either package
    (dict(transfer_layers=["node_gnn.mp_layers.1", "atom"],
          exclude_from_transfer=[]), False),
])
def test_port_checkpoint_transfers_as_in_jax(tmp_path, tokens, stats_move,
                                             capsys):
    """The port's `.pt` read by the JAX package (`load_torch_payload` +
    `convert_state_dict` inside its `transfer_pretrained`) transfers the
    same tensors with the same values, and the same count, as the port's
    `transfer_pretrained` (parameters and running statistics)."""
    src = load_variables(build_model("PNA", PNA_PRE), dict(zip(
        ("params", "batch_stats"), init_jax_variables(PNA_PRE, 1))))
    path = str(tmp_path / "best_checkpoint.pt")
    checkpoint.save_checkpoint(path, {
        **checkpoint.state_dicts({"model": src}), "epoch": 3,
        "best_val_score": 0.5, "optim_steps": 24,
        "optimizer_state_dict": {}, "scheduler_state_dict": {}})
    args = dict(tokens, pretrain_checkpoint=path, transfer_3d=False)
    params, stats = init_jax_variables(PNA_TUNE, 2)
    state = TrainState(params={"model": params},
                       batch_stats={"model": stats}, opt_state=None,
                       step=0)
    new = jax_transfer(state, args)
    jax_count = int(capsys.readouterr().out.split("transferred ")[1]
                    .split()[0])
    want = params_from_jax(jax.device_get(new.params["model"]),
                           jax.device_get(new.batch_stats["model"]))
    dst = load_variables(build_model("PNA", PNA_TUNE),
                         {"params": params, "batch_stats": stats})
    count = transfer_pretrained(types.SimpleNamespace(
        models={"model": dst}), args)
    assert count == jax_count > 0
    got = dst.state_dict()
    for n, w in want.items():
        assert np.array_equal(got[n].numpy(), w.numpy()), n
    moved = [n for n, w in want.items()
             if not np.array_equal(w.numpy(), params_from_jax(
                 params, stats)[n].numpy())]
    assert any("running" in n for n in moved) == stats_move


def test_checkpoint_holds_plain_tensors(tmp_path):
    m = build_model("PNA", PNA_PRE)
    path = str(tmp_path / "c.pt")
    checkpoint.save_checkpoint(path, {**checkpoint.state_dicts({"model": m}),
                                      "epoch": 1, "best_val_score": 1.0})
    payload = checkpoint.load_checkpoint(path)      # weights_only=True
    assert any("running_mean" in n for n in payload["model_state_dict"])
    assert payload["epoch"] == 1


# ------------------------------------------------------------------ resume

SMALL = dict(dataset_params={"num": 160, "n_max": 16}, batch_size=16,
             num_train=64, use_tensorboard=False, log_iterations=2)


def _last(logdir):
    return checkpoint.load_checkpoint(
        glob.glob(os.path.join(logdir, "*", "last_checkpoint.pt"))[0])


def _equal_payloads(a, b):
    def flat(x, pre=""):
        if isinstance(x, dict):
            for k, v in x.items():
                yield from flat(v, f"{pre}/{k}")
        elif isinstance(x, (list, tuple)):
            for i, v in enumerate(x):
                yield from flat(v, f"{pre}/{i}")
        else:
            yield pre, x
    fa, fb = dict(flat(a)), dict(flat(b))
    assert fa.keys() == fb.keys()
    for k, v in fa.items():
        if isinstance(v, torch.Tensor):
            assert torch.equal(v, fb[k]), k
        else:
            assert v == fb[k], k


@pytest.mark.parametrize("config", ["configs_clean/pre-train_synthetic.yml",
                                    "configs_clean/tune_synthetic.yml"])
def test_resume_continues_bit_for_bit(tmp_path, config):
    """2 epochs in one run against 1 epoch then a run resumed from its
    `last_checkpoint.pt`: the same weights, running statistics, optimizer
    moments and scheduler state."""
    run_training(load_config(config, dict(SMALL, num_epochs=2,
                                          logdir=str(tmp_path / "a"))),
                 device="cpu")
    run_training(load_config(config, dict(SMALL, num_epochs=1,
                                          logdir=str(tmp_path / "b"))),
                 device="cpu")
    ckpt = glob.glob(str(tmp_path / "b" / "*" / "last_checkpoint.pt"))[0]
    run_training(load_config(config, dict(SMALL, num_epochs=2,
                                          logdir=str(tmp_path / "c"),
                                          checkpoint=ckpt)), device="cpu")
    a, c = _last(str(tmp_path / "a")), _last(str(tmp_path / "c"))
    assert a["epoch"] == c["epoch"] == 2
    assert a["optim_steps"] == c["optim_steps"] == 8
    _equal_payloads(a, c)


def test_best_checkpoint_reload_gives_the_best_epoch(tmp_path):
    """The run's `val_best_checkpoint` evaluation, made after the best
    checkpoint is reloaded, equals the best epoch's validation record bit
    for bit (same weights, batches and eval mode)."""
    args = load_config("configs_clean/tune_synthetic.yml",
                       dict(SMALL, num_epochs=3, logdir=str(tmp_path)))
    result = run_training(args, device="cpu")
    path = glob.glob(str(tmp_path / "*" / "metrics.jsonl"))[0]
    val = [r for r in map(json.loads, open(path)) if r["split"] == "val"]
    best = min(reversed(val), key=lambda r: r["mae_denormalized"])
    for k, v in best.items():
        if k not in ("split", "step", "epoch", "time"):
            assert result[k] == v, k
