"""The port's training CLI against the JAX package's, end to end on the
CPU: `configs_clean/pre-train_synthetic.yml` (PNA 48x3 + Net3D hidden 20,
NT-Xent, WarmUpWrapper [8]), then `configs_clean/tune_synthetic.yml` (PNA
48x3, L1, transfer of `node_gnn`), each for 2 epochs of 4 steps (128
training molecules at batch 32) in float32, through `load_config` +
`train` of both packages.  The JAX runs use `csr_buckets: False` (its XLA segment path, the
arithmetic of the port's CSR twins) and `dense_3d: True` (Net3DDense).

Both sides start from the same weights: the JAX `Trainer.init_state`'s
initial parameters and statistics are captured as the JAX run starts and
handed to the port's `run_training` (`init_variables`).  The JAX runs
initialize their models under `jax.jit` (`_jit_init`: one compiled
program in place of flax's op-by-op `init`, which compiled some 300 small
programs and took most of the first run's time), and the fixture keeps
XLA's compiled programs in a persistent cache while it runs
(`_compilation_cache`), so each witness run loads its run's programs
instead of compiling them again.  The port's runs take one CPU thread
(`_run_port`): at these sizes torch's intra-op threads cost four times
the CPU time for no gain in wall time, and the test workers share the
machine's cores.  Both fine-tunes
transfer from the port's pre-training checkpoint (the JAX package reads
it through `torch_interop`), so the fine-tune comparison holds the
fine-tune alone.  The fine-tune's warmup is given three phases
([3, 3, 3], as `tune_QM9_homo.yml`'s [700, 700, 390]) so that each of its
three groups (batch_norm, new, transferred) unlocks in turn.

A float32 run of these configs is chaotic: Adam's first steps move each
weight by about lr times the sign of its gradient, so rounding that flips a
small gradient's sign moves a weight by ~2 lr.  The JAX run itself, started
from weights perturbed by 2^-20 relative (a few float32 ulps), moves its
epoch-2 validation loss by 0.27 in the pre-training (at 8 steps an epoch) and its fine-tune
metrics by ~1e-2.  So the held quantities are, with their tolerances:

* the first logged losses, before Adam's sign noise has acted (the
  pre-training's step-2 loss is the initial weights' loss on the second
  batch; the fine-tune's step-4 loss follows three steps of which the
  first runs at lr 0): 1e-5 relative (readings 8.0e-7 and 6.6e-8);
* every validation metric of every epoch, the fine-tune's test metrics
  and each model's final parameters (L2 distance over the model, relative
  to the JAX model's L2): within 4x the chaos scale plus 1e-3 of the JAX
  value, where the chaos scale is the larger of two witnesses' distance to
  their own run: the JAX run and the port run each repeated from the
  initial weights perturbed by 2^-20, and for the threshold metrics at
  least one molecule's worth, 1/32 (readings: at most 2.6x the scale);
* the transfer count: equal.

A planted fault must fail the fine-tune's check: the port's
`WarmUpController` unlocking every group at once (the first epoch's
`mae_denormalized` then reads 0.108 off the JAX value, 133x its
tolerance of 8.1e-4).
"""
import contextlib
import functools
import glob
import io
import json
import os

import jax
import numpy as np
import pytest
import torch
import yaml
from flax import linen as nn

from infomax3d_tpu.cli import train as jax_cli
from infomax3d_tpu.cli.config import load_config as jax_load_config
from infomax3d_tpu.train import trainer as jax_trainer
from infomax3d_tpu_torch.cli import train as port_cli
from infomax3d_tpu_torch.cli.config import load_config
from infomax3d_tpu_torch.interop import params_from_jax
from infomax3d_tpu_torch.train import schedulers as port_schedulers
from infomax3d_tpu_torch.train.checkpoint import load_checkpoint

PRE = "configs_clean/pre-train_synthetic.yml"
TUNE = "configs_clean/tune_synthetic.yml"
# 128 of the 409 model-pool molecules: 4 steps an epoch at batch 32
COMMON = dict(num_epochs=2, use_tensorboard=False, num_train=128)
JAX_ONLY = dict(csr_buckets=False, dense_3d=True)
PERTURB = 2.0 ** -20
FIRST_LOSS_TOL = 1e-5
CHAOS_FACTOR = 4.0
FLOOR = 1e-3
# the threshold metrics count pairs of a batch of 32: their chaos scale is
# at least one molecule's worth, 1/32
DISCRETE = {"contrastive_accuracy": 1 / 32, "true_negative_rate": 1 / 32,
            "true_positive_rate": 1 / 32}


def _tune_overrides(pretrain_checkpoint):
    sched = yaml.safe_load(open(TUNE))["lr_scheduler_params"]
    return dict(COMMON, pretrain_checkpoint=pretrain_checkpoint,
                lr_scheduler_params=dict(sched, warmup_steps=[3, 3, 3]))


def _perturbed(tree, seed=5):
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda a: (np.asarray(a) * (1 + PERTURB * rng.uniform(
            -1, 1, np.shape(a)))).astype(np.float32), tree)


def _records(logdir):
    path = glob.glob(os.path.join(logdir, "*", "metrics.jsonl"))
    assert len(path) == 1, path
    return [json.loads(line) for line in open(path[0])]


def _jit_init(mp):
    """flax's `Module.init` under `jax.jit` for the rest of the context
    `mp` (the keyword arguments, such as ``deterministic``, static)."""
    init = nn.Module.init

    def jitted(self, rngs, *args, **kwargs):
        return jax.jit(functools.partial(init, self, **kwargs))(rngs, *args)
    mp.setattr(nn.Module, "init", jitted)


@contextlib.contextmanager
def _compilation_cache(path):
    """XLA's persistent compilation cache in `path`, every program kept,
    while the block runs; the settings before it afterwards."""
    from jax._src import compilation_cache
    names = ("jax_compilation_cache_dir",
             "jax_persistent_cache_min_compile_time_secs",
             "jax_persistent_cache_min_entry_size_bytes")
    old = {n: getattr(jax.config, n) for n in names}
    for n, v in zip(names, (str(path), 0.0, 0)):
        jax.config.update(n, v)
    compilation_cache.reset_cache()
    try:
        yield
    finally:
        for n, v in old.items():
            jax.config.update(n, v)
        compilation_cache.reset_cache()


def _run_jax(config, overrides, logdir, perturb=False):
    """The JAX CLI run; returns (initial variables, metrics records, final
    state dicts in torch names, printed text)."""
    seen = {}
    init_state, fit = jax_trainer.Trainer.init_state, \
        jax_trainer.Trainer.train

    def capture_init(self, batch):
        st = init_state(self, batch)
        seen["init"] = {k: {"params": jax.device_get(st.params[k]),
                            "batch_stats": jax.device_get(
                                st.batch_stats.get(k, {}))}
                        for k in self.MODEL_KEYS}
        if perturb:
            self.state = st.replace(params=jax.tree_util.tree_map(
                jax.numpy.asarray, _perturbed(jax.device_get(st.params))))
        return self.state

    def capture_fit(self, *a):
        out = fit(self, *a)
        seen["final"] = {k: params_from_jax(
            jax.device_get(self.state.params[k]),
            jax.device_get(self.state.batch_stats.get(k, {})))
            for k in self.MODEL_KEYS}
        return out

    text = io.StringIO()
    with pytest.MonkeyPatch.context() as mp, contextlib.redirect_stdout(text):
        _jit_init(mp)
        mp.setattr(jax_trainer.Trainer, "init_state", capture_init)
        mp.setattr(jax_trainer.Trainer, "train", capture_fit)
        result = jax_cli.train(jax_load_config(
            config, dict(overrides, logdir=logdir, **JAX_ONLY)))
    return {"init": seen["init"], "records": _records(logdir),
            "final": seen["final"], "result": result,
            "text": text.getvalue()}


def _run_port(config, overrides, logdir, init, perturb=False):
    if perturb:
        init = {k: {"params": _perturbed(v["params"]),
                    "batch_stats": v["batch_stats"]}
                for k, v in init.items()}
    text = io.StringIO()
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        with contextlib.redirect_stdout(text):
            result = port_cli.train(load_config(
                config, dict(overrides, logdir=logdir)), device="cpu",
                init_variables=init)
    finally:
        torch.set_num_threads(threads)
    best = glob.glob(os.path.join(logdir, "*", "best_checkpoint.pt"))[0]
    payload = load_checkpoint(best)
    final = {k: {n: t.numpy() for n, t in payload[f"{k}_state_dict"].items()
                 if "num_batches_tracked" not in n}
             for k in ("model", "model3d") if f"{k}_state_dict" in payload}
    return {"records": _records(logdir), "final": final, "result": result,
            "text": text.getvalue(), "best": best}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("cli")
    with _compilation_cache(d / "xla_cache"):
        out = {"jax_pre": _run_jax(PRE, COMMON, str(d / "jax_pre"))}
        out["jax_pre_w"] = _run_jax(PRE, COMMON, str(d / "jax_pre_w"), True)
        init = out["jax_pre"]["init"]
        out["port_pre"] = _run_port(PRE, COMMON, str(d / "port_pre"), init)
        out["port_pre_w"] = _run_port(PRE, COMMON, str(d / "port_pre_w"),
                                      init, True)
        tune = _tune_overrides(out["port_pre"]["best"])
        out["jax_tune"] = _run_jax(TUNE, tune, str(d / "jax_tune"))
        out["jax_tune_w"] = _run_jax(TUNE, tune, str(d / "jax_tune_w"),
                                     True)
    init = out["jax_tune"]["init"]
    out["port_tune"] = _run_port(TUNE, tune, str(d / "port_tune"), init)
    out["port_tune_w"] = _run_port(TUNE, tune, str(d / "port_tune_w"), init,
                                   True)
    out["dir"], out["tune_overrides"] = d, tune
    return out


def _val(records):
    return [r for r in records if r["split"] == "val"]


def _metric_violations(runs, kind, port=None):
    """Every (epoch, metric) whose port-vs-JAX distance exceeds its
    tolerance, with the reading."""
    runs_ = (runs[f"jax_{kind}"], port or runs[f"port_{kind}"],
             runs[f"jax_{kind}_w"], runs[f"port_{kind}"],
             runs[f"port_{kind}_w"])
    bad = []
    rows = list(zip(*(_val(r["records"]) for r in runs_)))
    assert len(rows) == 2
    rows.append(tuple(r["result"] for r in runs_))
    for e, (r, p, a, p0, b) in enumerate(rows):
        keys = [k for k in r if k not in ("split", "time", "step", "epoch")]
        assert set(keys) <= set(p), set(keys) - set(p)
        for k in keys:
            scale = max(abs(a[k] - r[k]), abs(b[k] - p0[k]),
                        DISCRETE.get(k.removeprefix("test_"), 0.0))
            tol = CHAOS_FACTOR * scale + FLOOR * abs(r[k])
            if not abs(p[k] - r[k]) <= tol:
                bad.append((e, k, r[k], p[k], tol))
    return bad


def _first_loss(records, step, name):
    return next(r[name] for r in records
                if r["split"] == "train" and r["step"] == step)


def test_pretrain_first_logged_loss(runs):
    want = _first_loss(runs["jax_pre"]["records"], 2, "NTXent")
    got = _first_loss(runs["port_pre"]["records"], 2, "NTXent")
    assert abs(got - want) <= FIRST_LOSS_TOL * abs(want)


def test_pretrain_validation_metrics(runs):
    assert _metric_violations(runs, "pre") == []


def test_tune_first_logged_loss(runs):
    want = _first_loss(runs["jax_tune"]["records"], 4, "L1Loss")
    got = _first_loss(runs["port_tune"]["records"], 4, "L1Loss")
    assert abs(got - want) <= FIRST_LOSS_TOL * abs(want)


def test_tune_validation_and_test_metrics(runs):
    assert any(k.startswith("test_") for k in runs["port_tune"]["result"])
    assert _metric_violations(runs, "tune") == []


def _param_distance(a, b):
    names = sorted(n for n in b if "running" not in n
                   and "num_batches_tracked" not in n)
    x = np.concatenate([a[n].ravel() for n in names]).astype(np.float64)
    y = np.concatenate([b[n].ravel() for n in names]).astype(np.float64)
    return np.linalg.norm(x - y) / np.linalg.norm(y)


@pytest.mark.parametrize("kind", ["pre", "tune"])
def test_final_parameters(runs, kind):
    """The best checkpoint's parameters (what each run ends with, after
    its reload) of each model: relative L2 distance."""
    ref = runs[f"jax_{kind}"]["final"]
    for key, want in ref.items():
        got = runs[f"port_{kind}"]["final"][key]
        scale = max(
            _param_distance(runs[f"jax_{kind}_w"]["final"][key], want),
            _param_distance(runs[f"port_{kind}_w"]["final"][key], got))
        d = _param_distance(got, want)
        assert d <= CHAOS_FACTOR * scale + FLOOR, (key, d, scale)


def test_transfer_count(runs):
    def count(text):
        line = next(x for x in text.splitlines()
                    if x.startswith("transferred "))
        return int(line.split()[1])
    n = count(runs["port_tune"]["text"])
    assert n == count(runs["jax_tune"]["text"]) == 48


def test_run_files(runs):
    for kind in ("pre", "tune"):
        run_dir = os.path.dirname(runs[f"port_{kind}"]["best"])
        for name in ("best_checkpoint.pt", "last_checkpoint.pt",
                     "train_arguments.yaml", "metrics.jsonl",
                     "evaluation_val_best_checkpoint.txt"):
            assert os.path.exists(os.path.join(run_dir, name)), name
    assert os.path.exists(os.path.join(
        os.path.dirname(runs["port_tune"]["best"]), "evaluation_test.txt"))


def test_planted_fault_all_groups_unlocked_at_once(runs, monkeypatch):
    """The port's WarmUpController warming every group from the first
    step (as a single-phase warmup does) must fail the fine-tune check."""
    real = port_schedulers.WarmUpController.step

    def unlock_all(self, metrics=None):
        phases = self.warmup_steps
        self.warmup_steps = [sum(phases)]
        try:
            real(self, metrics)
        finally:
            self.warmup_steps = phases
    monkeypatch.setattr(port_schedulers.WarmUpController, "step",
                        unlock_all)
    faulty = _run_port(TUNE, runs["tune_overrides"],
                       str(runs["dir"] / "port_tune_fault"),
                       runs["jax_tune"]["init"])
    bad = _metric_violations(runs, "tune", faulty)
    assert any(e == 0 and k == "mae_denormalized" for e, k, *_ in bad), bad


def test_without_device_the_cli_needs_the_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_cli.main([f"--config={PRE}", f"--logdir={tmp_path}",
                       "--num_epochs=1"])
