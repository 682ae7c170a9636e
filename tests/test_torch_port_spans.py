"""`infomax3d_tpu_torch/utils/spans.py` on the CPU: nesting and self time,
nothing recorded without a profiler (the `timing` keys still fed), the
tally's recording periods, the host-to-device counters against a collated
batch's two views, and a tiny `SelfSupervisedTrainer.train_epoch` under
`torch.profiler.profile` with every loop and step span in its events."""
import dataclasses
import os
import time

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from infomax3d_tpu_torch.cli import train as cli
from infomax3d_tpu_torch.cli.config import load_config
from infomax3d_tpu_torch.data.loader import to_device
from infomax3d_tpu_torch.losses import get_loss
from infomax3d_tpu_torch.train.trainer import TIMERS
from infomax3d_tpu_torch.utils import spans

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = [ProfilerActivity.CPU]
# `loop.device_wait` is a synchronize, taken on CUDA alone
CPU_NAMES = {"loop.loader", "loop.to_device", "loop.step", "loop.metrics",
             "loop.logging", "loop.checkpoint", "step.forward",
             "step.backward", "step.optimizer"}


@pytest.fixture
def idle():
    """A span outside any profiler, so the next recording starts a fresh
    tally whatever an earlier test left."""
    with spans.span("idle"):
        pass


def _busy(seconds):
    t = time.perf_counter()
    while time.perf_counter() - t < seconds:
        pass


def test_nesting_and_self_time(idle):
    with profile(activities=CPU):
        with spans.span("outer"):
            _busy(0.002)
            with spans.span("inner"):
                with spans.span("leaf"):
                    _busy(0.001)
            with spans.span("inner"):
                _busy(0.001)
    s = spans.tally()["spans"]
    assert {k: v["calls"] for k, v in s.items()} == {"outer": 1, "inner": 2,
                                                     "leaf": 1}
    outer, inner, leaf = s["outer"], s["inner"], s["leaf"]
    # a span's self time leaves out its direct children's whole time
    assert outer["self_s"] == pytest.approx(
        outer["host_s"] - inner["host_s"], abs=1e-9)
    assert inner["self_s"] == pytest.approx(
        inner["host_s"] - leaf["host_s"], abs=1e-9)
    assert leaf["self_s"] == leaf["host_s"] >= 0.001
    assert outer["self_s"] >= 0.002
    assert outer["host_s"] >= inner["host_s"] + outer["self_s"] - 1e-9


def test_no_profiler_records_nothing_but_feeds_timing(idle, monkeypatch):
    opened = []
    real = torch.profiler.record_function

    def record_function(name, *a):
        opened.append(name)
        return real(name, *a)
    monkeypatch.setattr(torch.profiler, "record_function", record_function)
    with profile(activities=CPU):
        with spans.span("before"):
            pass
    before = spans.tally()
    assert opened == ["before"]
    timing = {"step": 0.0}
    with spans.span("loop.step", timing, "step"):
        _busy(0.001)
    with spans.span("step.forward"):
        pass
    spans.count("h2d_bytes", 10)
    assert opened == ["before"]              # no range opened
    assert timing["step"] >= 0.001
    assert spans.tally() == before
    # under a profiler the same span feeds its key and the tally both
    with profile(activities=CPU) as prof:
        with spans.span("loop.step", timing, "step"):
            _busy(0.001)
    assert timing["step"] >= 0.002
    assert spans.tally()["spans"]["loop.step"]["calls"] == 1
    assert [e.name for e in prof.events()].count("loop.step") == 1


def test_tally_restarts_per_recording_and_freezes(idle):
    with profile(activities=CPU):
        for _ in range(2):
            with spans.span("a"):
                pass
        spans.count("n", 3)
        spans.count("n", 4)
        open_span = spans.span("late")
        open_span.__enter__()
    # started while the profiler recorded: still counts when it ends
    open_span.__exit__(None, None, None)
    first = spans.tally()
    assert {k: v["calls"] for k, v in first["spans"].items()} == {"a": 2,
                                                                  "late": 1}
    assert first["counters"] == {"n": 7}
    with spans.span("a"):                    # no profiler: frozen
        pass
    spans.count("n", 1)
    assert spans.tally() == first
    with profile(activities=CPU):
        with spans.span("b"):
            pass
        spans.count("m", 1)
    second = spans.tally()
    assert set(second["spans"]) == {"b"}
    assert second["counters"] == {"m": 1}
    # the returned tally is a copy
    second["spans"]["b"]["calls"] = 99
    assert spans.tally()["spans"]["b"]["calls"] == 1


def _tiny_trainer(tmp_path):
    """`configs_clean/pre-train_synthetic.yml` at tiny widths, built as
    `cli/train.py::run_training` builds it, on the CPU: (trainer, train
    loader)."""
    args = load_config(os.path.join(ROOT, "configs_clean",
                                    "pre-train_synthetic.yml"))
    args.update(device="cpu", logdir=str(tmp_path / "runs"),
                use_tensorboard=False, batch_size=8, num_train=32,
                log_iterations=2, dataset_params={"num": 48, "n_max": 12})
    args["model_parameters"].update(hidden_dim=8, target_dim=8,
                                    readout_hidden_dim=8,
                                    propagation_depth=1)
    args["model3d_parameters"].update(hidden_dim=4, target_dim=8,
                                      readout_hidden_dim=4)
    cli.resolve_collate(args)
    dataset = cli.build_dataset(args)
    cli.apply_dataset_protocol(args, dataset)
    metrics = cli.build_metrics(args, dataset)
    cli.resolve_fast_paths(args)
    trainer = cli.trainer_class(args)(
        cli.build_models(args, dataset), args, metrics=metrics,
        main_metric=args["main_metric"], run_dir=str(tmp_path / "run"),
        loss_func=get_loss(args["loss_func"], **args["loss_params"]),
        loss_name=args["loss_func"],
        main_metric_goal=args["main_metric_goal"],
        scheduler_step_per_batch=args["scheduler_step_per_batch"],
        device="cpu", use_tensorboard=False)
    trainer.init_state()
    return trainer, cli.make_loaders(args, dataset)[0]


def _tensor_fields(batch):
    return {f.name: getattr(batch, f.name) for f in dataclasses.fields(batch)
            if isinstance(getattr(batch, f.name), torch.Tensor)}


def test_h2d_counters_match_the_collated_views(idle, tmp_path):
    _, loader = _tiny_trainer(tmp_path)
    batch = next(iter(loader))
    with profile(activities=CPU):
        moved = {v: to_device(batch[v], "cpu")
                 for v in ("graph2d", "graph3d")}
    want_bytes = want_copies = 0
    for v, g in moved.items():
        fields = _tensor_fields(g)
        assert set(fields) <= set(batch[v])
        want_bytes += sum(batch[v][k].nbytes for k in fields)
        want_copies += len(fields)
    assert type(moved["graph3d"]).__name__ == "DenseBatch"   # both paths
    assert spans.tally()["counters"] == {"h2d_bytes": want_bytes,
                                         "h2d_copies": want_copies}


def test_train_epoch_under_the_profiler(idle, tmp_path):
    plain, loader = _tiny_trainer(tmp_path / "plain")
    plain.train_epoch(loader, 1)
    trainer, loader = _tiny_trainer(tmp_path / "traced")
    trainer.train_epoch(loader, 1)
    with profile(activities=CPU) as prof:
        trainer.train_epoch(loader, 2)
        trainer.save_checkpoint(2, "last_checkpoint.pt")
    names = {e.name for e in prof.events()}
    assert CPU_NAMES <= names
    t = spans.tally()
    assert set(t["spans"]) == CPU_NAMES
    steps = len(loader)
    assert t["spans"]["loop.step"]["calls"] == steps
    for name in ("step.forward", "step.backward", "step.optimizer"):
        assert t["spans"][name]["calls"] == steps
    inside = sum(t["spans"][n]["host_s"] for n in ("step.forward",
                                                   "step.backward",
                                                   "step.optimizer"))
    assert inside <= t["spans"]["loop.step"]["host_s"]
    assert t["spans"]["loop.step"]["self_s"] == pytest.approx(
        t["spans"]["loop.step"]["host_s"] - inside, abs=1e-9)
    assert t["counters"]["h2d_copies"] % steps == 0
    assert t["counters"]["h2d_bytes"] > 0
    # `timing` keeps its keys, fed by the spans
    want = set(TIMERS) | {"step_ms", "train_epoch_s", "eval_s"}
    assert set(plain.timing) == set(trainer.timing) == want
    for k in ("loader", "to_device", "step", "metrics", "logging",
              "checkpoint"):
        assert trainer.timing[k] > 0, k
    assert trainer.timing["device_wait"] == 0.0
