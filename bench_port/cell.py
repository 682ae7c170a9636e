"""One run of one cell: the program's set-up, its checked first steps, the
measured window, the traced log period, the reference and the result.

The run builds the trainer as the port's `cli/train.py::run_training`
builds it, loads the weights made from the seed, and collates a pool of
distinct batches with the loader, buckets and collate arguments that the
port's `cli/train.py::make_loaders` sets for the pool's molecules.  It
runs the trainer's own `train_epoch` (`SelfSupervisedTrainer`'s with a 3D
model, the supervised `Trainer`'s without) on the loader's host batches
as they come (numpy in pageable memory, copied to the card by each
step's `_prepare`), with torch's host threads as the CLI leaves them:
first three steps on three distinct batches, whose losses, outputs,
first gradient and parameter change the reference follows, one more
warm step, then the window, which cycles the pool through the same call
until the first log boundary after `seconds`.
With `trace` the profiler covers the window's first whole log period.
The program is then freed, the reference runs on the same molecules and
weights, and `compare` decides `correct`."""
from __future__ import annotations

import gc
import json
import os
import shutil
import sys
import tempfile
import time
from contextlib import nullcontext
from dataclasses import dataclass, replace
from statistics import mean
from typing import Dict, List, Optional

import numpy as np

from bench_port import compare, faults, manifest, trace
from bench_port.molecules import MoleculePool, PoolDataset
from bench_port.weights import make_weights, model_state

FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "infomax3d_tpu")
TIMERS = ("to_device", "step", "device_wait", "metrics", "logging")
CHECKED_STEPS = 3


def progress(what: str) -> None:
    """One line on standard error: the run's step, the time and the
    process's peak resident memory so far."""
    import resource
    rss = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2 ** 20
    print(f"{what} at {time.perf_counter():.3f}, peak resident "
          f"{rss:.2f} GiB", file=sys.stderr, flush=True)


def forbidden_modules() -> List[str]:
    """The forbidden top-level names among the loaded modules (compared
    whole: the port's name begins with the JAX package's)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


@dataclass
class Options:
    workload: str
    seed: int
    seconds: float
    trace: bool
    device: str = "cuda"
    fault: Optional[str] = None
    root: str = manifest.ROOT


def device_of(opts: Options):
    import torch
    if opts.device != "cuda":
        return torch.device("cpu")
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    return dev


def collate_pool(args: Dict, traffic: Dict, seed: int):
    """The pool's batches in the pool's order, each a host dict of numpy
    arrays, collated by the port's loader into the buckets and with the
    collate arguments of the training loader that its CLI's `make_loaders`
    builds for the pool's molecules."""
    from infomax3d_tpu_torch.cli.train import make_loaders
    from infomax3d_tpu_torch.data.loader import GraphDataLoader
    B, C = int(args["batch_size"]), int(args.get("num_conformers", 1))
    dataset = PoolDataset(MoleculePool(seed, traffic, B, C),
                          int(traffic["pool_batches"]) * B)
    cli = make_loaders(args, dataset)[0]
    return list(GraphDataLoader(dataset, B, cli.collate, bucket=cli.bucket,
                                shuffle=False, drop_last=True,
                                collate_kwargs=cli.collate_kwargs,
                                prefetch=0))


def real_counts(batches) -> Dict[str, Dict[str, float]]:
    """The mean real atoms, edges and graphs (and triplets, where a view has
    them) of each graph view of the collated `batches`, by the view's key
    (``graph2d`` / ``graph3d``, or ``graph`` in a supervised batch)."""
    views = [v for v, arrays in batches[0].items()
             if isinstance(arrays, dict) and "node_mask" in arrays]
    masks = {"nodes": "node_mask", "edges": "edge_mask",
             "graphs": "graph_mask", "triplets": "tri_mask"}
    return {v: {name: mean(float(b[v][mask].sum()) for b in batches)
                for name, mask in masks.items() if mask in batches[0][v]}
            for v in views}


# the view of a collated batch that each model reads: the 2D model's is
# ``graph2d`` beside a 3D model, ``graph`` in a supervised batch
VIEWS = {"model": ("graph2d", "graph"), "model3d": ("graph3d",)}


def step_flops(args: Dict, counts: Dict) -> float:
    """Model FLOPs of one step: 3 x the forward matrix products of the
    configuration's models (`flops/<model_type>.py`, on the counts of the
    view each reads) and of its loss (`flops/<loss_func>.py`, on the
    counts by model key)."""
    from bench_port.reference.run import model_keys

    def counter(name):
        return trace.load_file(os.path.join(manifest.BENCH, "flops",
                                            f"{name}.py"),
                               f"bench_port_flops_{name}").forward_flops
    by_model = {k: next(counts[v] for v in VIEWS[k] if v in counts)
                for k in model_keys(args)}
    models = sum(counter(args[f"{k}_type"])(args[f"{k}_parameters"], c)
                 for k, c in by_model.items())
    loss = counter(args["loss_func"])(args, by_model)
    return 3.0 * (models + loss)


class Program:
    """The trainer and batches, built as the port's CLI builds a run, with
    the weights made from the seed."""

    def __init__(self, cell: manifest.Cell, opts: Options, dev, work: str):
        import torch
        from infomax3d_tpu_torch.cli.config import load_config
        from infomax3d_tpu_torch.cli.train import (build_metrics,
                                                   build_models,
                                                   check_parallel_modes,
                                                   resolve_collate,
                                                   resolve_fast_paths,
                                                   trainer_class)
        from infomax3d_tpu_torch.losses import get_loss
        from infomax3d_tpu_torch.utils.setup import seed_all
        self.t_built = time.perf_counter()
        self.torch, self.dev = torch, dev
        self.cuda = dev.type == "cuda"
        args = load_config(cell.config_path)
        if int(args.get("n_shards", 1)) != 1:
            raise ValueError(f"{cell.name}: the harness runs one card; "
                             f"n_shards is {args.get('n_shards')}")
        args.update(device=dev.type, logdir=os.path.join(work, "runs"))
        resolve_collate(args)
        check_parallel_modes(args)
        seed_all(args["seed"])
        metrics = build_metrics(args, None)
        resolve_fast_paths(args)
        loss_name = args["loss_func"]
        loss_func = get_loss(loss_name, **(args.get("loss_params") or {}))
        models = build_models(args, None)
        weights = make_weights(args, opts.seed, dev)
        for key, model in models.items():
            model.to(dev).load_state_dict(model_state(weights, key),
                                          strict=True)
        del weights
        self.trainer = trainer_class(args)(
            models, args, metrics=metrics, main_metric=args["main_metric"],
            run_dir=os.path.join(work, "run"), loss_func=loss_func,
            loss_name=loss_name, main_metric_goal=args["main_metric_goal"],
            scheduler_step_per_batch=args["scheduler_step_per_batch"],
            device=dev, use_tensorboard=args.get("use_tensorboard", True))
        self.trainer.init_state()
        self.args = args
        progress("trainer built")
        self.parts = {"trainer": time.perf_counter()}
        self.batches = collate_pool(args, cell.traffic, opts.seed)
        progress("batches collated")
        self.parts["collate"] = time.perf_counter()
        if len(self.batches) < CHECKED_STEPS + 1:
            raise ValueError("the pool holds fewer batches than the checked "
                             "steps and a warm one")
        self.flops = step_flops(args, real_counts(self.batches))
        self.graphs_per_step = int(args["batch_size"])

    def sync(self):
        if self.cuda:
            self.torch.cuda.synchronize(self.dev)

    def leaves(self) -> Dict:
        """The models' parameters and float BatchNorm statistics, by
        ``<key>.<name>``."""
        tr = self.trainer
        out = dict(tr.named_parameters())
        for key in tr.MODEL_KEYS:
            for n, b in tr.models[key].named_buffers():
                if b.is_floating_point():
                    out[f"{key}.{n}"] = b
        return out

    def first_gradients(self) -> Dict[str, float]:
        """Each parameter's first gradient as Adam got it, from its state
        after one step (``exp_avg / (1 - beta1)``); 0 without state."""
        opt = self.trainer.optimizer
        beta = {id(p): g["betas"][0] for g in opt.param_groups
                for p in g["params"]}
        out = {}
        for n, p in self.trainer.named_parameters():
            m = opt.state.get(p, {}).get("exp_avg")
            out[n] = 0.0 if m is None else float(
                self.torch.linalg.vector_norm(m) / (1 - beta[id(p)]))
        return out

    def checked_steps(self) -> Dict:
        """The first steps through `train_epoch`, one distinct batch each,
        logging every step, then one warm step: the losses, the first
        step's outputs, the first gradient and each leaf's change
        (`compare`)."""
        from infomax3d_tpu_torch.train.trainer import Trainer
        tr, torch = self.trainer, self.torch
        start = {n: t.detach().clone() for n, t in self.leaves().items()}
        losses: List[float] = []
        outputs: List = []
        log, log_it = tr.logger.log, tr.args["log_iterations"]

        def capture(m, split, step, epoch):
            if split == "train":
                losses.append(float(m[tr.loss_name]))
            return log(m, split, step, epoch)

        def first_rows(batch, out):
            # the models' outputs of the first step, as the metrics read
            # them (a supervised trainer's rows end with the targets)
            rows = Trainer._rows(tr, batch, out)
            if not outputs:
                outputs.extend(np.array(r, np.float32)
                               for r in rows[:len(tr.MODEL_KEYS)])
            return rows
        tr.logger.log, tr.args["log_iterations"] = capture, 1
        tr._rows = first_rows
        try:
            tr.train_epoch(self.batches[:1], 1)
            grad = self.first_gradients()
            for b in self.batches[1:CHECKED_STEPS]:
                tr.train_epoch([b], 1)
            change = {n: float(torch.linalg.vector_norm(t.detach() -
                                                         start[n]))
                      for n, t in self.leaves().items()}
        finally:
            tr.logger.log, tr.args["log_iterations"] = log, log_it
            del tr._rows
        tr.train_epoch(self.batches[CHECKED_STEPS:CHECKED_STEPS + 1], 1)
        self.sync()
        progress("first steps done")
        self.parts["first_steps"] = time.perf_counter()
        return {"losses": losses, "grad": grad, "change": change,
                "outputs": outputs}

    def window(self, opts: Options, t_start: float) -> Dict:
        """The measured window (module docstring); returns its readings."""
        torch, tr = self.torch, self.trainer
        self.sync()
        if self.cuda:
            torch.cuda.reset_peak_memory_stats(self.dev)
        t0 = time.perf_counter()
        timing0 = {k: tr.timing[k] for k in TIMERS}
        n_ms = len(tr.timing["step_ms"])
        feed = WindowFeed(self, opts, t0)
        tr.train_epoch(feed, 1)
        self.sync()
        t1 = time.perf_counter()
        progress(f"window closed after {feed.steps} steps")
        timing = {k: tr.timing[k] - timing0[k] for k in TIMERS}
        step_ms = list(tr.timing["step_ms"][n_ms:])
        marks = [("start", t_start), ("imports", self.t_built)] + list(
            self.parts.items()) + [("window", t0)]
        out = {"window_s": t1 - t0, "setup_s": t0 - t_start,
               "setup_parts": {b: round(tb - ta, 3) for (_, ta), (b, tb)
                               in zip(marks, marks[1:])},
               "window_parts": {"host_s": {k: round(v, 3)
                                           for k, v in timing.items()},
                                "device_step_s": round(sum(step_ms) / 1e3,
                                                       3),
                                "log_periods_s": [round(b - a, 3) for a, b
                                                  in zip(feed.marks,
                                                         feed.marks[1:])],
                                "threads": torch.get_num_threads()},
               "steps": feed.steps,
               "graphs": feed.steps * self.graphs_per_step,
               "peak_bytes": int(torch.cuda.max_memory_allocated(self.dev))
               if self.cuda else 0,
               "flops": self.flops, "profile": None}
        timed_s, timed_steps = out["window_s"], feed.steps
        if feed.traced is not None:
            # the timing metrics leave the profiled period out
            prof, (k0, k1), (p0, p1), (at0, at1) = feed.traced
            out["profile"] = trace.summarize(prof, p1 - p0, k1 - k0,
                                             feed.recorder, peaks())
            progress("trace read")
            timing = {k: timing[k] - (at1[k] - at0[k]) for k in TIMERS}
            step_ms = step_ms[:k0] + step_ms[k1:]
            timed_s -= p1 - p0
            timed_steps -= k1 - k0
        out.update(timing=timing, step_ms=step_ms, timed_s=timed_s,
                   timed_steps=timed_steps)
        return out

    def close(self):
        self.trainer.logger.close()
        del self.trainer, self.batches
        gc.collect()
        if self.cuda:
            self.torch.cuda.empty_cache()


def peaks() -> Dict[str, float]:
    """The card's published peaks (`peaks.json`)."""
    with open(os.path.join(manifest.BENCH, "peaks.json")) as f:
        return json.load(f)


class WindowFeed:
    """The window's batches for `train_epoch`: the pool in turn, until the
    first log boundary at or past `seconds` (and past the traced period);
    at the first boundary of a traced run the profiler starts and at the
    next it stops.  `marks` keeps the time of each boundary."""

    def __init__(self, program: Program, opts: Options, t0: float):
        self.p, self.opts, self.t0 = program, opts, t0
        self.steps = 0
        self.marks: List[float] = []
        self.prof = None
        self.traced = None
        self.recorder = None

    def _profile(self):
        """Start the profiler, or stop it: `traced` then holds it, the
        profiled steps, the host times and the trainer's timers at both
        ends."""
        from torch.profiler import ProfilerActivity, profile
        timers = {k: self.p.trainer.timing[k] for k in TIMERS}
        if self.prof is None:
            acts = [ProfilerActivity.CPU] + (
                [ProfilerActivity.CUDA] if self.p.cuda else [])
            self.recorder = trace.LaunchRecorder()
            self.recorder.install()
            self.prof = profile(activities=acts)
            self.start = (self.steps, time.perf_counter(), timers)
            self.prof.start()
            return
        self.p.sync()
        p1 = time.perf_counter()
        self.prof.stop()
        self.recorder.remove()
        k0, p0, at0 = self.start
        self.traced = (self.prof, (k0, self.steps), (p0, p1), (at0, timers))

    def __iter__(self):
        tr = self.p.trainer
        log_it = tr.args["log_iterations"]
        pool = self.p.batches
        while True:
            if self.steps and tr.optim_steps % log_it == 0:
                now = time.perf_counter()
                self.marks.append(now)
                if self.opts.trace and self.traced is None:
                    self._profile()
                if now - self.t0 >= self.opts.seconds and (
                        self.traced is not None or not self.opts.trace):
                    return
            yield pool[self.steps % len(pool)]
            self.steps += 1


def run_program(cell: manifest.Cell, opts: Options, t_start: float) -> Dict:
    """The program's run: set-up, checked steps and window, with the fault
    `opts.fault` planted where one is named; its readings."""
    dev = device_of(opts)
    work = tempfile.mkdtemp(prefix="bench_port_")
    try:
        with faults.planted(opts.fault) if opts.fault else nullcontext():
            program = Program(cell, opts, dev, work)
            record = program.checked_steps()
            out = program.window(opts, t_start)
            program.close()
    finally:
        shutil.rmtree(work, ignore_errors=True)
    out["record"] = record
    return out


def checked_records(cell: manifest.Cell, opts: Options,
                    seeds: List[int]) -> List[Dict]:
    """The program's checked steps for each of `seeds` in turn, nothing
    measured (`calibrate.py`)."""
    dev = device_of(opts)
    records = []
    work = tempfile.mkdtemp(prefix="bench_port_")
    try:
        with faults.planted(opts.fault) if opts.fault else nullcontext():
            for seed in seeds:
                program = Program(cell, replace(opts, seed=seed), dev, work)
                records.append(program.checked_steps())
                program.close()
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return records


def reference_record(cell: manifest.Cell, seed: int, dev, q=None,
                     take=None) -> Dict:
    """The reference's first steps on the batches the program's checked
    steps ran, from the weights made again from the seed.  `q` rounds the
    reference's matrix operands (the control); `take` maps a batch's
    molecules to those the reference reads (a fault planted in the
    reference put in the program's place)."""
    from bench_port.reference.nn import identity
    from bench_port.reference.run import ReferenceRun
    from infomax3d_tpu_torch.cli.config import load_config
    args = load_config(cell.config_path)
    B, C = int(args["batch_size"]), int(args.get("num_conformers", 1))
    pool = MoleculePool(seed, cell.traffic, B, C)
    run = ReferenceRun(args, make_weights(args, seed, dev),
                       manifest.reference_parts(args), q or identity)
    batches = []
    for j in range(CHECKED_STEPS):
        mols = [pool.molecule(i) for i in range(j * B, (j + 1) * B)]
        batches.append(run.batch(take(mols) if take else mols, dev))
    return run.run(batches)


def execute(opts: Options, t_start: float) -> Dict:
    """A whole run of a cell; returns the result line's object."""
    cell = manifest.cell(opts.workload, opts.root)
    if cell.chips != 1:
        raise ValueError(f"{cell.name}: the harness runs one card, the cell "
                         f"asks for {cell.chips}")
    out = run_program(cell, opts, t_start)
    ref = reference_record(cell, opts.seed, device_of(opts))
    read = compare.readings(out["record"], ref)
    verdict = compare.judge(read, compare.load_limits(cell.name))
    return assemble(cell, opts, out, verdict)


def assemble(cell: manifest.Cell, opts: Options, run: Dict,
             verdict: Dict) -> Dict:
    """The result line: the cell's metrics (end-to-end, or per-layer with
    `trace`), the device, the breakdown and the checks, last.  The metric
    readers get the run as the one entry of ``ctx["ranks"]``."""
    import torch
    ctx = {"setup_s": run["setup_s"], "window_s": run["window_s"],
           "steps": run["steps"], "graphs": run["graphs"],
           "timed_s": run["timed_s"], "timed_steps": run["timed_steps"],
           "ranks": [run], "step_flops": run["flops"], "peaks": peaks()}
    bench = manifest.load(opts.root)
    units = {m["name"]: m["unit"] for m in bench["end_to_end"] +
             bench["per_layer"]}
    metrics = {}
    for name in (cell.per_layer if opts.trace else cell.end_to_end):
        value = trace.load_file(os.path.join(manifest.BENCH, "metrics",
                                             f"{name}.py"),
                                f"bench_port_metric_{name}").read(ctx)
        if value is not None:
            metrics[name] = {"value": float(value), "unit": units[name]}
    cuda = opts.device == "cuda"
    device = {"platform": "gpu" if cuda else "cpu",
              "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
              "count": cell.chips, "memory_peak_bytes": run["peak_bytes"]}
    out = {"correct": verdict["correct"], "attempted": run["steps"],
           "failed": 0, "metrics": metrics, "device": device}
    profile = run["profile"]
    if profile is not None:
        device["busy_s"] = profile["busy_s"]
        device["window_s"] = profile["window_s"]
        out["breakdown"] = {"device_ops": profile["device_ops"],
                            "idle_gaps": profile["idle_gaps"]}
    out["setup_parts"] = run["setup_parts"]
    out["window_parts"] = run["window_parts"]
    out["readings"] = {k: v for k, v in verdict["readings"].items()
                       if k not in verdict["checks"]}
    out["checks"] = verdict["checks"]
    return out
