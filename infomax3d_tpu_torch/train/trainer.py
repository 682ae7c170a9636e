"""Training engine (port of `infomax3d_tpu/train/trainer.py`: `Trainer`,
`SelfSupervisedTrainer`, `SelfSupervisedAlternatingTrainer`,
`SelfSupervisedAETrainer`, `NoisyNegativesTrainer`, `BYOLTrainer`,
`PhilosophyTrainer`, `GraphCLTrainer`, `DistancePredictorTrainer` and
`OptimalTransportTrainer`).

The host loop is the JAX package's, which is the contract of the
reference's `Trainer.train` (trainer/trainer.py:69-109): epochs,
`log_iterations`, validation per batch or per epoch (`val_per_batch`),
early stopping on the main metric with `patience` and `minimum_epochs`,
`best_checkpoint.pt` / `last_checkpoint.pt` / `best_checkpoint_{n}epochs.pt`
and `train_arguments.yaml` in the run directory, resuming from
`checkpoint`, the model source snapshot, the linear probe, the
`evaluation_*.txt` files, and the reload of the best checkpoint at the end.

The step is not written again here: the supervised trainer runs
`train/supervised.py::SupervisedStep` (handing each training step a source
of dropout masks drawn on the trainer's device from one generator seeded
with `seed`, and no noise, as the JAX trainer hands its model a
``dropout`` rng alone; eval steps draw nothing; the contrastive, the
autoencoder and the distance trainers do the same), the contrastive one
`train/pretrain.py::PretrainStep` (its flavours `train/flavours.py`), BYOL
`train/byol.py::BYOLStep`, the baselines the steps of
`train/baselines.py` and the OT trainer `train/ot.py::OTStep`, each built over the config's models and
the grouped optimizer (`train/optim.py`), so the bf16 recipe (float32
masters, bf16 forward, float32 outputs into the loss) is the steps'.  The
learning rates come from an `LRController` per the config and are written
into the torch param groups before every step.

Batches arrive from `GraphDataLoader` as numpy arrays and move to the
trainer's device here.  `timing` accumulates the host seconds spent waiting
on the loader, moving batches, in the steps' launches, waiting for the
device before reading results (a synchronize, so the metrics' seconds are
the host's own), in metrics, in checkpoints and in logging, the wall seconds of each epoch's training and
validation, and (on CUDA) the device milliseconds of each train step
between CUDA events, so a caller can account for a loop's time.  Each
host part is a span of `utils/spans.py` that feeds its `timing` key:
``loop.loader``, ``loop.to_device``, ``loop.step``, ``loop.device_wait``,
``loop.metrics``, ``loop.logging`` and ``loop.checkpoint`` (the OT
trainer's ``step.emd`` feeds ``host_emd``); inside a training step the
spans ``step.forward``, ``step.backward`` and ``step.optimizer`` feed no
key.  While a torch profiler records, every span also lands in its trace
and in `spans.tally()`, with the host-to-device counters ``h2d_bytes``
and ``h2d_copies`` of `graphs/batch.py`.

Data parallelism (the JAX package's ``n_shards`` mode, `parallel/`): given
a process `group`, each rank trains on its shard of every batch
(`GraphDataLoader(n_shards=k, shard=r)`).  The loss is wrapped in
`CrossDeviceLoss`, every rank starts from rank 0's weights (broadcast
once), each rank's dropout generator is seeded from (seed, rank), the
steps run under `parallel.context.using_groups(data=group)` (global
BatchNorm statistics and supervised loss, the gradient mean).  Every
rank's loss, and each of its logged parts, is then the global batch's
(the JAX step's ``pmean`` of equal losses), and the predictions and
targets the metrics read are gathered, so every rank takes the same
early-stopping and best-checkpoint decisions.  Only rank 0 writes the run directory.  The
philosophy and OT trainers refuse a group, as the JAX package has no
data-parallel step for them.

The partitioned modes (``graph_shards``, ``node_shards``): given a `grid`
(`parallel/mesh.py::Grid`, n data shards x k graph parts), each rank
trains on its part of its data shard's batch (the loader cuts it,
`parallel/edge_partition.py`, `parallel/node_partition.py`), the steps
run under `parallel.context.using_groups` (the partition group for the
aggregations' completions and halo exchanges, every rank for the
BatchNorm statistics and the gradient mean), the loss is wrapped over
the data group alone, and the dropout generator is seeded from the data
index alone, so the ranks of one batch draw the same masks (the JAX
step's ``fold_in`` of the data index).  The predictions are whole on
every rank of a batch (the readouts are completed), so the metrics
gather them over the data group.  The philosophy and OT trainers refuse a
grid too.

Tensor parallelism (``model_shards``, `parallel/tp.py`): given a grid in
mode "model" (n data shards x k model parts), each model is sharded after
its weights are set (`init_variables`, the broadcast from rank 0) and
before the optimizer is built, so each rank's optimizer holds its shards'
masters and moments; the steps and the evaluation forwards run under the
model group (the forwards gather the shards), the ranks of one data shard
read the same batch and draw the same dropout masks (the generator seeded
from the data index), and the gradient mean, the loss's gathers and the
BatchNorm statistics span the data group alone.  A checkpoint holds whole
tensors: every rank gathers its shards, rank 0 writes; a load (resume,
the best checkpoint's reload, the pre-trained transfer) cuts each leaf to
the rank's part, so a tensor-parallel checkpoint loads into a
one-process run and the other way round.
"""
from __future__ import annotations

import inspect
import json
import math
import os
import shutil
import time
from contextlib import contextmanager
from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch
import torch.distributed as dist

from infomax3d_tpu_torch.cli import yaml_lite
from infomax3d_tpu_torch.data.loader import to_device, to_ot_batch
from infomax3d_tpu_torch.device import resolve_device
from infomax3d_tpu_torch.interop import flax_paths, load_variables
from infomax3d_tpu_torch.parallel.collectives import (CrossDeviceLoss,
                                                      broadcast_,
                                                      gather_host)
from infomax3d_tpu_torch.parallel import tp
from infomax3d_tpu_torch.parallel.context import using_groups
from infomax3d_tpu_torch.train import checkpoint
from infomax3d_tpu_torch.train.baselines import (AEStep, DistanceStep,
                                                GraphCLStep)
from infomax3d_tpu_torch.train.byol import BYOLStep
from infomax3d_tpu_torch.train.flavours import (AlternatingStep,
                                                NoisyNegativesStep,
                                                PhilosophyStep)
from infomax3d_tpu_torch.train.logging import (TENSORBOARD_FUNCTIONS,
                                               NullLogger, RunLogger)
from infomax3d_tpu_torch.train.optim import (OptimizerSet, build_optimizer,
                                             label_params)
from infomax3d_tpu_torch.train.ot import OTStep
from infomax3d_tpu_torch.train.precision import resolve_compute_dtype
from infomax3d_tpu_torch.train.pretrain import PretrainStep
from infomax3d_tpu_torch.train.schedulers import LRController
from infomax3d_tpu_torch.train.supervised import (SupervisedStep,
                                                  masks_source)
from infomax3d_tpu_torch.utils.spans import span

TIMERS = ("loader", "to_device", "step", "device_wait", "metrics",
          "checkpoint", "logging")


def rank_seed(seed: int, rank: int) -> int:
    """The dropout generator's seed of data-parallel rank `rank`: `seed`
    itself on rank 0 (so one rank draws as one process does), another
    stream per rank from (seed, rank) (the JAX step's ``fold_in``)."""
    if rank == 0:
        return int(seed)
    return int(np.random.SeedSequence([int(seed), int(rank)])
               .generate_state(1, np.uint64)[0] & (2 ** 63 - 1))


class Trainer:
    """Supervised trainer (reference base `Trainer`).  `models` maps
    ``model`` to the port's module; `init_variables` optionally maps it to
    flax numpy trees (``params``, ``batch_stats``) loaded before training,
    e.g. another implementation's initial weights.  `generator` (on the
    device, seeded with `seed`, `rank_seed` under a group) draws the
    dropout masks and, for the OT trainer, the noise.  `group` is the
    data-parallel process group (module docstring), None for one
    process; `grid` the (data, graph) grid of a partitioned run or the
    (data, model) grid of a tensor-parallel one, whose data group
    replaces `group`."""

    MODEL_KEYS = ("model",)
    # each training step gets a source of dropout masks (the supervised
    # step; the other flavours' steps take none)
    DRAWS_MASKS = True
    # why a trainer refuses a data-parallel group or a partitioned grid
    # (None: it takes them); tensor parallelism alone it takes
    NO_DATA_PARALLEL: Optional[str] = None
    # the equal blocks of rows of the targets the metrics read, each
    # gathered over the ranks in turn
    TARGET_BLOCKS = 1

    def __init__(self, models: Dict[str, torch.nn.Module], args: Dict,
                 metrics: Dict[str, Any], main_metric: str, run_dir: str,
                 loss_func: Any = None, loss_name: str = "MSELoss",
                 main_metric_goal: str = "min",
                 scheduler_step_per_batch: bool = True, device=None,
                 use_tensorboard: bool = True,
                 init_variables: Optional[Mapping[str, Mapping]] = None,
                 group: Optional[dist.ProcessGroup] = None, grid=None):
        # a tensor-parallel grid of one data shard is no data parallelism
        tp_alone = (getattr(grid, "mode", None) == "model"
                    and grid.data is None)
        if (group is not None or (grid is not None and not tp_alone)) \
                and self.NO_DATA_PARALLEL:
            raise NotImplementedError(self.NO_DATA_PARALLEL)
        self.device = resolve_device(device)
        if grid is not None:
            group = grid.data
        self.group = group          # the data-parallel group
        self.grid = grid
        # the tensor-parallel model group (None without model_shards)
        self.model_group = None if grid is None else grid.model
        # every rank of the run
        self.world = grid.step if grid is not None else group
        self.rank = 0 if self.world is None else dist.get_rank(self.world)
        self.models = models
        self.args = args
        self.metrics = metrics
        if group is not None and loss_func is not None:
            loss_func = CrossDeviceLoss(loss_func, group)
        self.loss_func = loss_func
        self.loss_name = loss_name
        self.main_metric = loss_name if main_metric == "loss" else main_metric
        self.main_metric_goal = main_metric_goal
        self.compute_dtype = resolve_compute_dtype(
            args.get("bf16_compute", "auto"), self.device)
        self.run_dir = run_dir
        self.init_variables = init_variables
        if self.rank == 0:
            os.makedirs(run_dir, exist_ok=True)
            self.logger = RunLogger(run_dir, use_tensorboard=use_tensorboard)
        else:
            self.logger = NullLogger()
        self.tensorboard_functions = {
            name: TENSORBOARD_FUNCTIONS[name]
            for name in (args.get("tensorboard_functions") or [])
            if name in TENSORBOARD_FUNCTIONS}
        self.step = None
        self.optimizer: Optional[torch.optim.Optimizer] = None
        self.lr_controllers: Dict[str, LRController] = {}
        self.active_groups: Dict[str, list] = {}
        self.scheduler_step_per_batch = scheduler_step_per_batch
        self.start_epoch = 1
        self.optim_steps = 0
        self.best_val_score = -math.inf if main_metric_goal == "max" \
            else math.inf
        self.timing: Dict[str, Any] = {k: 0.0 for k in TIMERS}
        self.timing.update(step_ms=[], train_epoch_s=[], eval_s=[])
        self._events = []
        self.generator = torch.Generator(device=self.device).manual_seed(
            rank_seed(args.get("seed", 0), self.rank if grid is None
                      else grid.data_index))

    # ------------------------------------------------------------------ init
    def init_state(self, example_batch=None):
        """Load `init_variables`, place the models on the device, build the
        grouped optimizer, the lr controller and the step; then resume from
        `checkpoint` when the config names one.  `example_batch` is unused
        (the JAX package initializes its parameters from one)."""
        del example_batch
        for key in self.MODEL_KEYS:
            if self.init_variables is not None:
                load_variables(self.models[key], self.init_variables[key])
            self.models[key].to(self.device).train()
        self._broadcast_state()
        self._shard_models()
        self._build_optimizer()
        self.step = self._make_step()
        self.step.remat = bool(self.args.get("remat", False))
        self._snapshot_model_source()
        if self.args.get("checkpoint"):
            self._load(self.args["checkpoint"])
        return self.step

    def named_parameters(self):
        for key in self.MODEL_KEYS:
            for n, p in self.models[key].named_parameters():
                yield f"{key}.{n}", p

    def _build_optimizer(self):
        """Reference param groups (trainer.py:216-238) over the models'
        joint tree, labelled on the flax paths as the JAX package does."""
        paths = {f"{key}.{n}": f"{key}/{p}" for key in self.MODEL_KEYS
                 for n, p in flax_paths(self.models[key]).items()}
        labels, active = label_params(
            paths,
            transfer_layers=self.args.get("transfer_layers") or (),
            exclude_from_transfer=self.args.get("exclude_from_transfer")
            or (),
            frozen_layers=self.args.get("frozen_layers") or ())
        op = dict(self.args.get("optimizer_params", {}) or {})
        op["betas"] = tuple(op.get("betas", (0.9, 0.999)))
        self.optimizer = build_optimizer(
            self.named_parameters(), labels,
            self.args.get("optimizer", "Adam"),
            transferred_lr=self.args.get("transferred_lr"), **op)
        self.labels = labels
        self.active_groups["main"] = active
        self.lr_controllers["main"] = LRController(
            [g["lr"] for g in self.optimizer.param_groups],
            self.args.get("lr_scheduler"),
            self.args.get("lr_scheduler_params"),
            step_per_batch=self.scheduler_step_per_batch)

    def _make_step(self):
        return SupervisedStep.from_modules(
            self.models["model"], self.device, self.compute_dtype,
            self.loss_name, self.optimizer)

    def _broadcast_state(self):
        """Under a group: every model's parameters and buffers (and BYOL's
        teachers) from rank 0, so the ranks hold the same weights."""
        if self.world is None:
            return
        modules = [self.models[k] for k in self.MODEL_KEYS] + list(
            getattr(self.step, "teachers", {}).values())
        for m in modules:
            for t in list(m.parameters()) + list(m.buffers()):
                broadcast_(t, self.world)

    def _shard_models(self):
        """Under a model group: each model's sharded leaves cut to this
        rank's column shard (`parallel/tp.py::shard_module`)."""
        if self.model_group is None:
            return
        for key in self.MODEL_KEYS:
            tp.shard_module(self.models[key], self.grid.k,
                            self.grid.graph_index)

    def _snapshot_model_source(self):
        """Copy each model class's source into the run dir (reference
        trainer.py:264-270); rank 0 only."""
        if self.rank != 0:
            return
        for key in self.MODEL_KEYS:
            cls = type(self.models[key])
            try:
                source = inspect.getsource(cls)
                file_name = os.path.basename(inspect.getfile(cls))
            except (OSError, TypeError):
                continue
            with open(os.path.join(self.run_dir, file_name), "w") as f:
                f.write(source)

    def run_tensorboard_functions(self, preds, targets, step: int,
                                  data_split: str):
        for fn in self.tensorboard_functions.values():
            fn(preds, targets, self.logger, step, data_split)

    # ------------------------------------------------------------ host time
    def _timed(self, name: str) -> span:
        """The span ``loop.<name>``, feeding ``timing[name]``."""
        return span("loop." + name, self.timing, name)

    def _timed_iter(self, loader):
        """`loader`'s batches, each wait counted as loader time."""
        it = iter(loader)
        while True:
            with self._timed("loader"):
                try:
                    batch = next(it)
                except StopIteration:
                    return
            yield batch

    # ------------------------------------------------------------- the steps
    def _prepare(self, batch):
        """Host arrays -> the step's prepared batches on the device."""
        with self._timed("to_device"):
            g = to_device(batch["graph"], self.device)
            return (self.step.prepare(g),)

    def _sync(self):
        """Wait for the device (counted as `device_wait`) before reading
        results on the host."""
        if self.device.type == "cuda":
            with self._timed("device_wait"):
                torch.cuda.synchronize(self.device)

    def _write_lrs(self):
        for group, lr in zip(self.optimizer.param_groups,
                             self.lr_controllers["main"].lrs):
            group["lr"] = lr

    def _groups(self):
        """The context of a step: the data-parallel group, or the grid's
        groups."""
        grid = self.grid
        if grid is None:
            return using_groups(data=self.group)
        if grid.mode == "model":
            return using_groups(data=grid.data, model=grid.graph)
        part = {grid.mode: grid.graph}
        return using_groups(data=grid.data, edge=part.get("edge"),
                            node=part.get("node"), step=grid.step)

    def _train_step(self, batches, **kw):
        """One optimizer step (`kw` to the step's loss); returns (loss,
        outputs), both detached."""
        if self.DRAWS_MASKS:
            kw["noise"] = masks_source(self.generator)
        with self._groups():
            loss, out = self.step.loss_and_grads(*batches,
                                                 return_outputs=True, **kw)
        with span("step.optimizer"):
            self.step.optimizer.step()
        return loss, out

    @contextmanager
    def _evaluating(self):
        """Eval mode (running statistics), no autograd."""
        for key in self.MODEL_KEYS:
            self.models[key].eval()
        try:
            with torch.no_grad():
                yield
        finally:
            for key in self.MODEL_KEYS:
                self.models[key].train()

    def _eval_step(self, batches, **kw):
        """Loss and outputs in eval mode (under a group the loss is the
        global batch's on every rank)."""
        with self._evaluating(), self._groups():
            return self.step.loss(*batches, **kw)

    def _rows(self, batch, out):
        """The predictions and targets the metrics read (`_host_filter`),
        under a group gathered over the ranks (the global batch's)."""
        preds, targets = self._host_filter(batch, out)
        if self.group is None:
            return preds, targets
        return (gather_host(preds, self.group),
                gather_host(targets, self.group, self.TARGET_BLOCKS))

    def _host_filter(self, batch, out):
        """Real graphs' predictions and targets as host arrays."""
        mask = batch["graph"]["graph_mask"]
        preds = out.float().cpu().numpy()
        return preds[mask], batch["graph"]["targets"][mask]

    def _extra_losses(self, out) -> Dict[str, float]:
        """The loss's parts logged beside it (the JAX `AuxOut.
        extra_losses`); none here."""
        return {}

    def _logged_lrs(self) -> Dict[str, float]:
        """The learning rates logged with the training metrics."""
        return {f"lr_param_group_{gi}": lr for gi, lr in
                enumerate(self.lr_controllers["main"].lrs)}

    def _eval_metrics(self, preds, targets, val=False) -> Dict[str, float]:
        res = {
            "mean_pred": float(np.mean(preds)),
            "std_pred": float(np.std(preds, ddof=1)) if preds.size > 1
            else 0.0,
            "mean_targets": float(np.nanmean(targets)),
            "std_targets": float(np.nanstd(targets, ddof=1))
            if targets.size > 1 else 0.0,
        }
        for key, metric in self.metrics.items():
            if getattr(metric, "val_only", False) and not val:
                continue
            try:
                res[key] = float(metric(preds, targets))
            except Exception:
                res[key] = float("nan")
        return res

    # ---------------------------------------------------------------- epochs
    def train_epoch(self, loader, epoch: int) -> None:
        log_iterations = self.args.get("log_iterations", 20)
        cuda = self.device.type == "cuda"
        for batch in self._timed_iter(loader):
            batches = self._prepare(batch)
            self._write_lrs()
            with self._timed("step"):
                if cuda:
                    start = torch.cuda.Event(enable_timing=True)
                    end = torch.cuda.Event(enable_timing=True)
                    start.record()
                loss, out = self._train_step(batches)
                if cuda:
                    end.record()
                    self._events.append((start, end))
            self.optim_steps += 1
            self._after_optim_step()
            if self.optim_steps % log_iterations == 0:
                self._sync()
                with self._timed("metrics"):
                    preds, targets = self._rows(batch, out)
                    m = self._eval_metrics(preds, targets)
                    m[self.loss_name] = float(loss)
                    m.update(self._extra_losses(out))
                    m.update(self._logged_lrs())
                with self._timed("logging"):
                    self.logger.log(m, "train", self.optim_steps, epoch)
                    self.run_tensorboard_functions(preds, targets,
                                                   self.optim_steps, "train")
        if self._events:
            torch.cuda.synchronize(self.device)
            self.timing["step_ms"] += [s.elapsed_time(e)
                                       for s, e in self._events]
            self._events = []

    def _after_optim_step(self):
        for c in self.lr_controllers.values():
            c.after_optim_step()

    def evaluate_epoch(self, loader, epoch: int = 0) -> Dict[str, float]:
        """Validation pass: per-batch averaged metrics when `val_per_batch`
        (contrastive probes), else whole-epoch metrics on the concatenated
        predictions (OGB evaluators)."""
        val_per_batch = self.args.get("val_per_batch", True)
        if len(loader) == 0:
            raise ValueError(
                "evaluation loader yields no batches — the split is smaller "
                "than the batch size (contrastive loaders drop partial "
                "batches; shrink batch_size or grow the split)")
        totals: Dict[str, float] = {}
        n_batches = 0
        all_preds, all_targets = [], []
        epoch_loss = 0.0
        for batch in self._timed_iter(loader):
            batches = self._prepare(batch)
            with self._timed("step"):
                loss, out = self._eval_step(batches)
            self._sync()
            n_batches += 1
            with self._timed("metrics"):
                epoch_loss += float(loss)
                preds, targets = self._rows(batch, out)
            if n_batches == 1:  # reference: figure hooks on the first batch
                with self._timed("logging"):
                    self.run_tensorboard_functions(preds, targets,
                                                   self.optim_steps, "val")
            if val_per_batch:
                with self._timed("metrics"):
                    m = self._eval_metrics(preds, targets, val=True)
                    m[self.loss_name] = float(loss)
                    m.update(self._extra_losses(out))
                    for k, v in m.items():
                        totals[k] = totals.get(k, 0.0) + v
            else:
                all_preds.append(preds)
                all_targets.append(targets)
        if val_per_batch:
            return {k: v / max(n_batches, 1) for k, v in totals.items()}
        with self._timed("metrics"):
            m = self._eval_metrics(np.concatenate(all_preds, axis=0),
                                   np.concatenate(all_targets, axis=0),
                                   val=True)
            m[self.loss_name] = epoch_loss / max(n_batches, 1)
        return m

    def train(self, train_loader, val_loader) -> Dict[str, float]:
        """Full fit loop with early stopping — reference Trainer.train."""
        if self.step is None:
            # the JAX package draws an example batch here, which advances
            # the train loader's shuffle; drawing it too keeps the batches
            self.init_state(next(iter(train_loader)))
        if self.start_epoch > 1 and hasattr(train_loader, "skip_epochs"):
            # a resumed run continues the shuffle where the run left it
            train_loader.skip_epochs(self.start_epoch - 1)
        patience = self.args.get("patience", 20)
        minimum_epochs = self.args.get("minimum_epochs", 0)
        num_epochs = self.args.get("num_epochs", 10)
        models_to_save = self.args.get("models_to_save", []) or []
        epochs_no_improve = 0
        eval_per_epochs = self.args.get("eval_per_epochs", 0)
        for epoch in range(self.start_epoch, num_epochs + 1):
            t0 = time.perf_counter()
            self.train_epoch(train_loader, epoch)
            t1 = time.perf_counter()
            metrics = self.evaluate_epoch(val_loader, epoch)
            self.timing["train_epoch_s"].append(t1 - t0)
            self.timing["eval_s"].append(time.perf_counter() - t1)
            if eval_per_epochs > 0 and epoch % eval_per_epochs == 0:
                self.run_per_epoch_evaluations(val_loader, epoch)
            val_score = metrics.get(self.main_metric, float("nan"))
            for c in self.lr_controllers.values():
                c.after_epoch(val_score)
            with self._timed("logging"):
                self.logger.log(metrics, "val", self.optim_steps, epoch)
            val_loss = metrics.get(self.loss_name, float("nan"))
            if self.rank == 0:
                print(f"[Epoch {epoch}] {self.main_metric}: "
                      f"{val_score:.6f} val loss: {val_loss:.6f}")
            improved = (val_score >= self.best_val_score
                        if self.main_metric_goal == "max"
                        else val_score <= self.best_val_score)
            if improved:
                epochs_no_improve = 0
                self.best_val_score = val_score
                self.save_checkpoint(epoch, "best_checkpoint.pt")
            else:
                epochs_no_improve += 1
            self.save_checkpoint(epoch, "last_checkpoint.pt")
            if epochs_no_improve >= patience and epoch >= minimum_epochs:
                if self.rank == 0:
                    print(f"Early stopping after {epoch} epochs; best epoch "
                          f"was {epoch - epochs_no_improve}.")
                break
            if epoch in models_to_save and self.rank == 0:
                shutil.copyfile(os.path.join(self.run_dir,
                                             "best_checkpoint.pt"),
                                os.path.join(self.run_dir,
                                             f"best_checkpoint_{epoch}"
                                             f"epochs.pt"))
        # reload best and evaluate (reference trainer.py:106-109); under a
        # group rank 0 reads it and the others take its weights
        best = os.path.join(self.run_dir, "best_checkpoint.pt")
        found = [os.path.exists(best) if self.rank == 0 else None]
        if self.world is not None:
            dist.broadcast_object_list(
                found, src=dist.get_global_rank(self.world, 0),
                group=self.world)
        if found[0] and self.model_group is not None:
            # each rank cuts its own shards from rank 0's whole tensors
            payload = [checkpoint.load_checkpoint(best) if self.rank == 0
                       else None]
            dist.broadcast_object_list(
                payload, src=dist.get_global_rank(self.world, 0),
                group=self.world)
            self._load_payload(payload[0], restore_host=False)
        elif found[0]:
            if self.rank == 0:
                self._load(best, restore_host=False)
            self._broadcast_state()
        return self.evaluation(val_loader, "val_best_checkpoint")

    def run_per_epoch_evaluations(self, loader, epoch: int):
        """Hook for expensive periodic evaluations (reference
        run_per_epoch_evaluations, trainer.py:66-67)."""

    def evaluation(self, loader, data_split: str = "") -> Dict[str, float]:
        metrics = self.evaluate_epoch(loader)
        if self.rank != 0:
            return metrics
        with open(os.path.join(self.run_dir,
                               f"evaluation_{data_split}.txt"), "w") as f:
            for k, v in metrics.items():
                f.write(f"{k}: {v}\n")
        return metrics

    def write_timing(self) -> Dict[str, Any]:
        """`timing` into the run dir (`timing.json`): host seconds per
        part of the loop and the device ms of each train step (CUDA); rank
        0 only."""
        if self.rank != 0:
            return self.timing
        with open(os.path.join(self.run_dir, "timing.json"), "w") as f:
            json.dump(self.timing, f)
        return self.timing

    # ----------------------------------------------------------- checkpoints
    def save_checkpoint(self, epoch: int, name: str):
        """Rank 0 writes `name`; under a model group the ranks of data
        shard 0 gather their shards first (whole tensors, models and
        optimizer state alike)."""
        if self.rank != 0 and (self.model_group is None
                               or self.grid.data_index != 0):
            return
        with self._timed("checkpoint"):
            payload = self._model_state_dicts()
            optimizer = tp.full_optimizer_state(self.optimizer,
                                                self.model_group)
            if self.rank != 0:
                return
            payload.update(
                optimizer_state_dict=optimizer,
                scheduler_state_dict={k: c.state_dict() for k, c in
                                      self.lr_controllers.items()},
                epoch=epoch, best_val_score=self.best_val_score,
                optim_steps=self.optim_steps)
            checkpoint.save_checkpoint(os.path.join(self.run_dir, name),
                                       payload)
            with open(os.path.join(self.run_dir, "train_arguments.yaml"),
                      "w") as f:
                yaml_lite.dump(yamlable(self.args), f)

    def _model_state_dicts(self) -> Dict[str, Any]:
        """The checkpoint's model entries (`checkpoint.state_dicts`)."""
        return checkpoint.state_dicts({k: self.models[k]
                                       for k in self.MODEL_KEYS},
                                      self.model_group)

    def _load_model_state_dicts(self, payload: Mapping[str, Any]) -> None:
        checkpoint.load_state_dicts({k: self.models[k]
                                     for k in self.MODEL_KEYS}, payload)

    def _load(self, path: str, restore_host: bool = True):
        with self._timed("checkpoint"):
            payload = checkpoint.load_checkpoint(path, self.device)
        self._load_payload(payload, restore_host)

    def _load_payload(self, payload: Mapping[str, Any],
                      restore_host: bool = True):
        with self._timed("checkpoint"):
            self._load_model_state_dicts(payload)
            self.optimizer.load_state_dict(tp.shard_optimizer_state(
                self.optimizer, payload["optimizer_state_dict"]))
        if restore_host:
            self.start_epoch = payload.get("epoch", 0) + 1
            self.best_val_score = payload.get("best_val_score",
                                              self.best_val_score)
            self.optim_steps = payload.get("optim_steps", 0)
            for k, sd in (payload.get("scheduler_state_dict") or {}).items():
                if k in self.lr_controllers and sd is not None:
                    self.lr_controllers[k].load_state_dict(sd)


def yamlable(obj):
    """`obj` with numpy scalars as Python ones and unknown objects as their
    `str` (the JAX package's `_yamlable`)."""
    if isinstance(obj, dict):
        return {k: yamlable(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [yamlable(v) for v in obj]
    if isinstance(obj, (np.floating, np.integer)):
        return obj.item()
    if isinstance(obj, (str, int, float, bool)) or obj is None:
        return obj
    return str(obj)


class SelfSupervisedTrainer(Trainer):
    """2D-vs-3D contrastive (reference trainer/self_supervised_trainer.py):
    `PretrainStep` over ``model`` and ``model3d``, `loss_func` between
    their outputs.  The 3D view is the dense batch of Net3DDense or the
    CSR complete-graph batch of the flat Net3D (B * C graphs under
    `conformer_collate`); `to_device` tells them apart, the step's
    `prepare` casts either, and the metrics read a [B * C, D] 3D side as
    the JAX package's do."""

    MODEL_KEYS = ("model", "model3d")

    def _make_step(self):
        return PretrainStep.from_modules(
            self.models["model"], self.models["model3d"], self.device,
            self.compute_dtype, self.loss_func, self.optimizer)

    def _prepare(self, batch):
        with self._timed("to_device"):
            return self.step.prepare(to_device(batch["graph2d"], self.device),
                                     to_device(batch["graph3d"], self.device))

    def _host_filter(self, batch, out):
        z1, z2 = out
        return z1.float().cpu().numpy(), z2.float().cpu().numpy()

    def run_per_epoch_evaluations(self, loader, epoch: int):
        """Linear probe: least-squares fit of targets from 2D embeddings
        (reference self_supervised_trainer.py:52-76)."""
        n_samples = self.args.get("linear_probing_samples", 500)
        reps, targets = [], []
        for batch in loader:
            z = self._eval_step(self._prepare(batch))[1][0].float().cpu(
            ).numpy()
            t = batch["graph2d"].get("targets")
            if t is None:
                return
            t = np.asarray(t)[: z.shape[0]]
            if self.group is not None:
                z, t = gather_host(z, self.group), gather_host(t, self.group)
            reps.append(z)
            targets.append(t)
            if sum(r.shape[0] for r in reps) >= n_samples:
                break
        X = np.concatenate(reps, axis=0)
        y = np.concatenate(targets, axis=0)
        if X.shape[0] < X.shape[1]:
            raise ValueError(
                f"linear_probing_samples {X.shape[0]} < metric dim "
                f"{X.shape[1]}; linear probing cannot be used.")
        sol, *_ = np.linalg.lstsq(X, y, rcond=None)
        mae = float(np.abs(X @ sol - y).mean())
        self.logger.log({"linear_probe_mae": mae}, "val", self.optim_steps,
                        epoch)


class SelfSupervisedAETrainer(SelfSupervisedTrainer):
    """Contrastive + distance reconstruction (reference
    self_supervised_ae_trainer.py:14-30): ``model3d`` (`Net3DAE`) returns
    (embedding, distances); the loss (`NTXentAE`) is contrastive +
    reconstruction, both parts logged beside it (`AEStep`)."""

    def _make_step(self):
        return AEStep.from_modules(
            self.models["model"], self.models["model3d"], self.device,
            self.compute_dtype, self.loss_func, self.optimizer)

    def _host_filter(self, batch, out):
        return super()._host_filter(batch, out[:2])

    def _extra_losses(self, out) -> Dict[str, float]:
        return {k: float(v) for k, v in out[2].items()}


class SelfSupervisedAlternatingTrainer(SelfSupervisedTrainer):
    """Gradients alternate sides each optimizer step (reference
    self_supervised_alternating_trainer.py:10-22, `AlternatingStep`): the
    parity is the optimizer's step count (`optim_steps`, the JAX
    ``state.step``), in training and in evaluation."""

    def _make_step(self):
        return AlternatingStep.from_modules(
            self.models["model"], self.models["model3d"], self.device,
            self.compute_dtype, self.loss_func, self.optimizer)

    def _train_step(self, batches, **kw):
        return super()._train_step(batches, even=self.optim_steps % 2 == 0,
                                   **kw)

    def _eval_step(self, batches, **kw):
        return super()._eval_step(batches, even=self.optim_steps % 2 == 0,
                                  **kw)


class NoisyNegativesTrainer(SelfSupervisedTrainer):
    """The 3D model also embeds the batch's noised 3D copy (reference
    noisy_negatives_trainer.py, `NoisyNegativesStep`), appended to the 3D
    side for the loss (`NTXentExtraNegatives`).  One copy only: with
    `num_noised` > 1 the collate gives a list, which the JAX trainer's
    3D model cannot read either."""

    TARGET_BLOCKS = NoisyNegativesStep.Z2_BLOCKS

    def _make_step(self):
        return NoisyNegativesStep.from_modules(
            self.models["model"], self.models["model3d"], self.device,
            self.compute_dtype, self.loss_func, self.optimizer)

    def _prepare(self, batch):
        noisy = batch["noisy3d"]
        if isinstance(noisy, (list, tuple)):
            raise TypeError(
                "noisy_negatives reads one noised copy of the 3D view "
                f"(num_noised 1); the batch holds {len(noisy)}")
        with self._timed("to_device"):
            return self.step.prepare(to_device(batch["graph2d"], self.device),
                                     to_device(batch["graph3d"], self.device),
                                     to_device(noisy, self.device))


class PhilosophyTrainer(SelfSupervisedTrainer):
    """Three-player adversarial training (reference philosophy_trainer.py,
    the JAX `PhilosophyTrainer`, `PhilosophyStep`): ``model``, ``model3d``
    and ``critic``, each with its own grouped optimizer (the config's
    optimizer and parameters; no transfer groups) and lr controller.  The
    peasant loss is the logged loss, beside ``philosopher_loss`` and the
    critic loss under its class name.  A checkpoint carries the critic
    (``critic_state_dict``) and the three optimizers' states."""

    MODEL_KEYS = ("model", "model3d", "critic")
    NO_DATA_PARALLEL = (
        "n_shards > 1: the philosophy trainer has no data-parallel step "
        "(the JAX PhilosophyTrainer's _make_train_step, train/trainer.py:"
        "971, jits its three gradients without the mesh and fails on the "
        "stacked shard batch)")

    def __init__(self, *a, critic_loss=None, **kw):
        super().__init__(*a, **kw)
        self.critic_loss_func = critic_loss

    def _build_optimizer(self):
        op = dict(self.args.get("optimizer_params", {}) or {})
        op["betas"] = tuple(op.get("betas", (0.9, 0.999)))
        optimizers = {}
        for key in self.MODEL_KEYS:
            paths = {f"{key}.{n}": f"{key}/{p}"
                     for n, p in flax_paths(self.models[key]).items()}
            labels, self.active_groups[key] = label_params(paths)
            optimizers[key] = build_optimizer(
                ((f"{key}.{n}", p)
                 for n, p in self.models[key].named_parameters()),
                labels, self.args.get("optimizer", "Adam"), **op)
            self.lr_controllers[key] = LRController(
                [g["lr"] for g in optimizers[key].param_groups],
                self.args.get("lr_scheduler"),
                self.args.get("lr_scheduler_params"),
                step_per_batch=self.scheduler_step_per_batch)
        self.optimizer = OptimizerSet(optimizers)

    def _write_lrs(self):
        for key, opt in self.optimizer.optimizers.items():
            for group, lr in zip(opt.param_groups,
                                 self.lr_controllers[key].lrs):
                group["lr"] = lr

    def _logged_lrs(self) -> Dict[str, float]:
        return {}

    def _make_step(self):
        return PhilosophyStep.from_modules(
            self.models["model"], self.models["model3d"],
            self.models["critic"], self.device, self.compute_dtype,
            self.loss_func, self.critic_loss_func, self.optimizer)

    def _host_filter(self, batch, out):
        return super()._host_filter(batch, out[:2])

    def _extra_losses(self, out) -> Dict[str, float]:
        return {k: float(v) for k, v in out[2].items()}


class BYOLTrainer(SelfSupervisedTrainer):
    """BYOL (reference byol_trainer.py, the JAX package's `BYOLTrainer`):
    ``model`` and ``model3d`` are `BYOLWrapper`s, each step a `BYOLStep`
    (each wrapper's teacher in train mode without autograd, the loss
    ``L(pred2_s, proj3_t) + L(proj2_t, pred3_s)``, then the EMA of the
    2D teacher, or of both with `ema_all`, at `ma_decay`).  The metrics
    and the linear probe read the students' predictions.  A checkpoint
    carries each teacher, running statistics included, under ``teacher.``
    in its model's state_dict (the reference wrapper's layout), so a
    resumed run and the reload of the best checkpoint restore them."""

    TEACHER = "teacher."
    DRAWS_MASKS = False

    def __init__(self, *a, ma_decay: float = 0.99, ema_all: bool = False,
                 **kw):
        super().__init__(*a, **kw)
        self.ma_decay, self.ema_all = ma_decay, ema_all

    def _make_step(self):
        return BYOLStep.from_modules(
            self.models["model"], self.models["model3d"], self.device,
            self.compute_dtype, self.loss_func, self.optimizer,
            ma_decay=self.ma_decay, ema_all=self.ema_all)

    def _train_step(self, batches):
        out = super()._train_step(batches)
        self.step.update_teachers()
        return out

    def _model_state_dicts(self) -> Dict[str, Any]:
        payload = super()._model_state_dicts()
        for k, teacher in self.step.teachers.items():
            payload[checkpoint.STATE_DICT_KEYS[k]].update(
                {self.TEACHER + n: t.detach().cpu() for n, t in
                 tp.full_state_dict(teacher, self.model_group).items()})
        return payload

    def _load_model_state_dicts(self, payload: Mapping[str, Any]) -> None:
        own = dict(payload)
        for k, teacher in self.step.teachers.items():
            key = checkpoint.STATE_DICT_KEYS[k]
            n = len(self.TEACHER)
            teacher.load_state_dict(tp.shard_state_dict(teacher, {
                name[n:]: t for name, t in payload[key].items()
                if name.startswith(self.TEACHER)}), strict=True)
            own[key] = {name: t for name, t in payload[key].items()
                        if not name.startswith(self.TEACHER)}
        super()._load_model_state_dicts(own)


class GraphCLTrainer(Trainer):
    """The same model on two augmented 2D views (reference
    graphcl_trainer.py:11-15, `GraphCLStep`); the metrics read the two
    outputs."""

    DRAWS_MASKS = False

    def _make_step(self):
        return GraphCLStep.from_modules(self.models["model"], self.device,
                                        self.compute_dtype, self.loss_func,
                                        self.optimizer)

    def _prepare(self, batch):
        with self._timed("to_device"):
            return self.step.prepare(to_device(batch["view1"], self.device),
                                     to_device(batch["view2"], self.device))

    _host_filter = SelfSupervisedTrainer._host_filter


class DistancePredictorTrainer(Trainer):
    """Pre-training baseline: every pairwise 3D distance predicted from the
    2D graph (reference DistancePredictor path, `DistanceStep`); the batch
    is the graph and its pair view with the true distances, and the
    metrics read the real pairs."""

    def _make_step(self):
        return DistanceStep.from_modules(self.models["model"], self.device,
                                         self.compute_dtype, self.loss_name,
                                         self.optimizer)

    def _prepare(self, batch):
        with self._timed("to_device"):
            g = to_device(batch["graph"], self.device)
            pairs = g if batch["pairs"] is batch["graph"] else \
                to_device(batch["pairs"], self.device)
            return self.step.prepare(g, pairs)

    def _host_filter(self, batch, out):
        mask = batch["pairs"]["edge_mask"]
        return (out.float().cpu().numpy()[mask],
                batch["pairs"]["edge_dist"][:, None][mask])


class OptimalTransportTrainer(Trainer):
    """GeoMol conformer-generation training (reference trainer/
    optimal_transport_trainer.py:11-67, the JAX package's
    `OptimalTransportTrainer`): the loss is the model's own, each batch
    one `OTStep` (cost pass in eval mode, host EMD plans, gradient pass,
    clip 10, the grouped Adam at the trainer's per-group lrs), the cost
    without its dihedral and three-hop terms (`ignore_neighbors`) in the
    epochs before `num_epochs_local_only` (default 1: none).  float32
    whatever `bf16_compute` says, as the JAX trainer (`supports_bf16 =
    False`).  Validation is the mean over batches of the eval-mode loss,
    each batch with its own plans.  The random draws come from one
    `torch.Generator` on the trainer's device seeded with `seed`; each
    batch's cost and gradient passes share its noise.  `timing` adds the
    host seconds of the EMDs (`host_emd`, a part of `step`: the step's
    ``step.emd`` spans feed it)."""

    NO_DATA_PARALLEL = (
        "n_shards > 1: the optimal-transport trainer has no data-parallel "
        "step (the JAX OptimalTransportTrainer's _make_train_step, train/"
        "trainer.py:1144, jits its step without the mesh; the JAX loader "
        "cannot stack its shards' ot_collate arrays)")

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self.compute_dtype = None
        self._epoch = 1
        self.timing["host_emd"] = 0.0

    @property
    def _ignore_neighbors(self) -> bool:
        return self._epoch < self.args.get("num_epochs_local_only", 1)

    def _make_step(self):
        step = OTStep.from_modules(self.models["model"], self.device,
                                   self.optimizer)
        step.timing = self.timing
        return step

    def _prepare(self, batch):
        with self._timed("to_device"):
            return to_ot_batch(batch["graph"], None, self.device)

    def train_epoch(self, loader, epoch: int) -> None:
        self._epoch = epoch
        self.step.ignore_neighbors = self._ignore_neighbors
        log_iterations = self.args.get("log_iterations", 20)
        cuda = self.device.type == "cuda"
        for batch in self._timed_iter(loader):
            ob = self._prepare(batch)
            self._write_lrs()
            with self._timed("step"):
                if cuda:
                    start = torch.cuda.Event(enable_timing=True)
                    end = torch.cuda.Event(enable_timing=True)
                    start.record()
                with self._groups():
                    loss = self.step.step(ob, self.generator)
                if cuda:
                    end.record()
                    self._events.append((start, end))
            self.optim_steps += 1
            self._after_optim_step()
            if self.optim_steps % log_iterations == 0:
                self._sync()
                with self._timed("logging"):
                    self.logger.log({self.loss_name: float(loss)}, "train",
                                    self.optim_steps, epoch)
        if self._events:
            torch.cuda.synchronize(self.device)
            self.timing["step_ms"] += [s.elapsed_time(e)
                                       for s, e in self._events]
            self._events = []

    def evaluate_epoch(self, loader, epoch: int = 0) -> Dict[str, float]:
        total, n = 0.0, 0
        for batch in self._timed_iter(loader):
            ob = self._prepare(batch)
            with self._timed("step"), self._groups():
                loss = self.step.eval_loss(ob, self.generator)
            self._sync()
            with self._timed("metrics"):
                total += float(loss)
            n += 1
        return {self.loss_name: total / max(n, 1)}


TRAINER_REGISTRY = {"default": Trainer, "contrastive": SelfSupervisedTrainer,
                    "alternating": SelfSupervisedAlternatingTrainer,
                    "autoencoder": SelfSupervisedAETrainer,
                    "noisy_negatives": NoisyNegativesTrainer,
                    "byol": BYOLTrainer,
                    "philosophy": PhilosophyTrainer,
                    "graphcl_trainer": GraphCLTrainer,
                    "distance_predictor": DistancePredictorTrainer,
                    "optimal_transport": OptimalTransportTrainer}


def get_trainer_class(name: str):
    if name not in TRAINER_REGISTRY:
        raise KeyError(f"unknown trainer '{name}'")
    return TRAINER_REGISTRY[name]
