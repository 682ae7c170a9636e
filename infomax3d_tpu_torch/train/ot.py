"""The optimal-transport pre-training step (port of the JAX package's
`OptimalTransportTrainer` step, infomax3d_tpu/train/trainer.py: `exact_emd`,
`_attach_ot_plans`, `_cost_fn`, `loss_fn` and the jitted update) for
`OptimalTransportModel` with any of its backbones, e.g. at the architecture
of `configs_clean/pre-train_Optimal_Transport_baseline.yml`: hidden 50, 3
layers, sum aggregation, 10 model and 10 true conformers, loss `ot_emd`,
Adam lr 1e-3, gradient-norm clip 10, batches of 16.  float32 throughout:
the JAX trainer does not support bf16 for this model.

One step with loss `ot_emd`:
1. a cost pass without gradient, in eval mode as the JAX trainer's
   ``deterministic=True`` pass: BatchNorms normalize with their running
   statistics and do not update them, no dropout; the masked [T, C, G]
   cost;
2. the host's exact EMD plan per molecule on the detached cost, between
   uniform marginals over the molecule's true conformers and the model's
   conformers, after shifting the cost by its largest magnitude;
3. the gradient pass on ``sum(plan * cost)`` in training mode, with the
   same noise as the cost pass (the JAX trainer hands both passes the same
   key) and dropout masks of its own;
4. the global gradient norm clipped at 10;
5. grouped Adam (`train/optim.py`) at the lrs the caller wrote into its
   param groups.
With `implicit_mle` the gradient pass alone runs.  `ignore_neighbors`
(set by the trainer for its first `num_epochs_local_only` epochs) drops
the dihedral and three-hop terms from both passes' cost.  The random draws
of a step come from one `torch.Generator` on the step's device, so the
card draws its own noise.  `eval_loss` is the validation step: plans from
an eval-mode cost pass, then the loss in eval mode with the same noise.

Every pass calls the model through `train/precision.py::call_model`, so
a tensor-parallel model (`parallel/tp.py`) runs on its gathered
parameters; its clip then reads the norm of the whole gradient (the
shards' squares summed over the model ranks).

`ot()` runs a few steps on one fixed synthetic batch with true conformers,
on the CUDA card unless asked for the CPU; the epoch loop, the learning-
rate schedule, validation and checkpoints are `OptimalTransportTrainer`'s
(`train/trainer.py`).
"""
from __future__ import annotations

from typing import Any, Dict, Mapping, Optional, Tuple

import numpy as np
import torch

from infomax3d_tpu_torch.data.loader import OTBatch, ot_collate, to_ot_batch
from infomax3d_tpu_torch.data.synthetic import SyntheticMolecules
from infomax3d_tpu_torch.device import resolve_device
from infomax3d_tpu_torch.graphs.batch import bucket_for
from infomax3d_tpu_torch.interop import init_jax_variables, load_variables
from infomax3d_tpu_torch.models.optimal_transport import OptimalTransportModel
from infomax3d_tpu_torch.models.noise import GeneratorNoise, ReplayNoise
from infomax3d_tpu_torch.parallel import tp
from infomax3d_tpu_torch.parallel.context import model_group
from infomax3d_tpu_torch.train.optim import build_adam
from infomax3d_tpu_torch.train.precision import call_model
from infomax3d_tpu_torch.train.remat import rematerialized, using_remat
from infomax3d_tpu_torch.train.supervised import TrainStep
from infomax3d_tpu_torch.utils.spans import span

GRAD_CLIP = 10.0


def exact_emd(cost: np.ndarray, a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """The exact optimal-transport plan between histograms `a` and `b` for
    the [len(a), len(b)] `cost` (the reference uses POT's `ot.emd`; here
    scipy's HiGHS linear program, as the JAX package does; molecules have
    at most 10 x 10 plans)."""
    from scipy.optimize import linprog
    nt, nm = cost.shape
    A_eq = np.zeros((nt + nm, nt * nm))
    for i in range(nt):
        A_eq[i, i * nm:(i + 1) * nm] = 1.0
    for j in range(nm):
        A_eq[nt + j, j::nm] = 1.0
    b_eq = np.concatenate([a, b])
    res = linprog(cost.reshape(-1), A_eq=A_eq[:-1], b_eq=b_eq[:-1],
                  bounds=(0, None), method="highs")
    if res.status != 0:
        raise RuntimeError(f"exact_emd: the linear program failed: "
                           f"{res.message}")
    return res.x.reshape(nt, nm)


def ot_plans(cost: np.ndarray, pos_mask: np.ndarray,
             graph_mask: np.ndarray) -> np.ndarray:
    """float32 [G, T, C] plans from the detached [T, C, G] cost: for each
    real graph with nt > 0 true conformers, `exact_emd` of its first nt
    rows shifted by their largest magnitude, between uniform marginals;
    zero elsewhere (the JAX trainer's `_attach_ot_plans`)."""
    T, C, G = cost.shape
    plans = np.zeros((G, T, C), np.float32)
    for i in range(G):
        nt = int(pos_mask[i].sum())
        if not graph_mask[i] or nt == 0:
            continue
        M = cost[:nt, :, i]
        M = np.max(np.abs(M)) + M
        plans[i, :nt] = exact_emd(M, np.ones(nt) / nt, np.ones(C) / C)
    return plans


class OTStep:
    """Cost pass, host plans, gradient pass, clip and Adam update of the OT
    model on one batch.  `variables` holds the model's flax numpy trees
    (`interop.init_jax_variables` layout); `from_modules` takes a built
    model and optimizer (the trainer's).  `ignore_neighbors` applies to
    every pass until changed.  `timing["host_emd"]` accumulates the host
    seconds of the EMDs (the ``step.emd`` spans; the OT trainer hands the
    step its own `timing`)."""

    ignore_neighbors = False
    remat = False

    def __init__(self, model_parameters: Mapping, variables: Mapping,
                 device: torch.device,
                 optimizer_params: Optional[Mapping] = None):
        self.device = torch.device(device)
        self.model = load_variables(
            OptimalTransportModel.from_config(model_parameters), variables)
        self.model.to(self.device).train()
        self.optimizer = build_adam(self.model.named_parameters(),
                                    **dict(optimizer_params or {}))
        self.timing = {"host_emd": 0.0}

    @classmethod
    def from_modules(cls, model: torch.nn.Module, device: torch.device,
                     optimizer: torch.optim.Optimizer) -> "OTStep":
        step = cls.__new__(cls)
        step.device, step.model, step.optimizer = (torch.device(device),
                                                   model, optimizer)
        step.timing = {"host_emd": 0.0}
        return step

    def cost(self, batch: OTBatch, noise) -> torch.Tensor:
        """The masked [T, C, G] cost, without gradient, in eval mode; the
        model's mode is restored after."""
        was_training = self.model.training
        self.model.eval()
        try:
            with torch.no_grad():
                return call_model(self.model, None, batch, noise,
                                  ignore_neighbors=self.ignore_neighbors,
                                  return_cost_matrix=True)
        finally:
            self.model.train(was_training)

    def plans(self, cost: torch.Tensor, batch: OTBatch) -> torch.Tensor:
        """`ot_plans` of the cost on the host, back on the step's device;
        the host seconds of the EMDs accumulate in `timing["host_emd"]`."""
        g = batch.graph
        arrays = (cost.cpu().numpy(), batch.ex["pos_mask"].cpu().numpy(),
                  g.graph_mask.cpu().numpy())
        with span("step.emd", self.timing, "host_emd"):
            plans = ot_plans(*arrays)
        return torch.from_numpy(plans).to(self.device)

    def loss_and_grads(self, batch: OTBatch, noise,
                       plans: Optional[torch.Tensor] = None) -> torch.Tensor:
        """The gradient pass: fills each parameter's `.grad`, clipped to a
        global norm of `GRAD_CLIP` (``scale = min(1, clip / (norm +
        1e-6))``), and returns the loss (detached).  A parameter the loss
        does not reach gets a zero gradient first
        (`TrainStep.fill_missing_grads`; with `ignore_neighbors` ``gnn2``
        reaches no term of the cost)."""
        self.optimizer.zero_grad(set_to_none=True)
        with span("step.forward"), using_remat(self.remat):
            loss = rematerialized(self._loss_pass, batch, plans, noise=noise)
        with span("step.backward"):
            loss.backward()
            params = list(self.model.parameters())
            grads = TrainStep.fill_missing_grads(params)
            group = model_group()
            if group is None:
                norm = torch.sqrt(sum((g * g).sum() for g in grads))
            else:
                # tensor parallel: the shards' squares summed over the
                # model ranks, the replicated leaves' (model rank 0's) once
                tp.broadcast_replicated_grads(params, group)
                norm = tp.grad_norm(params, group)
            scale = (GRAD_CLIP / (norm + 1e-6)).clamp(max=1.0)
            for g in grads:
                g.mul_(scale)
        return loss.detach()

    def _loss_pass(self, batch: OTBatch, plans, noise) -> torch.Tensor:
        return call_model(self.model, None, batch, noise,
                          ignore_neighbors=self.ignore_neighbors,
                          ot_plans=plans)

    def _passes(self, batch: OTBatch, generator: torch.Generator):
        """(plans or None, the loss pass's noise): with `ot_emd` the cost
        pass's draws replayed, the dropout masks drawn fresh."""
        noise = GeneratorNoise(generator)
        if self.model.loss_type != "ot_emd":
            return None, noise
        plans = self.plans(self.cost(batch, noise), batch)
        return plans, ReplayNoise(noise.draws, fresh=noise)

    def step(self, batch: OTBatch, generator: torch.Generator
             ) -> torch.Tensor:
        """One training step on a batch on the step's device, its random
        draws from `generator` (on the same device); returns the loss."""
        plans, noise = self._passes(batch, generator)
        loss = self.loss_and_grads(batch, noise, plans)
        with span("step.optimizer"):
            self.optimizer.step()
        return loss

    def eval_loss(self, batch: OTBatch, generator: torch.Generator
                  ) -> torch.Tensor:
        """The validation loss of a batch: plans from the cost pass, then
        the loss in eval mode with the same noise, without gradient."""
        plans, noise = self._passes(batch, generator)
        was_training = self.model.training
        self.model.eval()
        try:
            with torch.no_grad():
                return call_model(self.model, None, batch, noise,
                                  ignore_neighbors=self.ignore_neighbors,
                                  ot_plans=plans)
        finally:
            self.model.train(was_training)


def ot_batch(batch_size: int, n_true_confs: int, seed: int = 0,
             n_min: int = 10, n_max: int = 26, device="cpu"
             ) -> Tuple[OTBatch, Dict[str, int]]:
    """`batch_size` synthetic molecules with `n_true_confs` conformers each
    as an OT batch, plus its sizes: graphs, real nodes, real edges,
    neighbourhoods and dihedral pairs.  The defaults are QM9-like: 10 to 26
    atoms, 18 on average."""
    ds = SyntheticMolecules(batch_size, seed=seed, n_min=n_min, n_max=n_max,
                            num_conformers=n_true_confs)
    items = [{"graph2d": m, "conformers3d": [
        {"coords": c} for c in m["conformers"]] if "conformers" in m else None}
        for m in ds.mols]
    b = bucket_for([it["graph2d"] for it in items], batch_size)
    arrays = ot_collate(items, b, n_true_confs=n_true_confs)
    sizes = {"graphs": batch_size,
             "nodes": int(arrays["node_mask"].sum()),
             "edges": int(arrays["edge_mask"].sum()),
             "neighborhoods": int((arrays["nbh_mol"] < batch_size).sum()),
             "pairs": int((arrays["dp_mol"] < batch_size).sum())}
    return to_ot_batch(arrays, b, device), sizes


def build_ot_step(args: Mapping[str, Any], device: torch.device) -> OTStep:
    """`OTStep` from a config-like dict with the YAML keys
    `model_parameters`, `optimizer_params` and `remat`, and seeded numpy
    weights in the flax layout (`seed`, default 0)."""
    mp = args["model_parameters"]
    params, stats = init_jax_variables(mp, args.get("seed", 0),
                                       "OptimalTransportModel")
    step = OTStep(mp, {"params": params, "batch_stats": stats}, device,
                  args.get("optimizer_params"))
    step.remat = bool(args.get("remat", False))
    return step


def ot(args: Dict[str, Any], steps: int = 1,
       device: Optional[str] = None) -> Dict[str, Any]:
    """Run `steps` OT steps on one fixed batch of `args["batch_size"]`
    (default 16) synthetic molecules with the model's `n_true_confs`
    conformers each (`args["dataset_params"]`: seed, n_min, n_max).  Step
    i draws its noise from a generator on the step's device seeded with
    ``args["seed"] + i``.
    Runs on the CUDA card unless `device` says otherwise (and raises when
    there is none).  Returns the float32 losses, the step object, the
    batch and its sizes."""
    device = resolve_device(device)
    step = build_ot_step(args, device)
    hp = args["model_parameters"]["hyperparams"]
    batch, sizes = ot_batch(args.get("batch_size", 16), hp["n_true_confs"],
                            device=device, **args.get("dataset_params", {}))
    seed = args.get("seed", 0)
    losses = [step.step(batch, torch.Generator(device).manual_seed(seed + i))
              for i in range(steps)]
    return {"losses": [float(x) for x in losses], "step": step,
            "batch": batch, "sizes": sizes}
