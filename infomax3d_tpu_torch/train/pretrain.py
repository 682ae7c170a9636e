"""The contrastive pre-training step (port of `bench.py`'s step at the
`configs_clean/pre-train_QM9.yml` architecture): the PNA 2D encoder on a
receiver-sorted CSR batch and Net3DDense on the dense complete-graph batch
of the same molecules, NT-Xent between their outputs, grouped Adam.  The
same step runs multi-conformer pre-training (`configs_clean/
pre-train_QMugs.yml`, `pre-train_GEOM-Drugs.yml`): the flat `Net3D` on the
CSR batch of C conformer complete graphs per molecule, packed
molecule-major (`conformer_batches`), under a multi-positive loss.

Precision follows the JAX package's recipe: float32 master parameters and
optimizer state, the forward on bf16 copies of the parameters and of the
batches' float fields (`train/precision.py`), model outputs cast to
float32 before the loss.  BatchNorm normalizes with masked batch statistics
and updates its float32 running statistics in place.

`PretrainStep` is the step of the contrastive trainer
(`train/trainer.py::SelfSupervisedTrainer`, built there by `from_modules`
over the config's models and grouped optimizer).  `pretrain()` runs a few
steps on one fixed synthetic batch (`flagship_batches`, or
`conformer_batches` for the flat Net3D), on the CUDA card unless asked for
the CPU.
"""
from __future__ import annotations

from typing import Any, Dict, Mapping, Optional, Tuple, Union

import torch

from infomax3d_tpu_torch.data.loader import conformer_collate, to_device
from infomax3d_tpu_torch.data.synthetic import SyntheticMolecules
from infomax3d_tpu_torch.device import resolve_device
from infomax3d_tpu_torch.graphs.batch import (GraphBatch, batch_graphs,
                                              bucket_for, to_graph_batch)
from infomax3d_tpu_torch.graphs.dense import (DenseBatch, dense_batch,
                                              to_dense_batch)
from infomax3d_tpu_torch.interop import (flax_paths, init_jax_variables,
                                         load_variables)
from infomax3d_tpu_torch.losses import get_loss
from infomax3d_tpu_torch.models.registry import build_model
from infomax3d_tpu_torch.parallel.collectives import CrossDeviceLoss
from infomax3d_tpu_torch.parallel.context import data_parallel_group
from infomax3d_tpu_torch.train.optim import build_adam, label_params
from infomax3d_tpu_torch.train.precision import (cast_batch, forward_in,
                                                 resolve_compute_dtype)
from infomax3d_tpu_torch.train.supervised import TrainStep


class PretrainStep(TrainStep):
    """Forward, backward and Adam update of the 2D / 3D pair on one batch
    of molecules: the 2D model is `model_type` (PNA by default, or e.g.
    PNAOriginal), `model3d_type` "Net3DDense" reads a `DenseBatch`,
    "Net3D" or "EGNN" a CSR `GraphBatch` of complete graphs.  `variables` holds flax
    numpy trees for ``model`` and ``model3d`` (`interop.init_jax_variables`
    layout); `compute_dtype` bf16 runs the bf16 recipe, None float32;
    `loss_func` names the loss (`losses.get_loss`).  Adam's groups are the
    JAX package's labels (`optim.label_params` on the flax paths)."""

    def __init__(self, model_parameters: Mapping,
                 model3d_parameters: Mapping, variables: Mapping,
                 device: torch.device,
                 compute_dtype: Optional[torch.dtype] = None,
                 loss_params: Optional[Mapping] = None,
                 optimizer_params: Optional[Mapping] = None,
                 loss_func: str = "NTXent",
                 model3d_type: str = "Net3DDense", model_type: str = "PNA"):
        model = load_variables(build_model(model_type, model_parameters),
                               variables["model"])
        model3d = load_variables(build_model(model3d_type,
                                             model3d_parameters),
                                 variables["model3d"])
        self._setup(model, model3d, device, compute_dtype,
                    get_loss(loss_func, **dict(loss_params or {})))
        self.optimizer = build_adam(
            self.named_parameters(), labels=label_params(self.paths())[0],
            **dict(optimizer_params or {}))

    @classmethod
    def from_modules(cls, model: torch.nn.Module, model3d: torch.nn.Module,
                     device: torch.device,
                     compute_dtype: Optional[torch.dtype], loss_fn,
                     optimizer: Optional[torch.optim.Optimizer] = None
                     ) -> "PretrainStep":
        """The step over given modules, loss and optimizer (the trainer's);
        `optimizer` may be set later, before the first step."""
        step = cls.__new__(cls)
        step._setup(model, model3d, device, compute_dtype, loss_fn)
        step.optimizer = optimizer
        return step

    def _setup(self, model, model3d, device, compute_dtype, loss_fn):
        self.device = torch.device(device)
        self.compute_dtype = compute_dtype
        self.model = model.to(self.device).train()
        self.model3d = model3d.to(self.device).train()
        self.loss_fn = loss_fn

    def paths(self) -> Dict[str, str]:
        """Each parameter's name (`named_parameters`) -> its flax path
        under its model's key, as the JAX package labels the joint tree."""
        return {f"{prefix}.{n}": f"{prefix}/{p}"
                for prefix, m in (("model", self.model),
                                  ("model3d", self.model3d))
                for n, p in flax_paths(m).items()}

    def named_parameters(self):
        """(name, parameter) of both models: ``model.*``, ``model3d.*``."""
        for prefix, m in (("model", self.model), ("model3d", self.model3d)):
            for n, p in m.named_parameters():
                yield f"{prefix}.{n}", p

    def prepare(self, g2: GraphBatch, g3: Union[DenseBatch, GraphBatch]
                ) -> Tuple[GraphBatch, Union[DenseBatch, GraphBatch]]:
        """The batches as the forward reads them: on the step's device,
        float fields in the compute dtype (`bench.py` casts them once; the
        JAX trainer's `_cast_in` casts every float32 leaf of the batch, so
        a complete graph's `edge_dist` reaches the Fourier encoding in
        bf16)."""
        return (cast_batch(g2.to(self.device), self.compute_dtype),
                cast_batch(g3.to(self.device), self.compute_dtype))

    def outputs(self, g2: GraphBatch, g3: DenseBatch, noise=None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Both models' float32 outputs on prepared batches, under the
        recipe (training or eval, as the modules are set); `noise` draws
        the dropout masks, the 2D model's first."""
        return (forward_in(self.model, self.compute_dtype, g2,
                           **noise_kw(noise)),
                forward_in(self.model3d, self.compute_dtype, g3,
                           **noise_kw(noise)))

    def loss(self, g2: GraphBatch, g3: DenseBatch, noise=None):
        """(float32 loss, both outputs) on prepared batches."""
        z1, z2 = self.outputs(g2, g3, noise)
        return self.loss_fn(z1, z2, **loss_kwargs(self.loss_fn, g2)), \
            (z1, z2)


def noise_kw(noise) -> Dict[str, Any]:
    """A forward's keyword arguments for the noise source `noise` (none
    without one: some 3D models' forwards take no source)."""
    return {} if noise is None else {"noise": noise}


def loss_kwargs(loss_fn, g2: GraphBatch) -> Dict[str, Any]:
    """The 2D batch's node-to-graph ids and node mask for a node-level
    ("Local") loss, or the one `SampleLossWrapper` wraps (the JAX
    `SelfSupervisedTrainer._loss_kwargs`), with the batch's graph count
    (`n_graphs_local`, for `CrossDeviceLoss`'s offset) under a
    data-parallel group; nothing for the others."""
    if isinstance(loss_fn, CrossDeviceLoss):
        loss_fn = loss_fn.loss
    inner = getattr(loss_fn, "loss", loss_fn)
    if "Local" in type(inner).__name__:
        kw = dict(node_graph=g2.node_graph, node_mask=g2.node_mask)
        if data_parallel_group() is not None:
            kw["n_graphs_local"] = g2.graph_mask.shape[0]
        return kw
    return {}


def flagship_batches(batch_size: int, seed: int = 0, n_min: int = 10,
                     n_max: int = 26, device="cpu"
                     ) -> Tuple[GraphBatch, DenseBatch, Dict[str, int]]:
    """`bench.py`'s batch: `batch_size` synthetic QM9-like molecules as a
    CSR 2D batch and a dense 3D batch, plus their sizes: graphs, 2D bond
    edges and 3D complete-graph edges (the edges of `bench.py`'s
    edges/s)."""
    ds = SyntheticMolecules(batch_size, seed=seed, n_min=n_min, n_max=n_max)
    mols2 = [ds.graph2d(i) for i in range(batch_size)]
    mols3 = [ds.graph3d(i) for i in range(batch_size)]
    b2 = bucket_for(mols2, batch_size)
    g2 = to_graph_batch(batch_graphs(mols2, b2), b2, device)
    nmax3 = max(m["node_feat"].shape[0] for m in mols3)
    g3 = to_dense_batch(dense_batch(mols3, batch_size, nmax3), device)
    sizes = {"graphs": batch_size,
             "edges_2d": sum(m["senders"].shape[0] for m in mols2),
             "edges_3d": sum(m["senders"].shape[0] for m in mols3)}
    return g2, g3, sizes


def conformer_batches(batch_size: int, num_conformers: int, seed: int = 0,
                      n_min: int = 20, n_max: int = 70, device="cpu"
                      ) -> Tuple[GraphBatch, GraphBatch, Dict[str, int]]:
    """A multi-conformer pre-training batch: `batch_size` synthetic
    molecules of `n_min` to `n_max` atoms (drug-like sizes by default)
    with `num_conformers` conformers each, as the CSR 2D batch and the CSR
    batch of the conformers' complete graphs packed molecule-major (as
    `conformer_collate` packs them), plus their sizes: graphs, conformers,
    2D bond edges and 3D complete-graph edges."""
    ds = SyntheticMolecules(batch_size, seed=seed, n_min=n_min, n_max=n_max,
                            num_conformers=num_conformers)
    items = [{"graph2d": ds.graph2d(i),
              "conformers3d": [ds.graph3d(i, conformer=c)
                               for c in range(num_conformers)]}
             for i in range(batch_size)]
    view = conformer_collate(items, bucket_for(
        [it["graph2d"] for it in items], batch_size))
    g2, g3 = (to_device(view[k], device) for k in ("graph2d", "graph3d"))
    sizes = {"graphs": batch_size, "conformers": batch_size * num_conformers,
             "edges_2d": int(g2.csr_row_ptr[-1]),
             "edges_3d": int(g3.csr_row_ptr[-1])}
    return g2, g3, sizes


def build_step(args: Mapping[str, Any], device: torch.device) -> PretrainStep:
    """`PretrainStep` from a config-like dict: `model_type` (default
    "PNA"), `model_parameters`, `model3d_type` (default "Net3DDense"),
    `model3d_parameters`,
    `loss_func` (default "NTXent"), `loss_params`, `optimizer_params` (the
    YAML keys), `bf16_compute` (default "auto"), `remat`, and seeded numpy
    weights in the flax layout (`seed`, default 0; the 3D model takes
    `seed + 1`)."""
    seed = args.get("seed", 0)
    m_type = args.get("model_type", "PNA")
    m3_type = args.get("model3d_type", "Net3DDense")
    variables = {
        "model": dict(zip(("params", "batch_stats"), init_jax_variables(
            args["model_parameters"], seed, m_type))),
        "model3d": dict(zip(("params", "batch_stats"), init_jax_variables(
            args["model3d_parameters"], seed + 1, m3_type)))}
    step = PretrainStep(
        args["model_parameters"], args["model3d_parameters"], variables,
        device, resolve_compute_dtype(args.get("bf16_compute", "auto"),
                                      device),
        args.get("loss_params"), args.get("optimizer_params"),
        args.get("loss_func", "NTXent"), m3_type, m_type)
    step.remat = bool(args.get("remat", False))
    return step


def pretrain(args: Dict[str, Any], steps: int = 1,
             device: Optional[str] = None) -> Dict[str, Any]:
    """Run `steps` pre-training steps on one fixed batch of
    `args["batch_size"]` (default 500) synthetic molecules
    (`args["dataset_params"]`: seed, n_min, n_max): `flagship_batches`
    (QM9-like, 10 to 26 atoms by default), or for a 3D model on the CSR
    complete graphs (`model3d_type` "Net3D", "EGNN") `conformer_batches`
    with `args["num_conformers"]` conformers per molecule (drug-like, 20 to
    70 atoms by default).  Runs on the CUDA card unless `device` says
    otherwise (and raises when there is none).  Returns the float32 losses,
    the step object and the batch sizes."""
    device = resolve_device(device)
    step = build_step(args, device)
    data = dict(args.get("dataset_params", {}))
    if args.get("model3d_type", "Net3DDense") != "Net3DDense":
        g2, g3, sizes = conformer_batches(
            args.get("batch_size", 500), args.get("num_conformers", 1),
            device=device, **data)
    else:
        g2, g3, sizes = flagship_batches(args.get("batch_size", 500),
                                         device=device, **data)
    g2, g3 = step.prepare(g2, g3)
    losses = [step.step(g2, g3) for _ in range(steps)]
    return {"losses": [float(x) for x in losses], "step": step,
            "sizes": sizes}
