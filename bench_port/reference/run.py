"""The reference's training steps: the raw molecules batched here (the bond
graphs, and one complete graph per conformer, molecule-major), PNA and
Net3D (`pna.py`, `net3d.py`), the loss (`loss.py`) and Adam, on float32
parameters with TF32 off, from the weights it is given.

`ReferenceRun.record` gives what the benchmark compares: the loss of each
step, both models' outputs at the first step, each leaf's first gradient
norm and each leaf's change after the steps (the BatchNorm running
statistics counted as leaves of the change)."""
from __future__ import annotations

import math
from typing import Callable, Dict, List, Mapping, Sequence

import numpy as np
import torch

from bench_port.reference.loss import ntxent_multiple_positives
from bench_port.reference.net3d import Net3DShape, net3d_forward
from bench_port.reference.nn import Layers, Spec, identity
from bench_port.reference.pna import PNAShape, pna_forward

MODELS = ("model", "model3d")
BUFFER_SUFFIXES = ("running_mean", "running_var", "num_batches_tracked")


def parameter_spec(config: Mapping) -> Spec:
    """Every tensor of both models (parameters and BatchNorm state), named
    ``model.<name>`` / ``model3d.<name>`` as the published state dicts
    name them, with its shape and initializer."""
    if config.get("model_type") != "PNA" or config.get(
            "model3d_type") != "Net3D":
        raise NotImplementedError("the reference runs PNA with the flat "
                                  "Net3D")
    shapes = (("model", PNAShape(config["model_parameters"])),
              ("model3d", Net3DShape(config["model3d_parameters"])))
    return [(f"{key}.{name}",) + tuple(rest)
            for key, shape in shapes for name, *rest in shape.spec()]


def is_buffer(name: str) -> bool:
    return name.endswith(BUFFER_SUFFIXES)


def learning_rates(config: Mapping, steps: int) -> List[float]:
    """The learning rate of each of the first `steps` steps: the
    optimizer's lr, under a one-phase linear `WarmUpWrapper` ramped as
    ``lr * (k - 1) / warmup`` at step k."""
    lr = float((config.get("optimizer_params") or {}).get("lr", 1e-3))
    sched = config.get("lr_scheduler")
    if sched is None:
        return [lr] * steps
    params = config.get("lr_scheduler_params") or {}
    warm = params.get("warmup_steps")
    warm = warm if isinstance(warm, (list, tuple)) else [warm]
    if sched != "WarmUpWrapper" or len(warm) != 1 or params.get(
            "interpolation", "linear") != "linear":
        raise NotImplementedError("the reference ramps one linear warm-up "
                                  "phase")
    return [lr * min(k, int(warm[0])) / int(warm[0]) for k in range(steps)]


def _complete_graphs(sizes: torch.Tensor):
    """(senders, receivers) of the complete graphs of node counts `sizes`
    (consecutive node blocks), sender-major within each graph."""
    pairs = sizes * (sizes - 1)
    graph = torch.repeat_interleave(torch.arange(sizes.shape[0],
                                                 device=sizes.device), pairs)
    first_pair = torch.cumsum(pairs, 0) - pairs
    first_node = torch.cumsum(sizes, 0) - sizes
    local = torch.arange(graph.shape[0], device=sizes.device) - \
        first_pair[graph]
    n1 = (sizes - 1)[graph]
    i = torch.div(local, n1, rounding_mode="floor")
    j = local - i * n1
    j = j + (j >= i).long()
    return first_node[graph] + i, first_node[graph] + j


def reference_batches(mols: Sequence[Mapping[str, np.ndarray]],
                      device) -> tuple:
    """(2D batch, 3D batch) of raw molecules (``node_feat``, ``senders``,
    ``receivers``, ``edge_feat``, ``conformers`` [C, n, 3])."""
    sizes = np.array([m["node_feat"].shape[0] for m in mols])
    first = np.concatenate([[0], np.cumsum(sizes)[:-1]])
    C = mols[0]["conformers"].shape[0]

    def t(a, dtype=torch.long):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype,
                               device=device)
    g2 = {"atoms": t(np.concatenate([m["node_feat"] for m in mols])),
          "bonds": t(np.concatenate([m["edge_feat"] for m in mols])),
          "senders": t(np.concatenate([m["senders"] + o
                                       for m, o in zip(mols, first)])),
          "receivers": t(np.concatenate([m["receivers"] + o
                                         for m, o in zip(mols, first)])),
          "node_graph": t(np.repeat(np.arange(len(mols)), sizes)),
          "n_graphs": len(mols)}
    sizes3 = t(np.repeat(sizes, C))
    coords = t(np.concatenate([m["conformers"].reshape(-1, 3)
                               for m in mols]), torch.float32)
    src, dst = _complete_graphs(sizes3)
    g3 = {"senders": src, "receivers": dst,
          "dist": torch.linalg.vector_norm(coords[src] - coords[dst], dim=-1),
          "node_graph": torch.repeat_interleave(
              torch.arange(sizes3.shape[0], device=device), sizes3),
          "n_graphs": int(sizes3.shape[0])}
    return g2, g3


class ReferenceRun:
    """The reference trained from `weights` (``model.*`` / ``model3d.*``
    tensors, parameters and BatchNorm state) under the config's loss and
    Adam; `q` rounds the matrix products' operands (`nn.fp8` for the
    control)."""

    def __init__(self, config: Mapping, weights: Mapping[str, torch.Tensor],
                 q: Callable = identity):
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        self.config = config
        self.shape = {"model": PNAShape(config["model_parameters"]),
                      "model3d": Net3DShape(config["model3d_parameters"])}
        self.q = q
        op = dict(config.get("optimizer_params") or {})
        if float(op.get("weight_decay", 0.0)) or config.get(
                "optimizer", "Adam") != "Adam":
            raise NotImplementedError("the reference runs Adam without "
                                      "weight decay")
        self.betas = tuple(op.get("betas", (0.9, 0.999)))
        self.eps = float(op.get("eps", 1e-8))
        self.tau = float((config.get("loss_params") or {}).get("tau", 0.5))
        if config.get("loss_func") != "NTXentMultiplePositives":
            raise NotImplementedError("the reference loss is "
                                      "NTXentMultiplePositives")
        self.P = {k: {} for k in MODELS}
        self.S = {k: {} for k in MODELS}
        for name, w in weights.items():
            key, local = name.split(".", 1)
            if is_buffer(local):
                self.S[key][local] = w.detach().clone()
            else:
                self.P[key][local] = w.detach().float().clone() \
                    .requires_grad_(True)
        self.start = {n: t.detach().clone() for n, t in self.leaves()}
        self.m = {n: torch.zeros_like(t) for n, t in self.params()}
        self.v = {n: torch.zeros_like(t) for n, t in self.params()}
        self.t = 0
        self.losses: List[float] = []
        self.first_grad: Dict[str, float] = {}
        self.outputs = None

    def params(self):
        for key in MODELS:
            for n, p in self.P[key].items():
                yield f"{key}.{n}", p

    def leaves(self):
        """Parameters and the float BatchNorm statistics, by name."""
        yield from self.params()
        for key in MODELS:
            for n, b in self.S[key].items():
                if b.is_floating_point():
                    yield f"{key}.{n}", b

    def loss(self, g2, g3) -> torch.Tensor:
        mp = self.config["model_parameters"]
        m3 = self.config["model3d_parameters"]
        L2 = Layers(self.P["model"], self.S["model"],
                    float(mp.get("batch_norm_momentum", 0.1)), self.q)
        L3 = Layers(self.P["model3d"], self.S["model3d"],
                    float(m3.get("batch_norm_momentum", 0.1)), self.q)
        z1 = pna_forward(self.shape["model"], L2, g2)
        z2 = net3d_forward(self.shape["model3d"], L3, g3)
        if self.outputs is None:
            self.outputs = [z.detach().cpu().numpy() for z in (z1, z2)]
        return ntxent_multiple_positives(z1, z2, self.tau)

    def step(self, g2, g3, lr: float) -> float:
        names, params = zip(*self.params())
        loss = self.loss(g2, g3)
        grads = torch.autograd.grad(loss, params, allow_unused=True)
        self.t += 1
        b1, b2 = self.betas
        bc1, bc2 = 1 - b1 ** self.t, 1 - b2 ** self.t
        with torch.no_grad():
            for n, p, g in zip(names, params, grads):
                g = torch.zeros_like(p) if g is None else g
                if self.t == 1:
                    self.first_grad[n] = float(torch.linalg.vector_norm(g))
                self.m[n].mul_(b1).add_(g, alpha=1 - b1)
                self.v[n].mul_(b2).addcmul_(g, g, value=1 - b2)
                denom = (self.v[n].sqrt() / math.sqrt(bc2)).add_(self.eps)
                p.addcdiv_(self.m[n], denom, value=-lr / bc1)
        self.losses.append(float(loss.detach()))
        return self.losses[-1]

    def run(self, batches: Sequence[tuple]) -> Dict:
        """The steps on `batches` (one (2D, 3D) pair each) at the config's
        learning rates; returns `record`."""
        for (g2, g3), lr in zip(batches,
                                learning_rates(self.config, len(batches))):
            self.step(g2, g3, lr)
        return self.record()

    def record(self) -> Dict:
        change = {n: float(torch.linalg.vector_norm(t.detach() -
                                                     self.start[n]))
                  for n, t in self.leaves()}
        return {"losses": list(self.losses), "grad": dict(self.first_grad),
                "change": change, "outputs": self.outputs}
