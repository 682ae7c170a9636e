"""Tensor parallelism over a ``model`` group (port of `infomax3d_tpu/
parallel/tp.py`, the ``model_shards`` mode).

The JAX package's TP is a layout: `tp_spec_for` column-shards each 2D
kernel ``[in, out]`` whose ``out`` divides by k, and each 1D leaf whose
length does, over the ``model`` mesh axis; `tp_shard_tree` puts the whole
train state (parameters, optimizer moments, BatchNorm statistics, BYOL's
teachers) in that layout, and GSPMD derives the collectives.  The port
keeps the layout and writes the collectives itself:

* **Layout.**  Each model rank owns the column shard of every leaf that
  `tp_spec_for` shards, read on the leaf's flax view (`interop.flax_paths`:
  a ``kernel`` is the torch ``Linear.weight`` transposed, so its ``out``
  is torch dim 0; every other leaf has the flax shape, its last dim
  sharded).  `shard_module` replaces each such parameter by this rank's
  shard, so the rank holds that shard's float32 master, its gradient and
  its Adam moments, and never the whole leaf between steps.  The port's
  modules hold no fused leaf (each torch parameter is one flax leaf:
  `flax_paths` is one-to-one), so no leaf needs the rule "shard only if
  every flax leaf in it is sharded".  BatchNorm running statistics stay
  whole and replicated: the forward moves them at full width, and every
  model rank moves them the same way.  That differs from JAX's sharded
  ``batch_stats`` by a few KB per rank.
* **Step.**  The forward runs on full-width parameters built inside the
  differentiated function (`train/precision.py::compute_params`): one
  flat all-gather per dtype of the shards (cast to bf16 first under the
  bf16 recipe, which halves the bytes), whose backward takes this rank's
  slice of each cotangent with no collective (`parallel/collectives.py::
  gather_shards`).  Every kernel and module sees the tensors of one
  process, unchanged.  The gradient mean runs over the data group only;
  the replicated leaves' gradients, equal on every model rank, are taken
  from model rank 0 (`broadcast_replicated_grads`), so the model ranks
  stay bit-equal whatever a kernel's summation order.
* **What it buys.**  The compute is replicated over the model ranks: the
  claim is the memory of the masters and moments per rank (about 1/k of
  the sharded leaves'), not a faster step.  A column-parallel forward
  (ROADMAP queue 2) would shard the compute too.

`make_tp_grid` is the (data, model) grid of ``n_data x n_model`` ranks,
rank ``d * n_model + m`` holding data shard d and model part m (the order
of `make_tp_mesh`).  Checkpoints hold full tensors: every rank gathers
(`full_state_dict`, `full_optimizer_state`) and rank 0 writes; a load
slices (`shard_state_dict`, `shard_optimizer_state`).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Iterable, List, Mapping, Optional, Tuple

import torch
import torch.distributed as dist
from torch import nn

from infomax3d_tpu_torch.interop import flax_paths
from infomax3d_tpu_torch.parallel.collectives import (all_reduce_,
                                                      broadcast_flat_,
                                                      gather_leaves,
                                                      gather_shards)
from infomax3d_tpu_torch.parallel.mesh import Grid, make_grid


def tp_spec_for(path: str, value: Any, tp_size: int,
                axis: str = "model") -> Tuple:
    """The JAX package's partition spec of one flax leaf, as a tuple:
    ``(None, axis)`` for a 2D leaf whose last dim divides by `tp_size`
    (column-sharded), ``(axis,)`` for a 1D leaf that divides, ``()``
    (replicated) for everything else.  `path` is unused, as in JAX."""
    del path
    shape = tuple(getattr(value, "shape", ()))
    if len(shape) == 2 and shape[1] % tp_size == 0 and shape[1] >= tp_size:
        return (None, axis)
    if len(shape) == 1 and shape[0] % tp_size == 0 and shape[0] >= tp_size:
        return (axis,)
    return ()


@dataclasses.dataclass(frozen=True)
class Shard:
    """A sharded leaf: torch dim `dim` cut in `k` equal parts, this rank
    holding part `index`."""
    dim: int
    k: int
    index: int


# the attribute of a module holding its own leaves' `Shard`s (each shard
# parameter also carries its own as ``_tp``: the optimizer sees only the
# parameters, a BYOL teacher's deep copy only the modules)
_LAYOUT = "_tp_shards"


def shard_dim(flax_path: str, t: torch.Tensor, k: int) -> Optional[int]:
    """The torch dim of leaf `t` that `tp_spec_for` shards over `k` model
    ranks, read on its flax view (a ``kernel`` is [out, in] in torch), or
    None (replicated)."""
    kernel = flax_path.rsplit("/", 1)[-1] == "kernel"
    flax_shape = tuple(t.shape)[::-1] if kernel else tuple(t.shape)
    spec = tp_spec_for(flax_path, torch.empty(flax_shape, device="meta"), k)
    if not spec:
        return None
    flax_dim = len(spec) - 1
    return len(flax_shape) - 1 - flax_dim if kernel else flax_dim


def shard_module(module: nn.Module, k: int, index: int,
                 replaced: Optional[Dict[int, nn.Parameter]] = None) -> int:
    """Replace each parameter of `module` that `tp_spec_for` shards over
    `k` model ranks by its part `index` (a new float32 `Parameter`; the
    whole leaf is dropped), and record its `Shard` on its owning module.
    The module must hold the same whole weights on every model rank.
    `replaced` collects id(old parameter) -> its shard.  Returns the
    number of leaves sharded."""
    if k < 2:
        return 0
    paths = flax_paths(module)
    n = 0
    for mod_name, mod in module.named_modules():
        for leaf, p in list(mod.named_parameters(recurse=False)):
            name = f"{mod_name}.{leaf}" if mod_name else leaf
            dim = shard_dim(paths[name], p, k)
            if dim is None:
                continue
            part = p.detach().chunk(k, dim)[index].clone().contiguous()
            shard = nn.Parameter(part, requires_grad=p.requires_grad)
            shard._tp = Shard(dim, k, index)
            mod._parameters[leaf] = shard
            if replaced is not None:
                replaced[id(p)] = shard
            mod.__dict__.setdefault(_LAYOUT, {})[leaf] = shard._tp
            n += 1
    return n


def shard_step(step, k: int, index: int) -> int:
    """`shard_module` on each model of a step object built whole (its
    ``model``, ``model3d``, ``critic`` and BYOL ``teachers``), its
    optimizer's param groups pointed at the shards; before the first
    update (the optimizer holds no state yet).  Returns the number of
    leaves sharded."""
    replaced: Dict[int, nn.Parameter] = {}
    mods = [getattr(step, a) for a in ("model", "model3d", "critic")
            if isinstance(getattr(step, a, None), nn.Module)]
    mods += list(getattr(step, "teachers", {}).values())
    n = sum(shard_module(m, k, index, replaced) for m in mods)
    for _, opt in _optimizers(step.optimizer):
        if opt.state:
            raise ValueError("shard a step before its first update")
        for g in opt.param_groups:
            g["params"] = [replaced.get(id(p), p) for p in g["params"]]
    return n


def sharded_leaves(module: nn.Module) -> Dict[str, Shard]:
    """Each sharded parameter of `module` by its torch name."""
    out = {}
    for mod_name, mod in module.named_modules():
        for leaf, s in mod.__dict__.get(_LAYOUT, {}).items():
            out[f"{mod_name}.{leaf}" if mod_name else leaf] = s
    return out


def is_sharded(module: nn.Module) -> bool:
    return any(_LAYOUT in m.__dict__ for m in module.modules())


def is_shard(p: torch.Tensor) -> bool:
    """Whether parameter `p` is a model rank's shard (`shard_module`)."""
    return getattr(p, "_tp", None) is not None


def full_parameters(module: nn.Module, params: Mapping[str, torch.Tensor],
                    group) -> Dict[str, torch.Tensor]:
    """`params` (the module's parameters by name, possibly cast) with each
    sharded one replaced by the whole leaf, gathered over the model
    `group` differentiably (`gather_shards`: one all-gather per dtype;
    its backward slices the cotangent)."""
    shards = sharded_leaves(module)
    if not shards:
        return dict(params)
    names = list(shards)
    full = gather_shards([params[n] for n in names],
                         [shards[n].dim for n in names], group)
    out = dict(params)
    out.update(zip(names, full))
    return out


def full_state_dict(module: nn.Module, group) -> Dict[str, torch.Tensor]:
    """`module.state_dict()` with every sharded leaf whole (gathered over
    the model `group`: every model rank calls it)."""
    sd = dict(module.state_dict())
    shards = sharded_leaves(module)
    if shards:
        names = list(shards)
        full = gather_leaves([sd[n] for n in names],
                             [shards[n].dim for n in names], group)
        sd.update(zip(names, full))
    return sd


def shard_state_dict(module: nn.Module, sd: Mapping[str, torch.Tensor]
                     ) -> Dict[str, torch.Tensor]:
    """A whole state dict `sd` with each leaf that `module` shards cut to
    this rank's part (for `load_state_dict`)."""
    out = dict(sd)
    for name, s in sharded_leaves(module).items():
        if name in out:
            out[name] = out[name].chunk(s.k, s.dim)[s.index].contiguous()
    return out


def shard_of(module: nn.Module, name: str, t: torch.Tensor) -> torch.Tensor:
    """This rank's part of the whole leaf `t` of parameter `name` (`t`
    itself where `name` is not sharded)."""
    s = sharded_leaves(module).get(name)
    return t if s is None else t.chunk(s.k, s.dim)[s.index]


def whole_shape(module: nn.Module, name: str, t: torch.Tensor
                ) -> Tuple[int, ...]:
    """The whole leaf's shape of parameter `name` whose local tensor is
    `t`."""
    s = sharded_leaves(module).get(name)
    if s is None:
        return tuple(t.shape)
    shape = list(t.shape)
    shape[s.dim] *= s.k
    return tuple(shape)


def _optimizers(optimizer) -> List[Tuple[Optional[str], Any]]:
    inner = getattr(optimizer, "optimizers", None)
    if inner is None:
        return [(None, optimizer)]
    return list(inner.items())


def _state_tensors(state: Mapping, p: torch.Tensor) -> List[str]:
    """The keys of a parameter's optimizer state shaped like it (Adam's
    moments, SGD's momentum)."""
    return [k for k, v in state.items() if isinstance(v, torch.Tensor)
            and v.dim() > 0 and tuple(v.shape) == tuple(p.shape)]


def full_optimizer_state(optimizer, group) -> Dict[str, Any]:
    """`optimizer.state_dict()` (an `OptimizerSet`'s too) with each shard
    parameter's moments whole, gathered over the model `group` (every
    model rank calls it)."""
    out = {}
    for key, opt in _optimizers(optimizer):
        sd = opt.state_dict()
        params = [p for g in opt.param_groups for p in g["params"]]
        entries = [(i, k) for i, p in enumerate(params) if is_shard(p)
                   and i in sd["state"]
                   for k in _state_tensors(sd["state"][i], p)]
        if entries:
            full = gather_leaves([sd["state"][i][k] for i, k in entries],
                                 [params[i]._tp.dim for i, _ in entries],
                                 group)
            state = {i: dict(v) for i, v in sd["state"].items()}
            for (i, k), t in zip(entries, full):
                state[i][k] = t
            sd = dict(sd, state=state)
        out[key] = sd
    return out[None] if None in out else out


def shard_optimizer_state(optimizer, sd: Mapping[str, Any]
                          ) -> Dict[str, Any]:
    """A whole optimizer state dict `sd` with each shard parameter's
    moments cut to this rank's part (for `load_state_dict`)."""
    out = {}
    for key, opt in _optimizers(optimizer):
        own = sd if key is None else sd[key]
        params = [p for g in opt.param_groups for p in g["params"]]
        state = {}
        for i, v in own["state"].items():
            v = dict(v)
            p = params[int(i)]
            if is_shard(p):
                whole = list(p.shape)
                whole[p._tp.dim] *= p._tp.k
                for name, t in v.items():
                    if isinstance(t, torch.Tensor) and list(t.shape) == whole:
                        v[name] = t.chunk(p._tp.k, p._tp.dim)[
                            p._tp.index].contiguous()
            state[i] = v
        out[key] = dict(own, state=state)
    return out[None] if None in out else out


def broadcast_replicated_grads(params: Iterable[torch.Tensor], group
                               ) -> None:
    """Overwrite the gradients of the replicated (unsharded) `params` with
    model rank 0's: one flat broadcast per dtype.  Every model rank
    computes them from the same forward on the same batch, so this only
    removes what a kernel's summation order might leave between ranks."""
    grads = [p.grad for p in params if p.grad is not None
             and not is_shard(p)]
    if grads:
        broadcast_flat_(grads, group)


def grad_norm(params: Iterable[torch.Tensor], group) -> torch.Tensor:
    """The L2 norm of the whole gradient of `params` (each `.grad` set):
    the shards' squares summed over the model `group`, the replicated
    leaves' counted once."""
    params = list(params)
    shard = sum((p.grad * p.grad).sum() for p in params if is_shard(p))
    rep = sum((p.grad * p.grad).sum() for p in params if not is_shard(p))
    if isinstance(shard, torch.Tensor):
        all_reduce_(shard, group)
    return torch.sqrt(shard + rep)


def master_bytes(params: Iterable[torch.Tensor], optimizer) -> int:
    """Bytes this rank holds for the float32 masters `params` and their
    optimizer state tensors (Adam's two moments)."""
    params = list(params)
    n = sum(p.numel() * p.element_size() for p in params)
    for _, opt in _optimizers(optimizer):
        for p in params:
            st = opt.state.get(p, {})
            n += sum(v.numel() * v.element_size() for v in st.values()
                     if isinstance(v, torch.Tensor) and v.dim() > 0)
    return n


def make_tp_grid(n_data: int, n_model: int) -> Grid:
    """The (data, model) grid of the joined default group of ``n_data *
    n_model`` ranks (every rank calls it; `parallel/mesh.py::make_grid`
    in mode "model")."""
    return make_grid(n_data, n_model, "model")
