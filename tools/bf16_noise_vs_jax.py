"""How far the bf16 recipe moves one supervised step's gradient, in the
port and in the JAX package, on the CPU.

    python tools/bf16_noise_vs_jax.py [configs/transformer.yml ...]

For each config (default: `configs/transformer.yml` and
`configs/pnatransformer.yml`), at the config's widths with dropout set to 0
(the masks play no part in the rounding), on 31 synthetic QM9-size
molecules (seed 0, 10 to 26 atoms, binary labels, as `chip_smoke.py`'s
step checks take them), from the same seeded weights in the flax layout:
the JAX `Trainer.loss_fn` gradient in float32 and under its bf16 recipe
(`compute_dtype` bf16), and the port's `SupervisedStep` gradient in
float32 and bf16.  Prints the relative L2 distances between them, the
loss's relative moves and each bf16 gradient's move under master weights
perturbed by 2**-16 relative.  The JAX package is the reference here and
runs on the CPU only; the port runs on the CPU too.
"""
from __future__ import annotations

import os
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from infomax3d_tpu.data.loader import san_collate as jax_san_collate  # noqa: E402
from infomax3d_tpu.graphs.batch import BucketSpec as JaxBucket  # noqa: E402
from infomax3d_tpu.graphs.batch import batch_graphs as jax_batch_graphs  # noqa: E402
from infomax3d_tpu.graphs.batch import to_graph_batch as jax_graph_batch  # noqa: E402
from infomax3d_tpu.models.registry import get_model_class  # noqa: E402
from infomax3d_tpu.train.trainer import Trainer  # noqa: E402
from infomax3d_tpu_torch.cli.config import load_config  # noqa: E402
from infomax3d_tpu_torch.data.loader import DENSE_COLLATES, san_collate  # noqa: E402
from infomax3d_tpu_torch.data.synthetic import SyntheticMolecules  # noqa: E402
from infomax3d_tpu_torch.graphs.batch import (batch_graphs, bucket_for,  # noqa: E402
                                              to_graph_batch)
from infomax3d_tpu_torch.graphs.dense import to_dense_batch  # noqa: E402
from infomax3d_tpu_torch.interop import init_jax_variables, params_from_jax  # noqa: E402
from infomax3d_tpu_torch.train.supervised import SupervisedStep  # noqa: E402

GRAPHS = 31
DATA = dict(seed=0, n_min=10, n_max=26)
PERTURB = 2.0 ** -16


def batches(args):
    """(port batch, JAX batch) of the same labelled molecules."""
    ds = SyntheticMolecules(GRAPHS, num_targets=1, **DATA)
    labels = (ds.targets > 0).astype(np.float32)
    b = bucket_for([ds.graph2d(i) for i in range(GRAPHS)], GRAPHS)
    if args["collate_function"] in DENSE_COLLATES:
        items = [{"graph2d": ds.graph2d(i), "targets": labels[i]}
                 for i in range(GRAPHS)]
        nmax = max(args["max_nodes"], b.nmax)
        return (to_dense_batch(san_collate(items, b, nmax)["graph"], "cpu"),
                jax_san_collate(items, JaxBucket(b.n_graphs, b.n_nodes,
                                                 b.n_edges),
                                max_nodes=nmax)["graph"])
    mols = [dict(ds.graph2d(i), targets=labels[i]) for i in range(GRAPHS)]
    arrays = jax_batch_graphs(mols, JaxBucket(
        b.n_graphs, b.n_nodes, b.n_edges, max_deg=b.max_deg, csr=True,
        nmax=b.nmax), extras_keys=("targets",))
    return (to_graph_batch(batch_graphs(mols, b), b, "cpu"),
            jax_graph_batch(arrays, extras_keys=("targets",)))


def jax_grads(args, variables, jb, dtype):
    tr = Trainer.__new__(Trainer)
    tr.models = {"model": get_model_class(args["model_type"])(
        **args["model_parameters"])}
    tr.loss_name, tr.compute_dtype, tr.args = args["loss_func"], dtype, {}
    as_jnp = lambda t: jax.tree_util.tree_map(jnp.asarray, t)  # noqa: E731
    params = {"model": as_jnp(variables["params"])}
    stats = {"model": as_jnp(variables["batch_stats"])}

    def lf(p):
        return tr.loss_fn(p, stats, {"graph": jb}, 0, jax.random.key(0),
                          True)[0]
    loss, grads = jax.jit(jax.value_and_grad(lf))(params)
    leaves = params_from_jax(jax.tree_util.tree_map(
        lambda v: np.asarray(v, np.float32), grads["model"]), {})
    return float(loss), {n: v.numpy() for n, v in leaves.items()}


def port_grads(args, variables, g, dtype):
    step = SupervisedStep(args["model_type"], args["model_parameters"],
                          variables, "cpu", dtype, args["loss_func"])
    loss = step.loss_and_grads(step.prepare(g))
    return float(loss), {n: p.grad.numpy().copy()
                         for n, p in step.model.named_parameters()}


def perturbed(variables):
    rng = np.random.default_rng(7)
    params = jax.tree_util.tree_map(
        lambda v: (v * (1 + PERTURB * (rng.random(v.shape) * 2 - 1))
                   ).astype(np.float32), variables["params"])
    return dict(variables, params=params)


def main(configs):
    for config in configs:
        args = load_config(config, {})
        args["model_parameters"] = dict(args["model_parameters"], dropout=0.0)
        params, stats = init_jax_variables(args["model_parameters"], 0,
                                           args["model_type"])
        variables = {"params": params, "batch_stats": stats}
        g, jb = batches(args)
        runs = {
            "jax f32": jax_grads(args, variables, jb, None),
            "jax bf16": jax_grads(args, variables, jb, jnp.bfloat16),
            "jax bf16, perturbed": jax_grads(args, perturbed(variables), jb,
                                             jnp.bfloat16),
            "port f32": port_grads(args, variables, g, None),
            "port bf16": port_grads(args, variables, g, torch.bfloat16),
            "port bf16, perturbed": port_grads(args, perturbed(variables), g,
                                               torch.bfloat16)}
        names = sorted(runs["port f32"][1])

        def dist(a, b):
            fa, fb = (np.concatenate([runs[k][1][n].ravel() for n in names])
                      for k in (a, b))
            return (np.linalg.norm(fa - fb) / np.linalg.norm(fb),
                    abs(runs[a][0] - runs[b][0]) / abs(runs[b][0]))
        print(f"{config}: {args['model_type']} {args['model_parameters']}, "
              f"{GRAPHS} graphs, {args['loss_func']}")
        for a, b in (("port f32", "jax f32"), ("jax bf16", "jax f32"),
                     ("port bf16", "port f32"), ("port bf16", "jax bf16"),
                     ("jax bf16, perturbed", "jax bf16"),
                     ("port bf16, perturbed", "port bf16")):
            l2, loss = dist(a, b)
            print(f"  {a} vs {b}: gradient L2 {l2:.4g}, loss {loss:.4g}")


if __name__ == "__main__":
    main(sys.argv[1:] or ["configs/transformer.yml",
                          "configs/pnatransformer.yml"])
