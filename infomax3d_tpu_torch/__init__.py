"""PyTorch + CUDA port of `infomax3d_tpu` for NVIDIA Hopper (H100).

The JAX package `infomax3d_tpu` is the reference; this package reproduces
it module by module and never imports it (nor `jax` / `flax`).  Plain tensor
code is PyTorch; each Pallas kernel of the reference becomes a hand-written
CUDA C++ kernel under `csrc/`, bound with ctypes (`ops/kernels/`).  Every
kernel wrapper runs its plain PyTorch twin on CPU tensors and launches the
kernel (or raises) on CUDA tensors.

Ported so far: the fingerprint-serving CLI and the embedding analysis
(`cli.inference`, `cli.analysis`: PNA and OGBGNN from SMILES or a dataset,
from the port's `.pt` or the JAX package's flax msgpack checkpoints,
`train.torch_interop`, `train.flax_msgpack`); four training steps:
contrastive pre-training of PNA and Net3DDense (`train.pretrain`), the supervised step (`train.supervised`; OGBGNN and the
trainer's PNA fine-tune), the GeoMol optimal-transport step (`train.ot`);
and the training CLI for pre-train -> fine-tune (`cli.train`, `cli.config`
with its own YAML reader `cli.yaml_lite`): `train.trainer`'s `Trainer` and
`SelfSupervisedTrainer` over those steps, the schedulers, metrics, grouped
optimizers, checkpoints in the reference's `.pt` payload, run logging, the
synthetic dataset, splits and `data.loader.GraphDataLoader`.
"""
from infomax3d_tpu_torch.device import resolve_device

__all__ = ["resolve_device"]
