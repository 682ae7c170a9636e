"""Build, load and call the port's CUDA kernels.

Each source `csrc/<name>.cu` (with the shared `csrc/common.cuh`) is compiled
by `nvcc` for `sm_90a` into its own shared library with a plain C interface
and loaded with ctypes.  The libraries go to `build/infomax3d_tpu_torch/` at
the root of the checkout, named by a hash of their sources and flags, so a
changed source is rebuilt and an unchanged one is built once.  The build
happens at first use, all missing libraries at once (one `nvcc` process per
source, started together).  Nothing is compiled when the module is imported:
the CPU path needs no `nvcc`.  The build holds a file lock in the build
directory, so processes that start together (the ranks of a data-parallel
run) build each library once and the others load it.
"""
from __future__ import annotations

import contextlib
import ctypes
import fcntl
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict

import torch

KERNELS = ("edge_combine", "pna_stats", "multi_reduce", "pair_segment_sum",
           "pna_stats_bwd", "csr_sum", "snd_segment_sum")
CSRC = Path(__file__).resolve().parents[2] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "infomax3d_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME and os.path.exists(os.path.join(CUDA_HOME, "bin", "nvcc")):
        return os.path.join(CUDA_HOME, "bin", "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels are built with the "
                       "CUDA toolkit's nvcc (on PATH or under CUDA_HOME)")


def library_path(name: str) -> Path:
    """Where `csrc/<name>.cu` is built: keyed by its sources and flags."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in (CSRC / "common.cuh", CSRC / f"{name}.cu"):
        h.update(src.read_bytes())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


@contextlib.contextmanager
def _build_lock():
    """An exclusive lock on the build directory, across processes."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / ".lock", "w") as f:
        fcntl.flock(f, fcntl.LOCK_EX)
        try:
            yield
        finally:
            fcntl.flock(f, fcntl.LOCK_UN)


def build_all() -> Dict[str, str]:
    """Compile every kernel library that is not built yet, all in parallel,
    under the build directory's lock (a process that waited for another's
    build finds the libraries and builds nothing).  Returns nvcc's output
    (ptxas register / spill report) per built name; raises with nvcc's
    output if any build fails."""
    if all(library_path(n).exists() for n in KERNELS):
        return {}
    with _build_lock():
        return _build_missing()


def _build_missing() -> Dict[str, str]:
    todo = {n: library_path(n) for n in KERNELS
            if not library_path(n).exists()}
    if not todo:
        return {}
    nvcc = _nvcc()
    procs = {}
    for name, path in todo.items():
        tmp = path.with_suffix(f".so.tmp{os.getpid()}")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, path)
    logs, failed = {}, []
    for name, (proc, tmp, path) in procs.items():
        logs[name] = proc.communicate()[0]
        if proc.returncode != 0:
            failed.append(name)
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, path)
    if failed:
        raise RuntimeError("nvcc failed for " + ", ".join(failed) + ":\n" +
                           "\n".join(logs[n] for n in failed))
    return logs


@functools.lru_cache(maxsize=None)
def library(name: str) -> ctypes.CDLL:
    """The loaded library of `csrc/<name>.cu`, built first if needed."""
    build_all()
    lib = ctypes.CDLL(str(library_path(name)))
    lib.port_error_string.argtypes = [ctypes.c_int]
    lib.port_error_string.restype = ctypes.c_char_p
    return lib


@functools.lru_cache(maxsize=None)
def launcher(name: str, symbol: str, argtypes: tuple):
    """The C launcher `symbol` of `csrc/<name>.cu`: pointers and the stream
    are `c_void_p`, integers `c_int`; it returns a cudaError_t."""
    fn = getattr(library(name), symbol)
    fn.argtypes = list(argtypes)
    fn.restype = ctypes.c_int
    return fn


def check_launch(name: str, err: int):
    if err != 0:
        msg = library(name).port_error_string(err).decode()
        raise RuntimeError(f"{name} kernel launch failed: {msg} ({err})")


def on_card(t: torch.Tensor, name: str) -> bool:
    """The dispatch of every wrapper: True for a CUDA tensor (launch the
    kernel), False for a CPU tensor (run the plain version); any other
    device raises."""
    if t.device.type == "cpu":
        return False
    if t.device.type == "cuda":
        return True
    raise ValueError(f"{name}: unsupported device {t.device}")


def refuse_grad(name: str, *tensors):
    """A kernel launch records nothing for autograd, so a launch that gets
    a tensor requiring grad while grad mode is on would drop its gradient:
    raise instead.  The wrappers launch inside their `autograd.Function`,
    where grad mode is off."""
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{name}: a kernel launch is not differentiable; call it through "
            f"its wrapper, whose autograd.Function carries the gradient")


def stream_of(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def require(t: torch.Tensor, what: str, dtype: torch.dtype, shape: tuple,
            device: torch.device):
    """Raise unless `t` is a contiguous tensor of this dtype, shape and
    device."""
    if t.dtype != dtype:
        raise TypeError(f"{what}: expected {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{what}: expected shape {tuple(shape)}, "
                         f"got {tuple(t.shape)}")
    if t.device != device:
        raise ValueError(f"{what}: expected device {device}, got {t.device}")
    if not t.is_contiguous():
        raise ValueError(f"{what}: must be contiguous")
