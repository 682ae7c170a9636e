"""The port's native (C) host code, loaded with ctypes (port of
`infomax3d_tpu/native/`).

`batcher.c` is the collate core of `graphs/batch.py::batch_graphs`
(`batcher.py` wraps it).  `load()` builds it at first use with the host's
C compiler (``$CC``, else ``cc``, ``gcc`` or ``clang``) into the build
directory the CUDA kernels use (``build/infomax3d_tpu_torch/`` at the root
of the checkout, ignored by git), named by a hash of the source and the
flags, under the same cross-process lock; nothing is written next to the
source.  A failed build or load raises with the compiler's or the
loader's message: there is no silent fallback.  ``INFOMAX3D_NO_NATIVE=1``
(the JAX package's switch) makes `batch_graphs` take its numpy path,
which stays the oracle.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

from infomax3d_tpu_torch.ops.kernels._build import BUILD_DIR, _build_lock

SOURCE = Path(__file__).resolve().parent / "batcher.c"
CFLAGS = ("-O3", "-shared", "-fPIC", "-ffp-contract=off", "-std=c99")
_LOCK = threading.Lock()
_LIB = None


def disabled() -> bool:
    """Whether ``INFOMAX3D_NO_NATIVE`` asks for the numpy batcher."""
    return os.environ.get("INFOMAX3D_NO_NATIVE", "") not in ("", "0")


def compiler() -> str:
    """The C compiler: ``$CC``, else the first of cc, gcc, clang found."""
    for cc in (os.environ.get("CC"), "cc", "gcc", "clang"):
        if cc and shutil.which(cc):
            return cc
    raise RuntimeError("no C compiler (cc, gcc or clang, or $CC) to build "
                       f"{SOURCE.name}; set INFOMAX3D_NO_NATIVE=1 to batch "
                       "with numpy")


def library_path() -> Path:
    """Where the library is built: keyed by the source and the flags."""
    h = hashlib.sha256(" ".join(CFLAGS).encode())
    h.update(SOURCE.read_bytes())
    return BUILD_DIR / f"batcher-{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the library unless it is built (under the build lock;
    written to a temporary name, then renamed); raises with the
    compiler's output when it fails."""
    path = library_path()
    if path.exists():
        return path
    with _build_lock():
        if path.exists():
            return path
        path.parent.mkdir(parents=True, exist_ok=True)
        tmp = path.with_suffix(f".{os.getpid()}.tmp")
        cmd = [compiler(), *CFLAGS, "-o", str(tmp), str(SOURCE), "-lm"]
        res = subprocess.run(cmd, capture_output=True, text=True)
        if res.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"building {SOURCE.name} failed ("
                               f"{' '.join(cmd)}):\n{res.stdout}{res.stderr}")
        os.replace(tmp, path)
    return path


def load() -> ctypes.CDLL:
    """The batcher library (built at first use), its `pack_topology`
    typed."""
    global _LIB
    if _LIB is not None:
        return _LIB
    with _LOCK:
        if _LIB is None:
            lib = ctypes.CDLL(str(build()))
            i32p = ctypes.POINTER(ctypes.c_int32)
            u8p = ctypes.POINTER(ctypes.c_uint8)
            f32p = ctypes.POINTER(ctypes.c_float)
            i16p = ctypes.POINTER(ctypes.c_int16)
            lib.pack_topology.restype = ctypes.c_int
            lib.pack_topology.argtypes = (
                [i32p] * 4 + [ctypes.c_int32] * 8
                + [i32p] * 5 + [u8p, u8p, i32p, u8p, f32p, f32p]
                + [i32p, i32p, i32p, i16p, i32p, i32p, i32p, i32p])
            _LIB = lib
    return _LIB
