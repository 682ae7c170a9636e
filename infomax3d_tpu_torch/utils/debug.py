"""Debug and observability switches (port of `infomax3d_tpu/utils/
debug.py`).

    from infomax3d_tpu_torch.utils.debug import debug_mode
    with debug_mode():            # NaN checks + faulthandler
        trainer.train(...)

* `enable_faulthandler`: Python's faulthandler (the reference's only
  switch).
* `enable_nan_checks`: the counterpart of ``jax_debug_nans``: a forward
  hook on every module raises `FloatingPointError` on a non-finite value
  in a floating-point output, naming the module's class, and
  `torch.autograd.set_detect_anomaly` makes the backward raise on a NaN
  gradient and print the forward's trace of the op that made it.  Each
  check reads the tensors on the host: a debugging aid, slow on the card.
* `debug_mode`: both, undone on exit.
* `profile_trace(log_dir)`: `torch.profiler` around a block (CPU, and the
  card's kernels where CUDA is available), written as a Chrome trace to
  ``log_dir/trace.json``, with the port's spans and counters over the
  block (`utils/spans.py::tally`: calls, host and self seconds of
  ``loop.*`` / ``step.*``, the host-to-device bytes and copies; the
  whole block is the span ``debug.profile_trace``) in
  ``log_dir/spans.json``.

The JAX package's `disable_jit` has no counterpart: the port runs
eagerly.  Nor does `pallas_interpret_mode`: no switch here routes a
kernel to its plain twin, since a CUDA tensor launches its kernel or
raises.  Moving the model and the batch to the CPU runs every kernel's
twin instead.
"""
from __future__ import annotations

import contextlib
import faulthandler
import json
import os
from typing import Optional

import torch
from torch.nn.modules.module import register_module_forward_hook

from infomax3d_tpu_torch.utils import spans

_HOOK: Optional[torch.utils.hooks.RemovableHandle] = None


def enable_faulthandler() -> None:
    faulthandler.enable()


def _finite(out) -> bool:
    if isinstance(out, torch.Tensor):
        return not out.is_floating_point() or bool(torch.isfinite(out).all())
    if isinstance(out, dict):
        return all(_finite(v) for v in out.values())
    if isinstance(out, (tuple, list)):
        return all(_finite(v) for v in out)
    return True


def _check_output(module, inputs, out):
    if not _finite(out):
        raise FloatingPointError(
            f"non-finite values in the output of {type(module).__name__}")


def nan_checks_enabled() -> bool:
    return _HOOK is not None


def enable_nan_checks(on: bool = True) -> None:
    """Raise on non-finite module outputs and NaN gradients (`on`), or stop
    (module docstring)."""
    global _HOOK
    if on and _HOOK is None:
        _HOOK = register_module_forward_hook(_check_output)
    elif not on and _HOOK is not None:
        _HOOK.remove()
        _HOOK = None
    torch.autograd.set_detect_anomaly(on)


@contextlib.contextmanager
def debug_mode(nan_checks: bool = True):
    """faulthandler and, with `nan_checks`, the NaN checks for the block;
    the checks' previous state is restored after."""
    enable_faulthandler()
    prev_hook = nan_checks_enabled()
    prev_anomaly = torch.is_anomaly_enabled()
    if nan_checks:
        enable_nan_checks(True)
    try:
        yield
    finally:
        enable_nan_checks(prev_hook)
        torch.autograd.set_detect_anomaly(prev_anomaly)


@contextlib.contextmanager
def profile_trace(log_dir: str):
    """`torch.profiler` around the block; the Chrome trace goes to
    ``log_dir/trace.json`` (open it in Perfetto or chrome://tracing), the
    spans' and counters' tally to ``log_dir/spans.json``."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        # a span around the block starts the tally afresh (unless the
        # last span before it ran under a profiler too: `utils/spans.py`)
        with spans.span("debug.profile_trace"):
            yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
    with open(os.path.join(log_dir, "spans.json"), "w") as f:
        json.dump(spans.tally(), f, indent=1)
