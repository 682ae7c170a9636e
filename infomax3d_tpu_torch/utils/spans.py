"""Spans and counters of the port's host work: one system for the
trainer's `timing` and for the profiler's trace.

    from infomax3d_tpu_torch.utils import spans
    with spans.span("loop.step", trainer.timing, "step"):
        ...                                  # timing["step"] += seconds
    with spans.span("step.forward"):
        ...
    spans.count("h2d_bytes", a.nbytes)
    spans.tally()   # {"spans": {name: {"calls", "host_s", "self_s"}},
                    #  "counters": {name: value}}

`span(name, timing, key)` always adds its host seconds
(`time.perf_counter`) to ``timing[key]`` where it is given the dict and the
key.  While a torch profiler records (`torch.autograd._profiler_enabled()`,
checked once when the span starts) it also opens a
`torch.profiler.record_function(name)` range, so the span lands in the
profiler's trace on the clock of the device records, and adds its call,
its host seconds and its self seconds (its seconds less those of the
spans started inside it on the same thread) to the tally.  `count(name,
n)` adds n to a counter of the tally under the same rule.  While no
profiler records, a span that feeds no `timing` key costs that one check
and nothing more: it opens no `record_function` range (one costs ~8 us
even with the profiler off).

The tally holds the most recent recording period: it starts afresh at the
first span or count that starts while a profiler records after one that
started while none did, and stays as it was once the profiler stops.  A
span that started while the profiler recorded and ends after it stopped
still counts.  The one edge case: two recordings with no span or count
between them merge into one tally.

The port's names: the training loop's spans ``loop.loader``,
``loop.to_device``, ``loop.step``, ``loop.device_wait``, ``loop.metrics``,
``loop.logging`` and ``loop.checkpoint`` (`train/trainer.py`, each feeding
the `timing` key of its suffix); inside a training step ``step.forward``,
``step.backward``, ``step.optimizer`` and the OT step's ``step.emd``
(feeding ``host_emd``); inside SMP's forward ``smp.bases`` (the bases,
once a forward) and ``smp.triplets`` (each block's triplet message,
`propagation_depth` times a forward: `models/smp.py`); the counters
``h2d_bytes`` and ``h2d_copies`` where host arrays become a step's
tensors, and there ``smp_triplets`` and ``smp_triplet_rows`` (the real
triplets and the triplet rows of a batch that carries ``tri_mask``:
`graphs/batch.py::to_tensors`).
"""
from __future__ import annotations

import threading
import time
from typing import Dict, List, Optional

import torch

_recording = torch.autograd._profiler_enabled


class _Frames(threading.local):
    """Each thread's open tallied spans: the seconds of the spans that
    ended inside each."""

    def __init__(self):
        self.children: List[float] = []


class _Tally:
    def __init__(self):
        self.was_recording = False
        self.spans: Dict[str, Dict[str, float]] = {}
        self.counters: Dict[str, float] = {}
        self.frames = _Frames()

    def recording(self) -> bool:
        """Whether a profiler records now; the first call that finds one
        after a call that found none starts the tally afresh."""
        on = _recording()
        if on and not self.was_recording:
            self.spans, self.counters = {}, {}
        self.was_recording = on
        return on

    def add(self, name: str, host_s: float, self_s: float) -> None:
        entry = self.spans.get(name)
        if entry is None:
            entry = self.spans[name] = {"calls": 0, "host_s": 0.0,
                                        "self_s": 0.0}
        entry["calls"] += 1
        entry["host_s"] += host_s
        entry["self_s"] += self_s


_TALLY = _Tally()


class span:
    """A named range of host work (module docstring); `timing` and `key`
    name the accumulator it always feeds, if any."""

    __slots__ = ("name", "timing", "key", "range", "t0")

    def __init__(self, name: str, timing: Optional[Dict] = None,
                 key: Optional[str] = None):
        self.name, self.timing, self.key = name, timing, key
        self.range = None

    def __enter__(self):
        if _TALLY.recording():
            self.range = torch.profiler.record_function(self.name)
            self.range.__enter__()
            _TALLY.frames.children.append(0.0)
        if self.range is not None or self.timing is not None:
            self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if self.range is None and self.timing is None:
            return False
        dt = time.perf_counter() - self.t0
        if self.timing is not None:
            self.timing[self.key] += dt
        if self.range is not None:
            self.range.__exit__(*exc)
            self.range = None
            children = _TALLY.frames.children
            inner = children.pop()
            if children:
                children[-1] += dt
            _TALLY.add(self.name, dt, dt - inner)
        return False


def recording() -> bool:
    """Whether a profiler records now: a counter whose value costs work
    to find is found only then."""
    return _TALLY.recording()


def count(name: str, n) -> None:
    """Add `n` to the counter `name` while a profiler records."""
    if _TALLY.recording():
        _TALLY.counters[name] = _TALLY.counters.get(name, 0) + n


def tally() -> Dict[str, Dict]:
    """A copy of the most recent recording period's spans and counters."""
    return {"spans": {k: dict(v) for k, v in _TALLY.spans.items()},
            "counters": dict(_TALLY.counters)}
