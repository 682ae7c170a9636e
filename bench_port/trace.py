"""What a traced run takes from the program: the profiler's records of one
log period inside the window, reduced to counts and times, and the shapes
of the port's kernel launches in that period.

`LaunchRecorder` wraps each kernel module's `_launch` (the entry the
port's wrappers call on the card) while the profiler runs: it notes the
shapes and dtypes of each call and launches nothing.  `summarize` reduces
the profiler's records: the union of the device's busy intervals, time
and launches by name, and the idle gaps between
device work labelled by the innermost host operation running then."""
from __future__ import annotations

import bisect
import glob
import importlib
import importlib.util
import os
from typing import Dict, List

from bench_port import manifest

TOP = 10
SHORT_GAP_NS = 2000


def load_file(path: str, name: str):
    """The module in `path` (a file of the benchmark found by its name)."""
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def rooflines() -> Dict[str, object]:
    """Every kernel's roofline file (`rooflines/<kernel>.py`), by kernel."""
    return {os.path.basename(p)[:-3]: load_file(p, f"bench_port_roofline_"
                                                   f"{os.path.basename(p)[:-3]}")
            for p in sorted(glob.glob(os.path.join(manifest.BENCH, "rooflines",
                                                   "*.py")))}


class LaunchRecorder:
    """While installed, each call of a roofline file's kernel module's
    `_launch` appends ``(kernel, record)`` to `launches`."""

    def __init__(self):
        self.files = rooflines()
        self.launches: List[tuple] = []
        self._saved = []

    def install(self):
        for kernel, spec in self.files.items():
            mod = importlib.import_module(spec.MODULE)
            orig = mod._launch

            def wrapped(*a, _orig=orig, _kernel=kernel, _spec=spec, **k):
                self.launches.append((_kernel, _spec.record(*a, **k)))
                return _orig(*a, **k)
            mod._launch = wrapped
            self._saved.append((mod, orig))

    def remove(self):
        for mod, orig in self._saved:
            mod._launch = orig
        self._saved = []

    def least_seconds(self, peaks) -> Dict[str, List[float]]:
        """kernel -> [launches, least seconds]: each launch's larger of its
        bytes at the memory rate and its flops at the float32 rate (the
        real rows read back from its row pointers, now)."""
        out: Dict[str, List[float]] = {}
        real = {}
        for kernel, rec in self.launches:
            rp = rec.get("row_ptr")
            e_real = None
            if rp is not None:
                key = id(rp)
                if key not in real:
                    real[key] = int(rp[-1])
                e_real = real[key]
            nbytes, flops = self.files[kernel].work(rec, e_real)
            t = max(nbytes / peaks["hbm_bytes_per_s"],
                    flops / peaks["f32_flops"])
            acc = out.setdefault(kernel, [0, 0.0])
            acc[0] += 1
            acc[1] += t
        return out


def _merge(intervals):
    merged = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return merged


def summarize(prof, window_s: float, steps: int, recorder: LaunchRecorder,
              peaks) -> Dict:
    """The traced period's numbers: ``busy_s`` (union of device records),
    ``window_s``, ``steps``, ``kernels`` (device records that are not
    copies or fills), per port kernel its launches, profiled
    seconds and least seconds (``port``), the top device operations and
    the idle gaps by host operation (``device_ops``, ``idle_gaps``)."""
    from torch.autograd import DeviceType
    dev, cpu = [], []
    for e in prof.profiler.kineto_results.events():
        s = e.start_ns()
        rec = (s, s + e.duration_ns(), e.name())
        if e.device_type() == DeviceType.CPU:
            cpu.append(rec)
        elif e.device_type() == DeviceType.CUDA and \
                not e.is_user_annotation():
            # device records only: kernels, copies and fills, not the
            # device-side spans of annotated host ranges (Adam's step)
            dev.append(rec)
    by_name: Dict[str, List[float]] = {}
    for s, t, name in dev:
        acc = by_name.setdefault(name, [0, 0.0])
        acc[0] += 1
        acc[1] += (t - s) * 1e-9
    merged = _merge((s, t) for s, t, _ in dev)
    busy = sum(t - s for s, t in merged) * 1e-9
    kernels = sum(c for n, (c, _) in by_name.items()
                  if not n.lower().startswith(("memcpy", "memset")))
    least = recorder.least_seconds(peaks)
    port = {}
    for kernel, spec in recorder.files.items():
        hits = [(c, sec) for n, (c, sec) in by_name.items()
                if any(g in n for g in spec.GLOBALS)]
        if hits or kernel in least:
            port[kernel] = {
                "launches": sum(c for c, _ in hits),
                "seconds": sum(sec for _, sec in hits),
                "recorded": least.get(kernel, [0, 0.0])[0],
                "least_seconds": least.get(kernel, [0, 0.0])[1]}
    return {"busy_s": busy, "window_s": window_s, "steps": steps,
            "kernels": kernels, "port": port,
            "device_ops": sorted(([n, sec] for n, (_, sec) in
                                  by_name.items()),
                                 key=lambda x: -x[1])[:TOP],
            "idle_gaps": _idle_gaps(merged, cpu, window_s - busy)}


def _idle_gaps(merged, cpu, idle_s: float):
    """Idle seconds between device records by the innermost host operation
    running at each gap's middle (the latest-started one that spans it;
    gaps under 2 us are one entry); the idle time before the first and
    after the last record is one entry."""
    cpu.sort()
    starts = [s for s, _, _ in cpu]
    by_op: Dict[str, float] = {}
    inside = 0.0
    for (_, a), (b, _) in zip(merged, merged[1:]):
        gap = (b - a) * 1e-9
        inside += gap
        mid = (a + b) // 2
        label = "host work outside traced operations"
        if b - a < SHORT_GAP_NS:
            label = "gaps under 2 us between device records"
        else:
            at = bisect.bisect_right(starts, mid)
            for k in range(at - 1, max(-1, at - 64), -1):
                if cpu[k][1] >= mid:
                    label = cpu[k][2]
                    break
        by_op[label] = by_op.get(label, 0.0) + gap
    edges = idle_s - inside
    if edges > 0:
        by_op["before the first and after the last device record"] = edges
    return sorted(([n, s] for n, s in by_op.items()),
                  key=lambda x: -x[1])[:TOP]
