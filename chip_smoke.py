#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (`infomax3d_tpu_torch`).

    python3 chip_smoke.py            # needs one CUDA card (an H100)

Phases — each raises on failure, so any failure exits non-zero:
1. device: a CUDA card must be present; prints `nvidia-smi`'s name and
   power limit.
2. build: compiles the kernels from `infomax3d_tpu_torch/csrc` (nvcc,
   sm_90a) and prints the build time and ptxas's register report.
3. kernels: each kernel against its plain PyTorch version on the same CUDA
   tensors, at the bench shapes of the port's own batcher (500 synthetic
   QM9-like molecules, seed 0: N = 9216, E = 18432, max_deg 4, D = 200).
4. the slice: `inference()` serves 3 requests of 500 molecules through the
   PNA 200x7 model of `configs_clean/pre-train_QM9.yml` (seeded numpy
   weights in the JAX layout, through `params_from_jax`) in bf16 and in
   float32; each fingerprint matrix is held against the same model and
   batch on the CPU (which runs the plain versions), and each forward's
   kernel launches are counted.  Then ms per forward and graphs/s.
5. profile: torch.profiler's kernel records of warm forwards — device-busy
   time per forward, its idle share and the top kernels.
6. kernel times: device times (CUDA events, the host's launches kept out
   of them) of each kernel — cold-L2 and warm — and of its plain version at
   the bench shapes, beside the least time the card could take (bytes over
   the H100's memory rate, operations over its float32 rate).
It prints a `{"kernels": [...]}` line, the card's name and power limit, and
last `{"ok": true, "device": {...}}`.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

from infomax3d_tpu_torch.cli.inference import build_model, inference
from infomax3d_tpu_torch.data.synthetic import SyntheticMolecules
from infomax3d_tpu_torch.graphs.batch import (batch_graphs, bucket_for,
                                              to_graph_batch)
from infomax3d_tpu_torch.interop import init_jax_variables
from infomax3d_tpu_torch.ops.kernels import (WRAPPERS, edge_combine,
                                             edge_combine_reference,
                                             multi_reduce,
                                             multi_reduce_reference,
                                             pna_stats, pna_stats_reference)
from infomax3d_tpu_torch.ops.kernels._build import build_all

# configs_clean/pre-train_QM9.yml `model_parameters` (no YAML on the card)
MODEL_PARAMETERS = {
    "target_dim": 256,
    "hidden_dim": 200,
    "mid_batch_norm": True,
    "last_batch_norm": True,
    "readout_batchnorm": True,
    "batch_norm_momentum": 0.93,
    "readout_hidden_dim": 200,
    "readout_layers": 2,
    "dropout": 0.0,
    "propagation_depth": 7,
    "aggregators": ["mean", "max", "min", "std"],
    "scalers": ["identity", "amplification", "attenuation"],
    "readout_aggregators": ["min", "max", "mean"],
    "pretrans_layers": 2,
    "posttrans_layers": 1,
    "residual": True,
}
BATCH = 500
DATA = {"num": BATCH, "n_min": 10, "n_max": 26}
WIDTH = MODEL_PARAMETERS["hidden_dim"]
DEPTH = MODEL_PARAMETERS["propagation_depth"]

# Published H100 SXM peaks (NVIDIA data sheet, 700 W): HBM3 bandwidth and
# float32 outside the tensor cores (the kernels' arithmetic is float32).
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOPS = 67e12

# Tolerances of the kernels against their plain versions on the card:
# edge_combine: both sum the same three float32 terms in the same order and
#   round once -> bit-exact.
# pna_stats: max / min / enc select existing values -> exact; sum / mean /
#   std are float32 statistics rounded to bf16 -> within one bf16 ulp
#   (rtol 2**-7 bounds one ulp at any magnitude; atol covers exact zeros).
# multi_reduce: max / min exact; sum / sumsq float32 within 1e-6 relative.
BF16_ULP = 2.0 ** -7
F32_REL = 1e-6
# Fingerprints on the card against the same model and batch on the CPU,
# relative to max|cpu|: float32 matmuls in full float32 on both (TF32 off,
# set below), so only summation order differs -> 1e-4; bf16 matmuls
# accumulate in another order and round at bf16 on both sides, through 7
# layers -> 3e-2.
SLICE_TOL = {True: 3e-2, False: 1e-4}
# launches per forward, from the model's depth
EXPECTED = {True: {"edge_combine": DEPTH, "pna_stats": DEPTH,
                   "multi_reduce": 0},
            False: {"edge_combine": DEPTH, "pna_stats": 0,
                    "multi_reduce": DEPTH}}

KERNEL_INFO = {
    "edge_combine": ("infomax3d_tpu_torch/csrc/edge_combine.cu",
                     "infomax3d_tpu/ops/pallas/spmm.py:1123"),
    "pna_stats": ("infomax3d_tpu_torch/csrc/pna_stats.cu",
                  "infomax3d_tpu/ops/pallas/spmm.py:458"),
    "multi_reduce": ("infomax3d_tpu_torch/csrc/multi_reduce.cu",
                     "infomax3d_tpu/ops/pallas/spmm.py:64"),
}
# No single PyTorch call computes any of the three functions: the combine
# is two row gathers plus adds, the stats and the multi-reduce are 4-6
# reductions per call (torch.segment_reduce does one at a time).
LIBRARY_MS = None


def _check(cond: bool, what: str):
    if not cond:
        raise AssertionError(what)


def phase_device() -> str:
    _check(torch.cuda.is_available(), "no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True, timeout=60).stdout.strip().splitlines()[0]
    print(f"[device] {torch.cuda.get_device_name(0)}; torch "
          f"{torch.__version__}, CUDA {torch.version.cuda}")
    print(smi)
    return smi


def phase_build():
    t0 = time.perf_counter()
    logs = build_all()
    print(f"[build] {time.perf_counter() - t0:.1f} s "
          f"({', '.join(logs) or 'already built'})")
    for name, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"[build] {name}: {line.strip()}")


def bench_batch():
    ds = SyntheticMolecules(seed=0, **DATA)
    graphs = [ds.graph2d(i) for i in range(BATCH)]
    b = bucket_for(graphs, BATCH)
    return to_graph_batch(batch_graphs(graphs, b), b, "cuda")


def _max_err(pairs) -> float:
    return max(float((k.float() - r.float()).abs().max()) for k, r in pairs)


def phase_kernels(g) -> dict:
    N, E, D, K = g.num_nodes, g.senders.shape[0], WIDTH, g.max_deg
    print(f"[kernels] N={N} E={E} (real {int(g.csr_row_ptr[-1])}) D={D} "
          f"K={K}")
    gen = torch.Generator(device="cuda").manual_seed(0)

    def randn(*shape, dtype=torch.float32):
        return torch.randn(*shape, generator=gen, device="cuda").to(dtype)

    deg0 = (g.csr_row_ptr[1:] - g.csr_row_ptr[:-1]) == 0
    _check(bool(deg0.any()), "bench batch has padding nodes")
    errs = {}

    pairs = []
    for dt in (torch.bfloat16, torch.float32):
        hd, hs, pe = randn(N, D, dtype=dt), randn(N, D, dtype=dt), \
            randn(E, D, dtype=dt)
        args = (hd, hs, pe, g.receivers, g.senders)
        k, r = edge_combine(*args), edge_combine_reference(*args)
        torch.cuda.synchronize()
        _check(torch.equal(k, r), f"edge_combine {dt}: not bit-exact")
        pairs.append((k, r))
    errs["edge_combine"] = _max_err(pairs)

    pairs = []
    x = randn(E, D, dtype=torch.bfloat16) * 2
    aff = (torch.rand(D, generator=gen, device="cuda") + 0.5,
           randn(D) * 0.3)
    for affine in (None, aff):
        for want_sum in (True, False):
            k = pna_stats(x, g.csr_row_ptr, K, affine, want_sum)
            r = pna_stats_reference(x, g.csr_row_ptr, K, affine, want_sum)
            torch.cuda.synchronize()
            tag = f"pna_stats affine={affine is not None} sum={want_sum}"
            _check((k[0] is None) == (not want_sum), tag + ": sum section")
            for name, kk, rr in zip(("sum", "mean", "std", "max", "min",
                                     "enc"), k, r):
                if kk is None:
                    continue
                if name in ("max", "min", "enc"):
                    _check(torch.equal(kk, rr), f"{tag}: {name} not exact")
                else:
                    diff = (kk.float() - rr.float()).abs()
                    _check(bool((diff <= BF16_ULP * rr.float().abs()
                                 + 1e-6).all()), f"{tag}: {name} > 1 ulp")
                if name != "enc":
                    _check(bool((kk[deg0] == 0).all()),
                           f"{tag}: {name} nonzero on degree-0 nodes")
                pairs.append((kk, rr))
    errs["pna_stats"] = _max_err(pairs)

    pairs = []
    for dt in (torch.float32, torch.bfloat16):
        x = randn(E, D, dtype=dt)
        k = multi_reduce(x, g.csr_row_ptr, K)
        r = multi_reduce_reference(x, g.csr_row_ptr, K)
        torch.cuda.synchronize()
        for name, kk, rr in zip(("sum", "sumsq", "max", "min"), k, r):
            if name in ("max", "min"):
                _check(torch.equal(kk, rr), f"multi_reduce {dt}: {name}")
            else:
                _check(bool(((kk - rr).abs() <= F32_REL * rr.abs()
                             + 1e-6).all()), f"multi_reduce {dt}: {name}")
            _check(bool((kk[deg0] == 0).all()),
                   f"multi_reduce {dt}: {name} nonzero on degree-0 nodes")
            pairs.append((kk, rr))
    errs["multi_reduce"] = _max_err(pairs)
    for name, err in errs.items():
        print(f"[kernels] {name}: agrees with its plain version "
              f"(max |kernel - plain| = {err:.3g})")
    return errs


def _counts():
    return {n: w.launches for n, w in WRAPPERS.items()}


def phase_slice(out_dir: Path) -> dict:
    """The main path: 3 requests x {bf16, f32} through `inference()`."""
    jax_vars = dict(zip(("params", "batch_stats"),
                        init_jax_variables(MODEL_PARAMETERS, seed=0)))
    for w in WRAPPERS.values():
        w.launches = 0
    for bf16 in (True, False):
        for seed in (0, 1, 2):
            args = {"model_parameters": MODEL_PARAMETERS,
                    "bf16_compute": bf16, "batch_size": BATCH,
                    "dataset_params": dict(DATA, seed=seed),
                    "jax_variables": jax_vars,
                    "output_path": str(out_dir / f"fp_{bf16}_{seed}.npy")}
            before = _counts()
            fp = inference(args)                       # on the card
            after = _counts()
            delta = {n: after[n] - before[n] for n in after}
            _check(delta == EXPECTED[bf16],
                   f"launches per forward {delta} != {EXPECTED[bf16]}")
            ref = inference(dict(args, output_path=str(
                out_dir / f"fp_cpu_{bf16}_{seed}.npy")), device="cpu")
            _check(fp.shape == (BATCH, MODEL_PARAMETERS["target_dim"]),
                   f"fingerprint shape {fp.shape}")
            _check(bool(np.isfinite(fp).all()), "non-finite fingerprints")
            rel = float(np.abs(fp - ref).max() / np.abs(ref).max())
            _check(rel <= SLICE_TOL[bf16],
                   f"card vs CPU {rel:.3g} > {SLICE_TOL[bf16]}")
            print(f"[slice] bf16={bf16} request seed={seed}: {fp.shape} "
                  f"max|ref|={np.abs(ref).max():.4g} card-vs-CPU rel "
                  f"{rel:.3g} (tol {SLICE_TOL[bf16]}); launches {delta}")
    launches = _counts()
    print(f"[slice] main-path launches: {launches}")
    return launches


def cuda_ms(fn, iters: int, warmup: int = 3) -> float:
    """Host-and-device rate: CUDA events around `iters` back-to-back calls
    (what a caller that issues them one after another sees)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


# ~50 ms at the H100's top SM clock: longer than the host takes to enqueue
# the timed calls, so none of the host's launch time falls inside the events
SLEEP_CYCLES = 100_000_000


def device_ms(fn, iters: int, warmup: int = 3, flush=None) -> float:
    """Device time per call: a sleep kernel holds the stream while the host
    enqueues the calls, so the events time their execution alone.  With
    `flush` (a 64 MB buffer), L2 is overwritten before each call, each call
    is timed alone, and the median is returned (cold-L2 time)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    if flush is None:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(SLEEP_CYCLES)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / iters
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(SLEEP_CYCLES // 10)
        flush.zero_()
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def phase_forward_time(g) -> dict:
    ms = {}
    for bf16 in (True, False):
        model = build_model({"model_parameters": MODEL_PARAMETERS,
                             "bf16_compute": bf16}, torch.device("cuda"))
        with torch.inference_mode():
            t = cuda_ms(lambda: model(g), iters=20)
        ms[bf16] = t
        print(f"[slice] forward bf16={bf16}: {t:.4f} ms, "
              f"{BATCH / t * 1e3:.1f} graphs/s (batch {BATCH}, CUDA events "
              f"over 20 warm forwards)")
    return ms


def phase_profile(g, fwd_ms: dict, n: int = 5):
    """Where a forward's time goes: torch.profiler's CUDA kernel records
    over `n` warm forwards -> device-busy ms per forward, the idle share of
    the CUDA-event forward time, kernels per forward, the top kernels."""
    from torch.profiler import DeviceType, ProfilerActivity, profile
    for bf16 in (True, False):
        model = build_model({"model_parameters": MODEL_PARAMETERS,
                             "bf16_compute": bf16}, torch.device("cuda"))
        with torch.inference_mode():
            for _ in range(3):
                model(g)
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                for _ in range(n):
                    model(g)
                torch.cuda.synchronize()
        by_name = {}
        for e in prof.events():
            if e.device_type == DeviceType.CUDA:
                us, cnt = by_name.get(e.name, (0.0, 0))
                by_name[e.name] = (us + e.time_range.elapsed_us(), cnt + 1)
        if not by_name:
            print(f"[profile] bf16={bf16}: the profiler recorded no device "
                  f"activity; not measured")
            continue
        busy = sum(us for us, _ in by_name.values()) / n / 1e3
        kernels = sum(c for _, c in by_name.values()) / n
        print(f"[profile] bf16={bf16}: device busy {busy:.4f} ms of "
              f"{fwd_ms[bf16]:.4f} ms per forward (idle share "
              f"{1 - busy / fwd_ms[bf16]:.3f}), {kernels:.0f} kernels per "
              f"forward")
        for kname in KERNEL_INFO:
            hits = [(us, c) for nm, (us, c) in by_name.items()
                    if f"{kname}_kernel" in nm]
            if hits:
                us, c = map(sum, zip(*hits))
                print(f"[profile]   {kname}: {us / c:.2f} us per launch in "
                      f"the forward, {c / n:.0f} launches per forward")
        top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:12]
        for name, (us, cnt) in top:
            print(f"[profile]   {us / n:9.2f} us/fwd  {cnt / n:5.0f}x  "
                  f"{name[:90]}")


def _bound(nbytes: float, flops: float):
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_F32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def phase_kernel_times(g, launches: dict, errs: dict) -> list:
    """Each kernel's main-path variant at the bench shapes: the bf16
    combine, the stats with the folded affine and no sum section (the
    flagship reads no sum), and the float32 multi-reduce."""
    N, E, D, K = g.num_nodes, g.senders.shape[0], WIDTH, g.max_deg
    e_real = int(g.csr_row_ptr[-1])
    gen = torch.Generator(device="cuda").manual_seed(1)
    bf = torch.bfloat16

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device="cuda")

    hd, hs, pe = randn(N, D).to(bf), randn(N, D).to(bf), randn(E, D).to(bf)
    xb = randn(E, D).to(bf)
    aff = (torch.rand(D, generator=gen, device="cuda") + 0.5, randn(D))
    xf = randn(E, D)
    rp = g.csr_row_ptr
    idx_bytes = 2 * E * 4
    cases = {
        # two gathered node arrays, pe and the output; 2 adds per element
        "edge_combine": (
            lambda: edge_combine(hd, hs, pe, g.receivers, g.senders),
            lambda: edge_combine_reference(hd, hs, pe, g.receivers,
                                           g.senders),
            2 * N * D * 2 + E * D * 2 + idx_bytes + E * D * 2,
            2.0 * E * D, "bf16"),
        # the real message rows, row_ptr, the affine, 5 bf16 sections out;
        # per message element: affine 2, sum 1, sumsq 2, max/min 2;
        # per output element ~8 (mean, var, sqrt, masks)
        "pna_stats": (
            lambda: pna_stats(xb, rp, K, aff, False),
            lambda: pna_stats_reference(xb, rp, K, aff, False),
            e_real * D * 2 + (N + 1) * 4 + 2 * D * 4 + 5 * N * D * 2,
            7.0 * e_real * D + 8.0 * N * D, "bf16, affine, no sum"),
        # the real message rows, row_ptr, 4 float32 sections out;
        # per message element: sum 1, sumsq 2, max/min 2
        "multi_reduce": (
            lambda: multi_reduce(xf, rp, K),
            lambda: multi_reduce_reference(xf, rp, K),
            e_real * D * 4 + (N + 1) * 4 + 4 * N * D * 4,
            5.0 * e_real * D, "float32"),
    }
    flush = torch.empty(64 * 2 ** 20, dtype=torch.uint8, device="cuda")
    rows = []
    for name, (kern, plain, nbytes, flops, variant) in cases.items():
        warm = device_ms(kern, iters=100, warmup=10)
        # the bound reads every input from device memory, so the kernel's
        # reported time is the cold-L2 one (warm inputs can sit in the 50 MB
        # L2 and beat the memory-rate bound)
        ms = device_ms(kern, iters=20, flush=flush)
        plain_ms = device_ms(plain, iters=10)
        host_ms = cuda_ms(kern, iters=100)
        bound_ms, bound_by = _bound(nbytes, flops)
        src, replaces = KERNEL_INFO[name]
        print(f"[times] {name} ({variant}): device {ms:.5f} ms cold-L2 "
              f"median, {warm:.5f} ms warm; back-to-back with the host's "
              f"launch {host_ms:.5f} ms; plain {plain_ms:.5f} ms; bound {bound_ms:.5f} ms by {bound_by} "
              f"({nbytes / 1e6:.2f} MB, {flops / 1e6:.1f} MFLOP f32; "
              f"H100 SXM peaks {PEAK_BYTES_PER_S / 1e12} TB/s, "
              f"{PEAK_F32_FLOPS / 1e12} TFLOP/s f32); no single PyTorch "
              f"call computes it, library_ms null")
        rows.append({"name": name, "route": "cuda", "source": src,
                     "replaces": replaces, "launches": launches[name],
                     "max_abs_err": errs[name], "ms": ms,
                     "plain_ms": plain_ms, "bound_ms": bound_ms,
                     "bound_by": bound_by, "library_ms": LIBRARY_MS})
    return rows


def main() -> int:
    smi = phase_device()
    phase_build()
    g = bench_batch()
    errs = phase_kernels(g)
    out_dir = Path(__file__).resolve().parent / "build" / "chip_smoke"
    out_dir.mkdir(parents=True, exist_ok=True)
    launches = phase_slice(out_dir)
    fwd_ms = phase_forward_time(g)
    phase_profile(g, fwd_ms)
    rows = phase_kernel_times(g, launches, errs)
    print(json.dumps({"kernels": rows}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
