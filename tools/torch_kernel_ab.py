#!/usr/bin/env python3
"""The port's CSR kernels measured in two trees of the repository on one
card: the three small CSR walks, rows 1 (`multi_reduce`), 3
(`csr_segment_sum`) and 4 (`snd_segment_sum`); rows 5
(`pair_segment_sum`) and 6 (`edge_combine`) at the bench and
multi-conformer shapes; and row 7 (`csr_sum`) at the GIN and
multi-conformer shapes.

    python3 tools/torch_kernel_ab.py PARENT_ROOT CHANGE_ROOT [SUMMARY_JSON]
        [--extra ROOT ...]
    python3 tools/torch_kernel_ab.py --variant rows4|rows8 SOURCE_ROOT DEST

The first form runs, in the order parent, each extra tree, change, change,
each extra tree in reverse, parent, and each in a process of its own, that
tree's `chip_smoke.py` phases 1 to 3, 7, 11 and 14 and phase 18a at the
QMugs conformer batch (the kernels built and held against their plain
versions); then the OT step of phase 15 (`ot()`, float32) timed by CUDA
events over 10 warm steps and profiled over 3 (kernels and device time per
step, each port kernel's mean device time per launch in the step); then
the bf16 GIN step of phase 12 (OGBGNN 5x300, batch 128) timed over 20 warm
steps and profiled over 5 (row 7's and row 4's mean device time per launch
in the step); then the QMugs bf16 multi-conformer step of phase 18 (PNA
200x7 and the flat Net3D on 500 drug-size molecules with 3 conformers
each) timed and profiled as the OT step (busy ms, kernels per step, rows
5, 6 and 7's 3D launch in the step); then each row alone: rows 1, 3 and 4
at the OT shape (float32, D = 50), row 3 also in bf16 there, rows 1 and 3
at the bench shape (float32, D = 200), rows 3 (bf16), 4 and 7 (float32
and bf16) at the GIN shape (D = 300), rows 5 and 6 at the bench shape
(bf16 and float32, D = 200), rows 5, 6, 7 and 3 (row 7's control: the
same sum from device memory, stored in bf16) at the QMugs conformer shape
in bf16 (D = 20) and row 7 there in float32: cold-L2 and warm device
times (CUDA events) and the mean device time in a profile of 50
back-to-back launches; where the tree has it, a plain read of row 7's
QMugs rows (`read_probe`, bf16 and float32 sizes) the same way; then the
tree's phase 16c (the launch floor and the ladder of the OT step's
walks).  Each run also prints the order of global loads (L), shared loads
(l), asynchronous and bulk copies (A, T), float ops (F), stores (S) and
branches (b) in the SASS of every instantiation in the five kernels'
libraries (`csr_sum` holds rows 7 and 3).  Each run's numbers end in one
JSON line; the summary, with each run's printed lines (the SASS orders
only there), goes to SUMMARY_JSON (default
`CHANGE_ROOT/build/kernel_ab.json`).  Needs one CUDA card; the kernels of
each tree build into that tree's `build/`.

The second form writes DEST, a copy of SOURCE_ROOT (without `build/` and
`chiprun_out/`) whose row 7 takes, on its long-range path, the walk of
row 3 (`walk_rows` from device memory at U = 4 or 8 slots a chunk, one
thread per node and column vector, blocks of 256) with a float32 store in
place of the staged tile: the first design step of row 7's redesign, to
be measured as an extra tree.
"""
from __future__ import annotations

import functools
import glob
import json
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

# the kernel libraries whose SASS is read: rows 1, 4, 7 with 3, 6 and 5
LIBRARIES = ("multi_reduce", "snd_segment_sum", "csr_sum", "edge_combine",
             "pair_segment_sum")
STEP_KERNELS = ("multi_reduce", "snd_segment_sum", "csr_segment_sum")
CONF_KERNELS = ("pair_segment_sum", "edge_combine", "csr_sum")
# (shape, dtype name, rows) of the alone times
CASES = (("OT", "float32", ("multi_reduce", "csr_segment_sum",
                            "snd_segment_sum")),
         ("OT", "bfloat16", ("csr_segment_sum",)),
         ("bench", "float32", ("multi_reduce", "csr_segment_sum")),
         ("GIN", "float32", ("snd_segment_sum", "csr_sum")),
         ("GIN", "bfloat16", ("snd_segment_sum", "csr_segment_sum",
                              "csr_sum")),
         ("bench", "bfloat16", ("pair_segment_sum", "edge_combine")),
         ("bench", "float32", ("pair_segment_sum", "edge_combine")),
         ("QMugs", "bfloat16", CONF_KERNELS + ("csr_segment_sum",)),
         ("QMugs", "float32", ("csr_sum",)))


def _sass_orders(name: str) -> dict:
    """{instantiation: the order of its first 40 loads / float ops /
    stores / branches} of kernel library `name` (cuobjdump -sass)."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    lib = glob.glob(f"build/infomax3d_tpu_torch/{name}-*.so")
    if not lib or not os.path.exists(tool):
        return {}
    sass = subprocess.run([tool, "-sass", lib[0]], capture_output=True,
                          text=True, timeout=120).stdout
    orders = {}
    for fn in re.split(r"\n\s*Function : ", sass)[1:]:
        head, body = fn.split("\n", 1)
        toks = []
        for line in body.splitlines():
            if "LDGSTS" in line:
                toks.append("A")
            elif "UBLKCP" in line:
                toks.append("T")
            elif "LDG" in line:
                toks.append("L")
            elif re.search(r"\bLDS\b", line):
                toks.append("l")
            elif re.search(r"\b(FADD|FSEL|FMNMX|FMUL)\b", line):
                toks.append("F")
            elif "STG" in line:
                toks.append("S")
            elif re.search(r"\bBRA\b", line):
                toks.append("b")
        orders[head.strip()[-48:]] = "".join(toks)[:40]
    return orders


def one(root: str) -> dict:
    """One tree's measurements (run in a process of its own)."""
    root = str(Path(root).resolve())
    sys.path.insert(0, root)
    os.chdir(root)
    import torch
    from torch.profiler import ProfilerActivity, profile
    import chip_smoke as cs
    from infomax3d_tpu_torch.ops.kernels import (csr_segment_sum, csr_sum,
                                                 edge_combine, multi_reduce,
                                                 pair_segment_sum,
                                                 snd_segment_sum)
    from infomax3d_tpu_torch.train.ot import ot
    from infomax3d_tpu_torch.train.pretrain import build_step

    smi = cs.phase_device()
    cs.phase_build()
    sass = {n: _sass_orders(n) for n in LIBRARIES}
    for n, orders in sass.items():
        for fn, order in orders.items():
            print(f"[ab] sass {n} {fn}: {order}")
    g = cs.bench_batch()
    gg, _ = cs.gin_batch()
    ob, _ = cs.ot_slice_batch()
    g2q, g3q, _ = cs.conformer_batch(cs.CONF_QMUGS, "cpu")
    g2q, g3q = g2q.to("cuda"), g3q.to("cuda")
    cs.phase_kernels(g)
    cs.phase_train_kernels(g)
    cs.phase_gin_kernels(gg)
    cs.phase_ot_kernels(ob, g)
    cs.phase_conf_kernels(cs.CONF_QMUGS, g2q, g3q)

    out = ot(cs._ot_args(), steps=2)
    step, batch = out["step"], out["batch"]
    seeds = iter(range(5000, 6000))

    def one_step():
        step.step(batch, torch.Generator("cuda").manual_seed(next(seeds)))

    step_ms = cs.cuda_ms(one_step, iters=10)
    n = 3
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            one_step()
        torch.cuda.synchronize()
    by_name = cs._profile_kernels(prof)
    ported = cs._port_kernels(by_name)
    in_step = {k: us / c / 1e3 for k, (us, c) in ported.items()}
    del out, step, batch

    gin = cs.build_supervised_step(cs._gin_args(True), torch.device("cuda"))
    gp = gin.prepare(cs.gin_batch("cpu")[0])
    gin_ms = cs.cuda_ms(lambda: gin.step(gp), iters=20)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(5):
            gin.step(gp)
        torch.cuda.synchronize()
    gin_in_step = {k: us / c / 1e3 for k, (us, c) in
                   cs._port_kernels(cs._profile_kernels(prof)).items()}
    print("[ab] GIN bf16 step " + f"{gin_ms:.4f} ms; in the step " + ", ".join(
        f"{k} {v:.6f} ms" for k, v in sorted(gin_in_step.items())))
    del gin, gp

    conf = build_step(cs._conf_args(True, cs.CONF_QMUGS),
                      torch.device("cuda"))
    ca, cb = conf.prepare(g2q, g3q)
    conf_ms = cs.cuda_ms(lambda: conf.step(ca, cb), iters=10)
    conf_prof = cs._conf_profile(conf, ca, cb, conf_ms, "QMugs bf16 step")
    del conf, ca, cb
    torch.cuda.empty_cache()

    def profiled(fn, names, reps=50):
        """Mean device ms per launch of the kernels whose names contain one
        of `names` in a profile of `reps` back-to-back calls; a profile
        that recorded none of them (it happens) is taken again, up to three
        times."""
        for _ in range(3):
            for _ in range(5):
                fn()
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as p:
                for _ in range(reps):
                    fn()
                torch.cuda.synchronize()
            rec = [v for k, v in cs._profile_kernels(p).items()
                   if any(nd in k for nd in names)]
            if rec:
                return (sum(us for us, _ in rec) / sum(c for _, c in rec)
                        / 1e3)
        return None

    def fmt(ms):
        return "not measured" if ms is None else f"{ms:.5f}"

    gen = torch.Generator(device="cuda").manual_seed(11)
    flush = torch.empty(64 * 2 ** 20, dtype=torch.uint8, device="cuda")
    shapes = {"OT": (ob.graph, cs.OT_WIDTH), "bench": (g, cs.WIDTH),
              "GIN": (gg, cs.GIN_WIDTH), "QMugs": (g3q, cs.CONF_WIDTH)}
    calls = {
        "multi_reduce": lambda x, h, gr: multi_reduce(x, gr.csr_row_ptr,
                                                      gr.max_deg),
        "csr_segment_sum": lambda x, h, gr: csr_segment_sum(x,
                                                            gr.csr_row_ptr),
        "snd_segment_sum": lambda x, h, gr: snd_segment_sum(
            x, gr.csc_row_ptr, gr.csc_perm),
        "csr_sum": lambda x, h, gr: csr_sum(x, gr.csr_row_ptr),
        "pair_segment_sum": lambda x, h, gr: pair_segment_sum(
            x, gr.csr_row_ptr, gr.csc_row_ptr, gr.csc_perm),
        "edge_combine": lambda x, h, gr: edge_combine(
            h[0], h[1], x, gr.receivers, gr.senders)}
    times = []
    for shape, dname, rows in CASES:
        gr, D = shapes[shape]
        dt = getattr(torch, dname)
        x = torch.randn(gr.senders.shape[0], D, generator=gen,
                        device="cuda").to(dt)
        h = [torch.randn(gr.num_nodes, D, generator=gen,
                         device="cuda").to(dt) for _ in range(2)]
        for row in rows:
            fn = functools.partial(calls[row], x, h, gr)
            rec = {"shape": shape, "row": row, "dtype": str(dt), "D": D,
                   "cold_ms": cs.device_ms(fn, iters=20, flush=flush),
                   "warm_ms": cs.device_ms(fn, iters=100, warmup=10),
                   "alone_ms": profiled(fn, cs.PROFILE_NAMES[row])}
            times.append(rec)
            print(f"[ab] {row} at the {shape} shape ({dt}, D={D}): cold-L2 "
                  f"{rec['cold_ms']:.5f} ms, warm {rec['warm_ms']:.5f} ms, "
                  f"alone in a profile {fmt(rec['alone_ms'])} ms")

    if hasattr(cs, "_read_ms"):     # a plain read of row 7's messages
        e_real = int(g3q.csr_row_ptr[-1])
        for dname, size in (("bfloat16", 2), ("float32", 4)):
            cold, warm = cs._read_ms(e_real * cs.CONF_WIDTH * size, flush)
            times.append({"shape": "QMugs", "row": "read_probe",
                          "dtype": f"torch.{dname}", "D": cs.CONF_WIDTH,
                          "cold_ms": cold, "warm_ms": warm,
                          "alone_ms": None})
            print(f"[ab] read_probe of row 7's QMugs {dname} rows: cold-L2 "
                  f"{cold:.5f} ms, warm {warm:.5f} ms")

    cs.phase_launch_floor(ob, {k: 0 for k in cs.NONE}, in_step)
    return {"tree": root, "card": smi, "ot_step_ms": step_ms,
            "kernels_per_ot_step": sum(c for _, c in by_name.values()) / n,
            "busy_ms_per_ot_step": sum(us for us, _ in by_name.values())
            / n / 1e3,
            "in_step_ms": {k: in_step.get(k) for k in STEP_KERNELS},
            "gin_step_ms": gin_ms,
            "gin_in_step_ms": {k: gin_in_step.get(k)
                               for k in ("csr_sum", "snd_segment_sum")},
            "conf_step_ms": conf_ms,
            "kernels_per_conf_step": conf_prof.get("kernels"),
            "busy_ms_per_conf_step": conf_prof.get("busy_ms"),
            "conf_in_step_ms": {k: conf_prof.get("in_step", {}).get(k)
                                for k in CONF_KERNELS},
            "times": times, "sass": sass}


# the first design step of row 7's redesign (`--variant`): the long-range
# path's kernel keeps its name and arguments but walks the rows from device
# memory as row 3 does, U slots a chunk, one thread per (node, column
# vector) in blocks of WALK_THREADS, and stores float32
ROWS_KERNEL = """template <typename T, int VEC, typename Idx>
__global__ void __launch_bounds__(WALK_THREADS)
csr_sum_stream_kernel(const T* __restrict__ msg,
                      const int* __restrict__ row_ptr, float* __restrict__ out,
                      int N, int E, int D, int tn) {
  int n, c;
  if (!node_column<Idx, VEC>(N, D, n, c)) return;
  const int start = row_ptr[n];
  float acc[VEC];
#pragma unroll
  for (int k = 0; k < VEC; ++k) acc[k] = 0.f;
  auto add = [&](const float (&v)[VEC], bool valid) {
#pragma unroll
    for (int k = 0; k < VEC; ++k)
      acc[k] = __fadd_rn(acc[k], valid ? v[k] : 0.f);
  };
  walk_rows<T, VEC, UNROLL, false, Idx>(msg, D, c, nullptr, start,
                                        row_ptr[n + 1] - start, add);
  store_vec<float, VEC>(out + static_cast<int64_t>(n) * D + c, acc);
}
"""


def variant(kind: str, source: str, dest: str):
    """DEST: SOURCE's tree with row 7's long-range path on `walk_rows` at
    U = 4 (`rows4`) or 8 (`rows8`)."""
    unroll = {"rows4": 4, "rows8": 8}[kind]
    shutil.rmtree(dest, ignore_errors=True)
    shutil.copytree(source, dest, ignore=lambda d, names: [
        n for n in names if n in ("build", "chiprun_out", ".git")])
    cu = Path(dest) / "infomax3d_tpu_torch" / "csrc" / "csr_sum.cu"
    text = cu.read_text()
    head = ("template <typename T, int VEC, typename Idx>\n__global__ void "
            "__launch_bounds__(STREAM_THREADS)\ncsr_sum_stream_kernel(")
    a = text.index(head)
    b = text.index("\n}\n", a) + 3
    text = (text[:a] + ROWS_KERNEL.replace("UNROLL", str(unroll))
            + text[b:])
    for old, new in (
            ("const dim3 grid(static_cast<unsigned>((N + tn - 1) / tn));",
             "const dim3 grid(walk_blocks(items));"),
            ("<<<grid, tn * nvec, 0, st>>>", "<<<grid, WALK_THREADS, 0, st>>>")):
        assert old in text, old
        text = text.replace(old, new)
    cu.write_text(text)


def main(argv) -> int:
    if len(argv) == 3 and argv[1] == "--one":
        print(json.dumps(one(argv[2])))
        return 0
    if len(argv) == 5 and argv[1] == "--variant":
        variant(*argv[2:])
        return 0
    extra = [argv[i + 1] for i, a in enumerate(argv[:-1]) if a == "--extra"]
    args = [a for i, a in enumerate(argv)
            if a != "--extra" and (i == 0 or argv[i - 1] != "--extra")]
    if len(args) not in (3, 4):
        print(__doc__)
        return 2
    parent, change = args[1:3]
    summary = Path(args[3] if len(args) == 4
                   else Path(change) / "build" / "kernel_ab.json")
    order = ([("parent", parent)] + [("extra", r) for r in extra]
             + [("change", change)] * 2
             + [("extra", r) for r in reversed(extra)] + [("parent", parent)])
    runs = []
    for tag, root in order:
        print(f"[ab] === {tag}: {root}", flush=True)
        proc = subprocess.run([sys.executable, __file__, "--one", root],
                              capture_output=True, text=True, timeout=1200)
        log = [line for line in proc.stdout.splitlines()
               if line.startswith(("[ab]", "[floor]", "NVIDIA"))]
        print("\n".join(line for line in log
                        if not line.startswith("[ab] sass")), flush=True)
        if proc.returncode != 0:
            print(proc.stdout[-6000:])
            print(proc.stderr[-6000:])
            return proc.returncode
        runs.append(dict(json.loads(proc.stdout.strip().splitlines()[-1]),
                         tag=tag, log=log))
    for r in runs:
        t = {(x["row"], x["shape"], x["dtype"]): x for x in r["times"]}
        print(f"[ab] {r['tag']} {r['tree']}: OT step {r['ot_step_ms']:.4f} "
              f"ms, {r['kernels_per_ot_step']:.1f} kernels and "
              f"{r['busy_ms_per_ot_step']:.4f} ms busy per step; in the "
              "step " + ", ".join(
                  f"{k} {'not measured' if v is None else f'{v:.6f}'} ms"
                  for k, v in r["in_step_ms"].items()) + "; GIN bf16 step "
              f"{r['gin_step_ms']:.4f} ms, in the step " + ", ".join(
                  f"{k} {'not measured' if v is None else f'{v:.6f}'} ms"
                  for k, v in r["gin_in_step_ms"].items()) + "; QMugs bf16 "
              f"step {r['conf_step_ms']:.4f} ms, "
              f"{r['kernels_per_conf_step']} kernels and "
              f"{r['busy_ms_per_conf_step']} ms busy per step; in the step "
              + ", ".join(
                  f"{k} {'not measured' if v is None else f'{v:.6f}'} ms"
                  for k, v in r["conf_in_step_ms"].items()) + "; cold / warm / "
              "alone " + ", ".join(
                  f"{row} {shape} {dt.split('.')[-1]} {x['cold_ms']:.5f} / "
                  f"{x['warm_ms']:.5f} / {x['alone_ms']} ms"
                  for (row, shape, dt), x in t.items()) + f"; {r['card']}")
    summary.parent.mkdir(parents=True, exist_ok=True)
    summary.write_text(json.dumps(runs, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
