"""A checkout root for tests on the CPU: `BENCHMARK.json` with each
configuration cut to widths a test run holds (hidden 16 / 8, depth 2,
batch 8, a log every 2 steps, no TensorBoard)."""
import json
import os
import re

from bench_port import manifest

CUTS = ((r"(?m)^  hidden_dim: 200$", "  hidden_dim: 16"),
        (r"(?m)^  readout_hidden_dim: 200$", "  readout_hidden_dim: 16"),
        (r"(?m)^  propagation_depth: 7$", "  propagation_depth: 2"),
        (r"(?m)^  target_dim: 256$", "  target_dim: 32"),
        (r"(?m)^  hidden_dim: 20$", "  hidden_dim: 8"),
        (r"(?m)^  readout_hidden_dim: 20$", "  readout_hidden_dim: 8"),
        (r"(?m)^batch_size: 500$", "batch_size: 8"),
        (r"(?m)^log_iterations: 50$", "log_iterations: 2"))


def tiny_root(dst) -> str:
    bench = manifest.load()
    for c in bench["configs"]:
        with open(os.path.join(manifest.ROOT, c["file"])) as f:
            text = f.read()
        for pattern, repl in CUTS:
            text = re.sub(pattern, repl, text)
        c["file"] = os.path.basename(c["file"])
        with open(os.path.join(dst, c["file"]), "w") as f:
            f.write(text + "use_tensorboard: False\n")
    with open(os.path.join(dst, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)
    return str(dst)
