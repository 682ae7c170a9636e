"""What `qmugs_c3_b500` reads does not move when the harness changes its
shape: the weights `make_weights` draws for `pretrain_qmugs`, at the tiny
widths of `tiny.py` and at the published ones, and the reference's record
of the tiny cell, both on the CPU, are bit for bit those of commit 450ff5a
(before the reference found its models, loss and schedule by name).

Each frozen digest was computed at that commit with this file's own
`_weights_digest` / `_record_digest` (SHA-256 over every tensor's name,
dtype, shape and bytes in the spec's order; over the record's losses,
first-gradient and change norms as JSON with sorted keys, then each
output's dtype, shape and bytes), seed 2**31 + 7, torch on the CPU with
2 threads (`conftest.py`); three runs, in processes with 2 and with 1
OpenMP thread, gave the same digests."""
import hashlib
import json

import numpy as np
import pytest
import torch

from bench_port import cell, manifest
from bench_port.tests.tiny import tiny_root
from bench_port.weights import make_weights

SEED = 2 ** 31 + 7
FROZEN = {
    "weights_tiny":
        "d6d3c0f8294ee4a2c7a9a7a898c6c62b64dbc933d402f38e88008ad9dae40e8c",
    "weights_published":
        "908cfbeb0e465c55cb0863c395fb26c89968866230ddc106b1b21f02c7af4027",
    "record_tiny":
        "9daa01d9a59a5520b8262de02f3a001da1bc098dc1ca87c7e8db905aa47b0892"}


def _weights_digest(weights) -> str:
    h = hashlib.sha256()
    for name, t in weights.items():
        t = t.detach().cpu().contiguous()
        h.update(f"{name}|{t.dtype}|{tuple(t.shape)}|".encode())
        h.update(t.numpy().tobytes())
    return h.hexdigest()


def _record_digest(record) -> str:
    h = hashlib.sha256()
    h.update(json.dumps({k: record[k] for k in ("losses", "grad", "change")},
                        sort_keys=True).encode())
    for o in record["outputs"]:
        h.update(str(o.dtype).encode() + str(o.shape).encode()
                 + np.ascontiguousarray(o).tobytes())
    return h.hexdigest()


def _config(root):
    from infomax3d_tpu_torch.cli.config import load_config
    return load_config(manifest.cell("qmugs_c3_b500", root).config_path)


@pytest.mark.parametrize("widths", ["tiny", "published"])
def test_weights_are_the_parents(tmp_path, widths):
    root = tiny_root(tmp_path) if widths == "tiny" else manifest.ROOT
    digest = _weights_digest(make_weights(_config(root), SEED, "cpu"))
    assert digest == FROZEN[f"weights_{widths}"]


def test_reference_record_is_the_parents(tmp_path):
    c = manifest.cell("qmugs_c3_b500", tiny_root(tmp_path))
    record = cell.reference_record(c, SEED, torch.device("cpu"))
    assert _record_digest(record) == FROZEN["record_tiny"]
