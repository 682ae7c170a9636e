"""The control, the reference in the program's place with its matrix
operands in float8 (the precision below the configurations' bf16), fails
each cell's limits, at tiny widths on the CPU; on the chip at the cells'
own sizes `calibrate.py` reads it (PERF.md)."""
import pytest
import torch

from bench_port import cell, compare, manifest
from bench_port.reference.nn import bf16, fp8, mantissa
from bench_port.tests.tiny import tiny_root

CELLS = [w["name"] for w in manifest.load()["workloads"]]


@pytest.mark.parametrize("seed", [3, 4, 5])
@pytest.mark.parametrize("workload", CELLS)
def test_control_fails(tmp_path, workload, seed):
    c = manifest.cell(workload, tiny_root(tmp_path))
    dev = torch.device("cpu")
    ref = cell.reference_record(c, seed, dev)
    control = cell.reference_record(c, seed, dev, q=fp8)
    verdict = compare.judge(compare.readings(control, ref),
                            compare.load_limits(workload))
    assert not verdict["correct"], verdict["checks"]


def test_fp8_rounds_to_three_mantissa_bits():
    x = torch.tensor([1.0, 1.0625, 1.125, 448.0, -3.3])
    y = fp8(x)
    assert torch.equal(y[:4], torch.tensor([1.0, 1.0, 1.125, 448.0]))
    assert abs(float(y[4]) + 3.25) < 1e-6


def test_mantissa_seven_bits_is_bfloat16():
    x = torch.randn(4096, generator=torch.Generator().manual_seed(0)) * 40
    assert torch.equal(mantissa(7)(x), bf16(x))
