"""Test settings of the benchmark's own tests (`bench_port/tests/`, run
apart from the repository's `tests/`):

    python -m pytest bench_port/tests -q -n 0            # the CPU tests
    python -m pytest bench_port/tests -q -n 0 -m card    # on the card

Tests marked `card` need a CUDA card and skip inside their fixture where
there is none."""
import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def pytest_configure(config):
    import torch
    torch.set_num_threads(2)     # a few test processes share the host
    config.addinivalue_line(
        "markers", "card: needs a CUDA card (skips without one)")


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)
