"""Tests of the benchmark's harness.  They run on the CPU, where the
program's plain twin stands in for the kernel; a test that needs the card
takes the ``cuda`` fixture, which skips without one."""
import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def pytest_configure(config):
    import torch

    torch.set_num_threads(2)  # several workers share the CPU
    config.addinivalue_line("markers", "card: needs a CUDA device; skips without one")


@pytest.fixture
def cuda():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (torch sees none)")
    return torch.device("cuda")


@pytest.fixture
def small_mix():
    """A mix small enough for the CPU: a few thousand photons, one warm-up
    window."""
    return dict(min_photons=1500, max_photons=3000, warmup_windows=1, trace_windows=1,
                sync_windows=1)


@pytest.fixture
def fault_mix():
    """A mix large enough on the CPU for the statistics to see the altered
    fault (|z| ~15 at 16k photons): 12k-24k photons."""
    return dict(min_photons=12000, max_photons=24000, warmup_windows=1, trace_windows=1,
                sync_windows=1)
