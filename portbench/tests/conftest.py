"""The benchmark's tests: CPU tests at tiny sizes, and tests of what only a
card can show, marked ``card``, which skip without one (decided inside the
``cuda_card`` fixture, never while a module is imported).

    python -m pytest portbench/tests -q
"""

import os
import sys

import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs an NVIDIA card (skips without one)")


@pytest.fixture
def cuda_card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: TF32 and the kernels exist only there")
    return torch.device("cuda")
