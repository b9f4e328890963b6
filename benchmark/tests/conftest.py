"""The benchmark's own tests (CPU; ``python -m pytest benchmark/tests -q``)."""

import os
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

torch.set_num_threads(1)


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card; skips without one (decided inside the test)")
