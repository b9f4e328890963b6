"""One torch intra-op thread for every process of the port's tests.

The suite runs in several pytest-xdist workers on a machine with a few
cores, and each worker holds torch's intra-op pool (one thread a core by
default) beside XLA's. The port's tests run small tensors, which the pool
does not speed up, so the pools only contend for the cores. Every
``tests/test_torch_*.py`` calls ``one_thread()`` after its imports, and the
subprocesses these tests start get ``subprocess_env()``.
``tests/test_torch_las.py::test_every_port_test_file_runs_one_thread``
checks the first rule.
"""

import os

import torch


def one_thread() -> None:
    torch.set_num_threads(1)


def subprocess_env(**extra: str) -> dict:
    """The environment for a subprocess of a port test: this one's, one
    OpenMP thread, and ``extra``."""
    return dict(os.environ, OMP_NUM_THREADS="1", **extra)
