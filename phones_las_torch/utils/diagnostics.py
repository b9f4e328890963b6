"""Observability and sanitizer hooks (port of
``phones_las_tpu/utils/diagnostics.py``).

* tracing: ``torch.profiler`` in place of ``jax.profiler``, a Chrome
  trace of the host's operators and the card's kernels written under
  ``logdir``, plus spans around the serving path's stages (``annotate``);
* the sanitizer: autograd's anomaly mode (a backward that produces NaN
  raises and names the forward operation) in place of ``jax_debug_nans``,
  and a host-side finite check over named leaves.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Iterator

import numpy as np
import torch


@contextlib.contextmanager
def profile_trace(logdir: str) -> Iterator[torch.profiler.profile]:
    """Profile the host and, when a card is present, its kernels; write a
    Chrome trace (``trace_<time>.json``, readable in Perfetto or
    ``chrome://tracing``) under ``logdir`` on exit.

    Usage::

        with profile_trace("runs/t1/profile"):
            for _ in range(10):
                trainer.train_step(batch)
    """
    os.makedirs(logdir, exist_ok=True)
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(logdir, f"trace_{time.strftime('%Y%m%d_%H%M%S')}.json"))


_PROFILING = torch._C._autograd._profiler_enabled
_SPAN = torch._C._profiler._RecordFunctionFast
_OFF = contextlib.nullcontext()


def annotate(name: str):
    """A span: a named range over the work inside it, seen by a running
    ``torch.profiler`` (``profile_trace``, the benchmark's traced window)
    as a host operation on the profiler's own clock, nested in the ranges
    and operators around it. It is an operator-scope range
    (``RecordFunctionFast``), never a user-scope one, so it puts no event
    on the device's timeline, and it pushes no NVTX range. While no
    profiler runs it costs one check and allocates nothing. The port's
    spans are named ``plt.<stage>``; ``benchmark/metrics`` reads them.

    Usage::

        with annotate("plt.encode"):
            memory, _, enc_mask = encode(...)
    """
    return _SPAN(name) if _PROFILING() else _OFF


def enable_nan_checks(enable: bool = True) -> None:
    """The sanitizer: autograd's anomaly mode, process-wide (each backward
    is checked for NaN and names the forward operation at fault; debug
    only, it slows every step)."""
    torch.autograd.set_detect_anomaly(enable)


def assert_all_finite(leaves, name: str = "tree") -> None:
    """Host-side finite check → raises ``FloatingPointError`` naming the
    first non-finite leaf. ``leaves`` is an ``nn.Module`` (its parameters
    and buffers), a mapping of names to tensors or arrays, or nested
    lists, tuples and mappings of them."""
    for path, leaf in _named(leaves, ""):
        arr = leaf.detach().cpu().numpy() if isinstance(leaf, torch.Tensor) else np.asarray(leaf)
        if not np.isfinite(arr).all():
            raise FloatingPointError(f"non-finite values in {name}{path}")


def _named(x, prefix: str):
    if isinstance(x, torch.nn.Module):
        for k, t in list(x.named_parameters()) + list(x.named_buffers()):
            yield f"{prefix}.{k}", t
    elif isinstance(x, dict):
        for k, v in x.items():
            yield from _named(v, f"{prefix}[{k!r}]")
    elif isinstance(x, (list, tuple)):
        for i, v in enumerate(x):
            yield from _named(v, f"{prefix}[{i}]")
    elif x is not None:
        yield prefix, x
