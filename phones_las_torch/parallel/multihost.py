"""Multi-process set-up and data sharding (port of
``phones_las_tpu/parallel/multihost.py``).

Every rank is one process that runs the same program.
``initialize_distributed`` wires the ``torch.distributed`` process group
(the counterpart of ``jax.distributed.initialize``); under ``--multihost``
each process feeds its own slice of the epoch plan
(``DataSource(shard=(data index, data ranks))``, ``shard_plan``) and
takes its local rows as they are (``Mesh.local_batches``): the global
batch is data ranks × the per-process batch. Without a process group the
same code runs the 1 × 1 mesh.
"""

from __future__ import annotations

import datetime
import os
from typing import Optional

import torch
import torch.distributed as dist

# a rank that dies leaves the others waiting in a collective: they give up after this
TIMEOUT = datetime.timedelta(minutes=10)


def initialize_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    backend: Optional[str] = None,
) -> bool:
    """Join the process group. Explicit arguments win; otherwise the
    torch launcher's environment (``MASTER_ADDR``/``MASTER_PORT``,
    ``WORLD_SIZE``, ``RANK``) applies. ``coordinator_address`` is
    ``host:port`` or an init-method URL (``tcp://...``, ``file://...``).
    ``backend=None`` means ``nccl`` on a machine with CUDA, else ``gloo``;
    ranks that share one card need ``gloo``, asked for by name. → True
    when a process group was initialised, False when nothing is
    configured (one process: the 1 × 1 mesh)."""
    if coordinator_address is None and os.environ.get("MASTER_ADDR"):
        coordinator_address = f"{os.environ['MASTER_ADDR']}:{os.environ.get('MASTER_PORT', '29500')}"
    if num_processes is None and os.environ.get("WORLD_SIZE"):
        num_processes = int(os.environ["WORLD_SIZE"])
    if process_id is None and os.environ.get("RANK"):
        process_id = int(os.environ["RANK"])
    if coordinator_address is None and num_processes is None:
        return False
    if coordinator_address is None or num_processes is None or process_id is None:
        raise ValueError(
            "a process group needs an address, a world size and a rank: got "
            f"{coordinator_address!r}, {num_processes!r}, {process_id!r}"
        )
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    init = coordinator_address if "://" in coordinator_address else f"tcp://{coordinator_address}"
    dist.init_process_group(backend, init_method=init, world_size=num_processes, rank=process_id,
                            timeout=TIMEOUT)
    return True


def shard_plan(plans: list, index: int, count: int) -> list:
    """Deterministic per-process slice of an epoch's batch plan.

    At every global step all processes must run the same bucket shape, so
    batches are grouped by bucket and each group of ``count`` consecutive
    same-bucket batches becomes one global step (process ``index`` takes
    the group's ``index``-th batch). Steps come in the order each group
    completes in the canonical shuffled plan, not sorted by bucket, which
    would impose a shortest-first curriculum every epoch. All processes
    compute the identical full plan from the shared shuffle seed, so no
    coordination is needed. Per bucket, ``len % count`` leftover batches
    are dropped."""
    if not 0 <= index < count:
        raise ValueError(f"process index {index} is outside [0, {count})")
    by_bucket: dict = {}
    order = []  # (bucket, group_idx) in canonical completion order
    for plan in plans:
        group = by_bucket.setdefault(plan[0], [])
        group.append(plan)
        if len(group) % count == 0:
            order.append((plan[0], len(group) // count - 1))
    return [by_bucket[b][g * count + index] for b, g in order]
