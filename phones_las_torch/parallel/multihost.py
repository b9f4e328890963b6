"""Multi-process data sharding (port of the pure-Python part of
``phones_las_tpu/parallel/multihost.py``): ``shard_plan``, which the
``DataSource`` uses under ``shard=``. The process-group set-up and the
sharded batches wait for the port's multi-device slice."""

from __future__ import annotations


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
