"""Greedy decoder layer (``decode/fused_greedy.py::_launch``): the host's
own work before each launch of the decoder kernel (the plan, float32
casts, padding, column slices, keys, the pointer table, the workspace),
the spans ``plt.decode.prep`` less the CUDA runtime's waiting calls inside
them (``_spans.WAITS``: the pointer table's copy from pageable memory
waits for the listener still queued), ms a call. The wait is the card's
time, not the prep's."""

from benchmark.metrics._spans import WAITS, overlap, union


def read(run):
    prep = union([(a.start, a.end) for a in run.trace.host if a.name == "plt.decode.prep"])
    if not prep or not run.calls:
        return None
    waits = union([(a.start, a.end) for a in run.trace.host if a.name.startswith(WAITS)])
    t = sum(e - s for s, e in prep) - overlap(prep, waits)
    return 1e3 * t / run.calls
