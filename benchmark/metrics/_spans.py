"""What the span readers share: the program's spans (``plt.*``, host
events of the traced window) and sets of intervals on the trace's clock."""

from bisect import bisect_left, bisect_right

ROOT = "plt.transcribe_batch"
# the CUDA runtime's calls in which the host waits for the card's queue
# (a copy from pageable memory waits for the stream before it starts)
WAITS = ("cudaMemcpy", "cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaEventSynchronize")


def seconds(run, names) -> float:
    """Summed time of the host events named one of ``names``."""
    return sum(a.end - a.start for a in run.trace.host if a.name in names)


def ms_a_call(run, name):
    """A span's summed time, ms a call; nothing where the window has none."""
    t = seconds(run, (name,))
    return 1e3 * t / run.calls if t > 0 and run.calls else None


def union(spans):
    """(start, end) pairs → sorted, disjoint intervals covering them."""
    out = []
    for s, e in sorted(spans):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def overlap(a, b) -> float:
    """The length of the intersection of two sorted, disjoint lists of intervals."""
    i = j = 0
    tot = 0.0
    while i < len(a) and j < len(b):
        tot += max(0.0, min(a[i][1], b[j][1]) - max(a[i][0], b[j][0]))
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return tot


def outermost_within(spans, events):
    """The ``events`` inside each of ``spans`` that lie inside no other of
    them (a copy made inside a concatenation counts once), all spans'."""
    events = sorted(events, key=lambda a: (a.start, -a.end))
    starts = [a.start for a in events]
    out = []
    for sp in spans:
        end = sp.start  # the end of the last outermost event taken
        for a in events[bisect_left(starts, sp.start):bisect_right(starts, sp.end)]:
            if a.end <= sp.end and a.start >= end:
                out.append(a)
                end = a.end
    return out
