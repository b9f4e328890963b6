"""Model call layer (``api.py::Transcriber._decode_on``): the host's time
in ``encode`` and the decode (the spans ``plt.encode`` and ``plt.decode``:
the front-end's, listener's and decoder's operators dispatched and
launched), less what their child spans ``plt.decode.prep`` and
``plt.plan`` cover, ms a call."""

from benchmark.metrics._spans import overlap, union

OWN = ("plt.encode", "plt.decode")
CHILDREN = ("plt.decode.prep", "plt.plan")


def read(run):
    own = union([(a.start, a.end) for a in run.trace.host if a.name in OWN])
    if not own or not run.calls:
        return None
    children = union([(a.start, a.end) for a in run.trace.host if a.name in CHILDREN])
    t = sum(e - s for s, e in own) - overlap(own, children)
    return 1e3 * t / run.calls
