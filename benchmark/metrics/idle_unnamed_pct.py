"""Device layer: the share of the window's idle time on the card (no
kernel, copy or fill) in which the host was inside no span of the
program's stages (a ``plt.`` span other than the root
``plt.transcribe_batch``), in %. The gaps are intersected with the
spans, interval by interval."""

from benchmark.metrics._spans import ROOT, overlap, union


def read(run):
    spans = [a for a in run.trace.host if a.name.startswith("plt.")]
    if not any(a.name == ROOT for a in spans):
        return None
    gaps = [list(g) for g in run.trace.gaps()]
    idle = sum(e - s for s, e in gaps)
    if idle <= 0:
        return None
    named = union([(a.start, a.end) for a in spans if a.name != ROOT])
    return 100.0 * (idle - overlap(gaps, named)) / idle
