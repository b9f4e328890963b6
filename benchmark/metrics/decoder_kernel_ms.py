"""Greedy decoder layer: the decoder kernels' device time, ms a
``transcribe_batch`` call."""

STEMS = ("greedy_",)


def read(run):
    t = run.trace.kernel_seconds(STEMS)
    return 1e3 * t / run.calls if t > 0 and run.calls else None
