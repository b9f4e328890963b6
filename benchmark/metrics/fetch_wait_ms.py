"""Device layer, as the host sees it: the host waiting in
``transcribe_batch`` for each wave's tokens and lengths to come back from
the card (``.cpu()``), the span ``plt.fetch``, ms a call."""

from benchmark.metrics._spans import ms_a_call


def read(run):
    return ms_a_call(run, "plt.fetch")
