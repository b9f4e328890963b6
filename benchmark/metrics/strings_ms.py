"""Serving API layer: each row's token ids to strings
(``data/vocab.py::decode``) in ``transcribe_batch``, the span
``plt.strings``, ms a call."""

from benchmark.metrics._spans import ms_a_call


def read(run):
    return ms_a_call(run, "plt.strings")
