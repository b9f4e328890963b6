"""Serving API layer (``api.py::Transcriber.transcribe_batch``): the host's
staging of each wave (padding the rows into one array, the copy to the
card), the span ``plt.stage``, ms a call."""

from benchmark.metrics._spans import ms_a_call


def read(run):
    return ms_a_call(run, "plt.stage")
