"""Serving API layer (``api.py::Transcriber.transcribe_batch``): kernel
launches a call, counted in the device trace."""


def read(run):
    n = len(run.trace.kernels)
    return n / run.calls if n and run.calls else None
