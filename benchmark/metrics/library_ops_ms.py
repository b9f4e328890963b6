"""Library ops layer: every device activity that is none of the port's
own kernels (cuBLAS projections and keys, the pyramid, Δ and CMVN,
copies to and from the card, fills, glue), device ms a
``transcribe_batch`` call."""

OWN = ("logmel_", "lstm_", "greedy_")


def read(run):
    t = run.trace.device_seconds(exclude=OWN)
    return 1e3 * t / run.calls if t > 0 and run.calls else None
