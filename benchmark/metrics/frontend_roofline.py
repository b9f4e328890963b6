"""Front-end + CMVN layer (``models/las.py::featurize`` →
``frontend/fused_frontend.py`` → ``csrc/frontend.cu``): the log-mel
kernel's share of its roofline, in %. The least time is the larger of the
log-mel's operations (a real FFT a frame, power, the mel filters'
non-zeros, the log; ``counts.frontend``) over the float32 peak and its
bytes (the signal read once, log-mel and energy written) over the
memory's; the time is the device time of the kernels named below."""

STEMS = ("logmel_",)


def read(run):
    t = run.trace.kernel_seconds(STEMS)
    return 100.0 * run.roofline_s("frontend") / t if t > 0 else None
