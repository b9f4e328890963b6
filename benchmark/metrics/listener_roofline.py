"""Listener recurrence layer (``models/listener.py`` → ``ops/lstm.py`` →
``csrc/lstm.cu``): the recurrence kernels' share of their roofline, in %.
Operations: h @ wh, the gates and the cell at every valid step of both
directions of every layer (``counts.listener``), over the peak of the
precision the kernels compute in (``program.KERNEL_PRECISION`` of the mix's numerics);
bytes: the projected input read and the output written once a step, wh
once a call."""

STEMS = ("lstm_",)


def read(run):
    t = run.trace.kernel_seconds(STEMS)
    return 100.0 * run.roofline_s("listener") / t if t > 0 else None
