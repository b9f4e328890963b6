"""Device layer: the share of the traced window in which no kernel, copy
or fill ran on the card, in %."""


def read(run):
    w = run.trace.window_s
    return 100.0 * (1.0 - run.trace.busy_s / w) if w > 0 and run.trace.device else None
