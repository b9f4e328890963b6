"""Model call layer: the whole call's share of the card's dense bf16 peak,
in %. Operations: the algorithm's for every utterance completed in the
window at its own length and the decode steps run (``counts.call``'s
'model': front-end, Δ and CMVN, projections, recurrences, keys, decoder),
over the traced window's wall time."""


def read(run):
    if not run.calls or run.wall_s <= 0:
        return None
    peak = run.peaks["flops_per_s"][run.peaks["mfu_peak"]]
    return 100.0 * run.work["model"]["flops"] / run.wall_s / peak
