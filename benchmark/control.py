"""The readings a cell's output limit is set from, several seeds in one process.

    python3 -m benchmark.control --workload <name> --seeds 11,12,... [--seconds 3] [--out FILE]

For each seed it runs the cell as ``run.py`` does (set-up from the seed,
the timed path for a short window at the cell's own load), frees the
transcriber, and reads over the seeded sample of answered utterances:

- ``program``: the widest gap by which a served token's logit lies below
  the reference's best (what a run's check compares): the lower reading,
  and ``program_correct``, the run's verdict on it;
- ``control``: the same prompts and tokens through the reference computed
  one precision below the numerics mode (``CONTROLS``); the tokens it puts
  first at each position go through the very check a run makes
  (``run.gap_checks`` → ``run.checks_pass``): the widest gap, the upper
  reading, and ``control_correct``, which has to come out false.

The benchmark's runs never run this. One JSON line a seed goes to
standard output (and to ``--out``).
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402

# the nearest precision below each mode's: parity is float32 with TF32 off,
# so TF32; production runs the recurrent dots in bf16 and the other
# products in TF32, so fp8 and bf16
CONTROLS = {
    "parity": {"frontend": "tf32", "proj": "tf32", "rec": "tf32", "dec": "tf32"},
    "production": {"frontend": "bf16", "proj": "bf16", "rec": "fp8", "dec": "bf16"},
}


def readings(cell, seed: int, seconds: float, device="cuda") -> dict:
    """One seed's program and control readings (see the module's docstring)."""
    import torch

    from benchmark import reference
    from benchmark import run as R

    t0 = time.perf_counter()
    tr, pool = R.setup(cell, seed, device)
    for i in R.call_shapes(pool):
        tr.transcribe_batch(pool.calls[i])
    setup_s = time.perf_counter() - t0
    calls, _, _ = R.window(tr, pool, seconds, False)
    answered = sum(len(c["out"]) for c in calls if c["out"] is not None)
    failed = {"failed": {"value": sum(len(pool.calls[c["pool"]]) for c in calls) - answered, "limit": 0}}
    del tr
    gc.collect()
    if str(device).startswith("cuda"):
        torch.cuda.empty_cache()
    j = R.sample_inputs(cell, seed, pool, calls, device)
    w = R.make_weights(cell.config, cell.mix, pool, seed, device)
    t1 = time.perf_counter()
    exact = reference.forward(j.pcm, j.lengths, j.tokens, w, cell.config)
    ref_s = time.perf_counter() - t1
    eos = cell.config["speller"]["eos_id"]
    prog = R.gap_checks(cell, j, exact)
    low = reference.forward(j.pcm, j.lengths, j.tokens, w, cell.config,
                            reference.Numerics(**CONTROLS[cell.mix["numerics"]]))
    picks = low.argmax(-1)
    ctrl = R.gap_checks(cell, j, exact, tokens=picks, unknown=0)
    rows = {k: reference.served_gaps(exact, t, j.served, eos) for k, t in (("program", j.tokens), ("control", picks))}
    flips = int((exact.argmax(-1) != picks).sum())
    return {
        "workload": cell.name, "seed": seed, "program": prog["logit_gap"]["value"],
        "control": ctrl["logit_gap"]["value"], "limit": cell.limits["logit_gap"],
        "program_correct": R.checks_pass({**failed, **prog}), "control_correct": R.checks_pass({**failed, **ctrl}),
        "program_rows": [float(x) for x in rows["program"]], "control_rows": [float(x) for x in rows["control"]],
        "control_flips": flips, "tokens": int(sum(j.served)), "unknown_tokens": j.unknown,
        "rows": len(j.sample), "calls": len(calls), "setup_s": setup_s, "reference_s": ref_s,
        "logit_std": float(exact[..., 4:].std()),
    }


def main(argv=None) -> int:
    from benchmark import run as R

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated")
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    cell = R.load_cell(args.workload)
    R.cache_dirs()
    R.cards_or_exit(cell.chips)
    for s in (int(x) for x in args.seeds.split(",")):
        rec = readings(cell, s, args.seconds)
        line = json.dumps(rec)
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
