"""The port's benchmark: one cell, one run.

    python3 -m benchmark.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

A cell (``BENCHMARK.json``'s ``workloads``) names a configuration
(``configs/<name>.json``) and a traffic mix (``traffic/<name>.json``);
its output limits are ``limits/<cell>.json`` and each per-layer metric is
a reader in ``metrics/<stem>.py``, the stem being the metric's name up to
its first dot (``listener_roofline.w1024`` is read by
``listener_roofline.py``; an end-to-end metric's stem names the
quantity). Set-up makes the weights and the sound from the seed on the
card, writes the weights as the port's
artifact under ``TMPDIR``, loads it with ``Transcriber.from_artifact``
(greedy) and runs every call shape the mix's calls have once. The window
then calls ``transcribe_batch`` back to back (one client, a closed loop)
for ``--seconds``; with ``--trace 1`` under ``torch.profiler``. After it,
the transcriber is freed and the plain reference (``reference.py``)
judges a seeded sample of the utterances served, the longest among them:
the widest gap by which a served token's logit lies below the
reference's best, against the cell's limit.

The last line of standard output is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics``, ``device`` (and ``breakdown``
when traced), then ``counts`` and, last, ``checks`` (each number compared
with its limit, also the last lines of standard error). Without as many
CUDA cards as the cell asks for, it prints no result and exits 3.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import os  # noqa: E402

# one process with few threads: the host's share of a call is single-threaded
for _var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
    os.environ.setdefault(_var, "1")

import argparse  # noqa: E402
import contextlib  # noqa: E402
import gc  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import statistics  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
from pathlib import Path  # noqa: E402
from typing import Dict, List, NamedTuple, Optional  # noqa: E402

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "phones_las_tpu")
PAD_QUANTUM = 32000  # transcribe_batch's default


class Cell(NamedTuple):
    name: str
    config: dict
    mix: dict
    chips: int
    limits: dict
    end_to_end: List[dict]
    per_layer: List[dict]


def log(*a) -> None:
    print(*a, file=sys.stderr, flush=True)


def load_cell(name: str, root: Path = ROOT) -> Cell:
    """The cell's entry in ``BENCHMARK.json`` and its files, by name."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json (have {sorted(cells)})")
    wl = cells[name]
    entry = {c["name"]: c for c in bench["configs"]}[wl["config"]]
    config = json.loads((root / entry["file"]).read_text())
    mix = json.loads((BENCH / "traffic" / f"{wl['traffic']}.json").read_text())
    limits = json.loads((BENCH / "limits" / f"{name}.json").read_text())
    # a metric without ``workloads``: every cell (end to end), every cell
    # that reports the end-to-end metric it moves (per layer)
    e2e = [m for m in bench["end_to_end"] if name in m.get("workloads", [name])]
    e2e_names = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"]
                 if (name in m["workloads"] if "workloads" in m else m["moves"] in e2e_names)]
    return Cell(name, config, mix, int(wl["chips"]), limits, e2e, per_layer)


def cards_or_exit(chips: int) -> None:
    """No result without the cards the cell asks for: this measures the
    card and never falls back to the CPU."""
    import torch

    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if have < chips:
        log(f"benchmark: the cell needs {chips} CUDA card(s), this machine has {have}; no result")
        sys.exit(3)


def cache_dirs(root: Path = ROOT) -> None:
    """Every build and kernel cache inside the checkout, at fixed paths (the
    port's own CUDA library builds into ``phones_las_torch/csrc/build``)."""
    base = root / ".bench_cache"
    for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "cuda")):
        os.environ[var] = str(base / sub)


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is JAX's, jaxlib's, flax's or the
    JAX package's (the part before the first dot, compared whole)."""
    return sorted({m.split(".", 1)[0] for m in sys.modules} & set(FORBIDDEN))


def make_weights(cfg: dict, mix: dict, pool, seed: int, device) -> Dict:
    """The seeded weights, with CMVN statistics taken from the first call's
    utterances by the reference's front-end (what a corpus's stats give)."""
    import numpy as np
    import torch

    from benchmark import reference, weights

    w = weights.make_weights(cfg, seed, device)
    utts = pool.calls[0][: mix["cmvn_utterances"]]
    n = max(len(u) for u in utts)
    pcm = torch.zeros((len(utts), n), dtype=torch.float32)
    for i, u in enumerate(utts):
        pcm[i, : len(u)] = torch.from_numpy(u.astype(np.float32))
    lens = torch.tensor([len(u) for u in utts], dtype=torch.int64)
    w[".cmvn_mean"], w[".cmvn_std"] = reference.feature_stats(pcm.to(device), lens.to(device), cfg["frontend"])
    return w


def setup(cell: Cell, seed: int, device, parts: Optional[dict] = None):
    """→ (transcriber, pool): the weights written as the port's artifact
    and loaded back, and the run's calls. ``parts`` receives the seconds
    of each step and the artifact's bytes."""
    from benchmark import program, traffic

    parts = {} if parts is None else parts
    cfg, mix = cell.config, cell.mix
    t = time.perf_counter()

    def lap(name):
        nonlocal t
        now = time.perf_counter()
        parts[name] = now - t
        t = now

    pcfg = program.las_config(cfg, mix["numerics"])
    pool = traffic.make_pool(mix, seed, device)
    lap("sound_s")
    w = make_weights(cfg, mix, pool, seed, device)
    lap("weights_s")
    extras = {"preset": cfg["name"], "vocab": cfg["vocab"], "buckets": cfg["buckets"],
              "max_target_len": traffic.cap(mix), "step": 0}
    fd, path = tempfile.mkstemp(prefix="bench_artifact_", suffix=".npz")
    os.close(fd)
    try:
        program.write_artifact(path, w, pcfg, extras)
        del w
        lap("artifact_write_s")
        parts["artifact_bytes"] = os.path.getsize(path)
        tr = program.load(path, device, mix["max_device_batch"])
        lap("artifact_load_s")
    finally:
        os.remove(path)
    return tr, pool


def call_shapes(pool) -> List[int]:
    """Index of the first call of each padded length (the shapes to warm)."""
    from benchmark import traffic

    seen, first = set(), []
    for i, lens in enumerate(pool.lengths):
        key = (traffic.padded(max(lens), PAD_QUANTUM), len(lens))
        if key not in seen:
            seen.add(key)
            first.append(i)
    return first


def percentile(values: List[float], q: int) -> float:
    """The q-th percentile (Python's ``statistics.quantiles``, n = 100)."""
    if len(values) < 2:
        return values[0]
    return statistics.quantiles(values, n=100)[q - 1]


def window(tr, pool, seconds: float, trace: bool):
    """``transcribe_batch`` back to back for ``seconds`` (the call under way
    at the end is completed and counted) → (record of each call, wall
    seconds, profiler or None)."""
    import torch

    prof = None
    if trace:
        from torch.profiler import ProfilerActivity, profile

        prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
        prof.start()
    rng = torch.profiler.record_function if trace else (lambda name: contextlib.nullcontext())
    calls = []
    n = len(pool.calls)
    with rng("bench.window"):
        w0 = time.perf_counter()
        end = w0 + seconds
        i = 0
        while True:
            k = i % n
            a = time.perf_counter()
            try:
                with rng("bench.transcribe_batch"):
                    out, err = tr.transcribe_batch(pool.calls[k]), None
            except Exception as e:  # a failed call counts its utterances as failed
                out, err = None, f"{type(e).__name__}: {e}"
            b = time.perf_counter()
            calls.append({"pool": k, "out": out, "error": err, "s": b - a})
            i += 1
            if err is not None or b >= end:
                break
        w1 = time.perf_counter()
    if prof is not None:
        prof.stop()
    return calls, w1 - w0, prof


def choose_sample(calls: List[dict], pool, seed: int, k: int) -> List[tuple]:
    """(pool call, row) of ``k`` distinct utterances answered in the window,
    drawn from the seed, the longest first among them."""
    import numpy as np

    done = sorted({(c["pool"], r) for c in calls if c["out"] is not None for r in range(len(c["out"]))})
    if not done:
        return []
    rs = np.random.RandomState((int(seed) * 7919 + 17) % (1 << 32))
    longest = max(pool.lengths[p][r] for p, r in done)
    tops = [x for x in done if pool.lengths[x[0]][x[1]] == longest]
    first = tops[rs.randint(len(tops))]
    rest = [x for x in done if x != first]
    pick = [rest[i] for i in rs.choice(len(rest), size=min(k - 1, len(rest)), replace=False)] if rest else []
    return [first] + pick


class Judged(NamedTuple):
    """The sample's inputs, as the reference takes them."""

    sample: List[tuple]  # (pool call, row)
    pcm: object  # [n, S] float32 on the device
    lengths: object  # [n] samples
    tokens: object  # [n, cap] the ids served (<eos> past each row's length)
    served: List[int]  # tokens served a row
    unknown: int  # served strings that are no token of the vocabulary


def sample_inputs(cell: Cell, seed: int, pool, calls: List[dict], device) -> Judged:
    """The seeded sample of answered utterances, their sound and the ids of
    the tokens served."""
    import numpy as np
    import torch

    from benchmark import traffic

    cfg, mix = cell.config, cell.mix
    sample = choose_sample(calls, pool, seed, mix["check_rows"])
    answers = {}
    for c in calls:
        if c["out"] is not None:
            for r, toks in enumerate(c["out"]):
                answers.setdefault((c["pool"], r), toks)
    index = {t: i + 4 for i, t in enumerate(cfg["vocab"])}  # ids 4 on: after the specials
    cap, eos = traffic.cap(mix), cfg["speller"]["eos_id"]
    unknown = 0
    ids = np.full((len(sample), cap), eos, np.int64)
    served = []
    for j, key in enumerate(sample):
        toks = answers[key][:cap]
        row = [index.get(t, -1) for t in toks]
        unknown += sum(x < 0 for x in row) + (len(answers[key]) > cap)
        ids[j, : len(row)] = [x if x >= 0 else eos for x in row]
        served.append(len(row))
    lens = [pool.lengths[p][r] for p, r in sample]
    pcm = torch.zeros((len(sample), max(lens, default=1)), dtype=torch.float32)
    for j, (p, r) in enumerate(sample):
        pcm[j, : lens[j]] = torch.from_numpy(pool.calls[p][r].astype(np.float32))
    return Judged(sample, pcm.to(device), torch.tensor(lens, device=device), torch.from_numpy(ids).to(device),
                  served, unknown)


def gap_checks(cell: Cell, j: Judged, logits, tokens=None, unknown: Optional[int] = None) -> Dict[str, dict]:
    """The numbers compared for ``tokens`` ([n, cap] ids, the served ones
    by default) at the sample's positions, by the reference's ``logits``:
    the widest gap by which a token's logit lies below the best, and how
    many answers were not a run of known tokens (the served strings'
    count by default). The control's tokens are judged by this too."""
    from benchmark import reference, traffic

    eos, cap = cell.config["speller"]["eos_id"], traffic.cap(cell.mix)
    toks = j.tokens if tokens is None else tokens
    gaps = reference.served_gaps(logits, toks, j.served, eos)
    return {
        "rows_judged": {"value": len(j.sample), "limit": 1},
        "tokens_judged": {"value": int(sum(min(s + 1, cap) for s in j.served)), "limit": None},
        "unknown_tokens": {"value": int(j.unknown if unknown is None else unknown), "limit": 0},
        "logit_gap": {"value": float(gaps.max()), "limit": cell.limits["logit_gap"]},
    }


def judge(cell: Cell, seed: int, pool, calls: List[dict], device) -> Dict[str, dict]:
    """The reference over the sample: ``gap_checks`` of the served tokens."""
    from benchmark import reference

    j = sample_inputs(cell, seed, pool, calls, device)
    if not j.sample:
        return {"rows_judged": {"value": 0, "limit": 1}}
    w = make_weights(cell.config, cell.mix, pool, seed, device)
    return gap_checks(cell, j, reference.forward(j.pcm, j.lengths, j.tokens, w, cell.config))


def checks_pass(checks: Dict[str, dict]) -> bool:
    """``rows_judged`` at least its limit; every other number at most its own."""
    ok = checks["rows_judged"]["value"] >= checks["rows_judged"]["limit"]
    for name in ("unknown_tokens", "logit_gap", "failed"):
        if name in checks:
            ok &= checks[name]["value"] <= checks[name]["limit"]
    return bool(ok)


class TraceRun(NamedTuple):
    """What a per-layer metric's reader gets."""

    trace: object  # trace.Trace
    calls: int
    wall_s: float
    work: Dict[str, Dict[str, float]]  # counts.call summed over the calls
    precision: Dict[str, str]  # the precision each layer's kernels compute in
    peaks: dict

    def roofline_s(self, layer: str) -> float:
        from benchmark import counts

        prec = self.precision[layer]
        return counts.roofline_s(self.work[layer], self.peaks["flops_per_s"][prec], self.peaks["bytes_per_s"])


def stem(metric: str) -> str:
    """A metric's name up to its first dot: the quantity it reads."""
    return metric.split(".", 1)[0]


def read_metric(name: str, run: TraceRun):
    """The reader ``metrics/<stem>.py``'s ``read(run)``: a number, or None
    where it finds nothing to read."""
    name = stem(name)
    spec = importlib.util.spec_from_file_location(f"benchmark_metric_{name}", BENCH / "metrics" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read(run)


def run(cell: Cell, seed: int, seconds: float, trace: bool, device="cuda", t0: float = T0) -> dict:
    """One run of a cell → the result object (see the module's docstring)."""
    import torch

    from benchmark import counts, program, traffic
    from benchmark.trace import Trace

    cuda = str(device).startswith("cuda")
    torch.set_num_threads(1)
    parts = {"imports_s": time.perf_counter() - t0}
    tr, pool = setup(cell, seed, device, parts)
    t = time.perf_counter()
    for i in call_shapes(pool) + [0]:
        tr.transcribe_batch(pool.calls[i])
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    parts["warm_s"] = time.perf_counter() - t
    setup_s = time.perf_counter() - t0
    build_s = program.build_seconds()

    calls, wall, prof = window(tr, pool, seconds, trace)
    done = [c for c in calls if c["out"] is not None and len(c["out"]) == len(pool.calls[c["pool"]])]
    attempted = sum(len(pool.calls[c["pool"]]) for c in calls)
    failed = attempted - sum(len(c["out"]) for c in calls if c["out"] is not None)
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    kind = torch.cuda.get_device_name() if cuda else "cpu"
    loaded = forbidden_modules()
    if loaded:
        log(f"benchmark: modules {loaded} are loaded after the window; no result")
        sys.exit(4)
    errors = [c["error"] for c in calls if c["error"]]
    audio_s = sum(sum(pool.lengths[c["pool"]]) for c in done) / cell.mix["sample_rate"]
    call_ms = [1e3 * c["s"] for c in calls]

    result_metrics: Dict[str, dict] = {}
    device_rec = {"platform": "gpu" if cuda else "cpu", "kind": kind, "count": 1, "memory_peak_bytes": int(peak)}
    breakdown = None
    if trace:
        t = Trace.from_profiler(prof)
        del prof
        work: Dict[str, Dict[str, float]] = {}
        cap = traffic.cap(cell.mix)
        for c in done:
            lens = pool.lengths[c["pool"]]
            steps = min(cap, max(min(len(o) + 1, cap) for o in c["out"]))
            counts.add(work, counts.call(lens, [steps] * len(lens), cell.config))
        peaks = json.loads((BENCH / "peaks.json").read_text())
        tr_run = TraceRun(t, len(done), t.window_s, work, program.KERNEL_PRECISION[cell.mix["numerics"]], peaks)
        for m in cell.per_layer:
            v = read_metric(m["name"], tr_run) if done else None
            if v is not None:
                result_metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
        device_rec["busy_s"] = t.busy_s
        device_rec["window_s"] = t.window_s
        breakdown = t.breakdown()
    else:
        values = {
            "audio_per_s": audio_s / wall if done else None,
            "call_p90_ms": percentile(call_ms, 90) if call_ms else None,
            "setup_s": setup_s,
        }
        for m in cell.end_to_end:
            if values.get(stem(m["name"])) is not None:
                result_metrics[m["name"]] = {"value": float(values[stem(m["name"])]), "unit": m["unit"]}

    del tr
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    checks = {"failed": {"value": failed, "limit": 0}}
    t = time.perf_counter()
    checks.update(judge(cell, seed, pool, calls, device))
    judge_s = time.perf_counter() - t
    out = {
        "correct": checks_pass(checks) and not errors and bool(done),
        "attempted": attempted,
        "failed": failed,
        "metrics": result_metrics,
        "device": device_rec,
    }
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["counts"] = {
        "calls": len(calls), "utterances_done": sum(len(c["out"]) for c in done), "audio_s": audio_s,
        "window_s": wall, "call_ms_quartiles": statistics.quantiles(call_ms, n=4) if len(call_ms) > 1 else call_ms,
        "setup_s": setup_s, "build_s": build_s, "setup_parts": parts, "errors": errors[:3],
        "judge_s": judge_s, "pad_samples": sorted({traffic.padded(max(pool.lengths[c["pool"]]), PAD_QUANTUM) for c in calls}),
    }
    out["checks"] = checks
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cell = load_cell(args.workload)
    cache_dirs()
    cards_or_exit(cell.chips)
    res = run(cell, args.seed, args.seconds, bool(args.trace))
    log(f"correct: {res['correct']}")
    for name, c in res["checks"].items():
        log(f"check {name}: {c['value']} (limit {c['limit']})")
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
