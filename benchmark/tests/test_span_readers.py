"""The readers of the program's spans (``metrics/<stem>.py`` over the
trace's host events named ``plt.*``) on hand-built traces: each reads its
hand-worked value, reads nothing on a trace without the program's spans
(a program that opens none), and the spans leave every other reader's
value as it was. On a card: a traced window of a cell carries the spans
as host operations and none on the device."""

import json
import os

import pytest
import torch

from benchmark import run as R
from benchmark.tests.tiny import ROOT, load
from benchmark.trace import Activity, Trace

SPAN_STEMS = ("stage_ms", "dispatch_ms", "decoder_prep_ms", "fetch_wait_ms", "strings_ms", "idle_unnamed_pct",
              "prep_copies_per_call")
OTHER_STEMS = sorted({R.stem(m["name"]) for m in load("BENCHMARK.json")["per_layer"]} - set(SPAN_STEMS))
CELLS = [w["name"] for w in load("BENCHMARK.json")["workloads"]]

DEVICE = [  # busy 0.9-2.0, 2.4-3.2, 5.5-6.5, 6.8-7.7 of a 10 s window
    Activity("Memcpy HtoD (Pageable -> Device)", "gpu_memcpy", 0.9, 1.0),
    Activity("void (anonymous namespace)::logmel_kernel(A)", "kernel", 1.0, 1.2),
    Activity("void (anonymous namespace)::lstm_fwd_kernel<256>(A)", "kernel", 1.2, 2.0),
    Activity("void (anonymous namespace)::greedy_kernel(A)", "kernel", 2.4, 3.2),
    Activity("void (anonymous namespace)::logmel_kernel(A)", "kernel", 5.5, 5.7),
    Activity("void (anonymous namespace)::lstm_fwd_kernel<256>(A)", "kernel", 5.7, 6.5),
    Activity("void (anonymous namespace)::greedy_kernel(A)", "kernel", 6.8, 7.7),
]
HARNESS = [Activity("bench.window", "user_annotation", 0.0, 10.0),
           Activity("bench.transcribe_batch", "user_annotation", 0.5, 4.5),
           Activity("bench.transcribe_batch", "user_annotation", 5.0, 9.5),
           Activity("aten::mm", "cpu_op", 1.05, 1.1)]
SPANS = [  # two calls; the first makes two plans, one inside the decoder's prep
    ("plt.transcribe_batch", 0.5, 4.5), ("plt.stage", 0.6, 1.0), ("plt.encode", 1.0, 2.0), ("plt.plan", 1.2, 1.3),
    ("plt.decode", 2.0, 3.0), ("plt.decode.prep", 2.1, 2.4), ("plt.plan", 2.2, 2.3), ("plt.fetch", 3.0, 3.5),
    ("plt.strings", 3.5, 4.4),
    ("plt.transcribe_batch", 5.0, 9.5), ("plt.stage", 5.1, 5.5), ("plt.encode", 5.5, 6.5),
    ("plt.decode", 6.5, 7.5), ("plt.decode.prep", 6.6, 6.8), ("plt.fetch", 7.5, 8.0), ("plt.strings", 8.0, 9.0),
]
OPS = [  # the host's operators and runtime calls, with or without the spans
    Activity("cudaMemcpyAsync", "cpu_op", 0.7, 0.9), Activity("aten::copy_", "cpu_op", 1.5, 1.6),
    # the first call's prep: a concatenation (a copy nested in it), a copy,
    # the pointer table's copy waiting in the runtime
    Activity("aten::cat", "cpu_op", 2.11, 2.14), Activity("aten::copy_", "cpu_op", 2.12, 2.13),
    Activity("aten::copy_", "cpu_op", 2.15, 2.16),
    Activity("aten::copy_", "cpu_op", 2.30, 2.36), Activity("cudaMemcpyAsync", "cpu_op", 2.31, 2.35),
    # the second's: a copy, a synchronisation
    Activity("aten::copy_", "cpu_op", 6.62, 6.63), Activity("cudaStreamSynchronize", "cpu_op", 6.70, 6.75),
]
# by hand, over 2 calls: idle is 0.9 + 0.4 + 2.3 + 0.3 + 2.3 = 6.2 s, of
# which the stages (0.6-4.4 and 5.1-9.0) cover 0.3 + 0.4 + 1.6 + 0.3 + 1.3
WANT = {
    "stage_ms": 1e3 * (0.4 + 0.4) / 2,
    "dispatch_ms": 1e3 * (4.0 - 0.1 - 0.3 - 0.2) / 2,  # the nested plan counted once
    "decoder_prep_ms": 1e3 * (0.3 - 0.04 + 0.2 - 0.05) / 2,  # less the runtime's waits
    "fetch_wait_ms": 1e3 * (0.5 + 0.5) / 2,
    "strings_ms": 1e3 * (0.9 + 1.0) / 2,
    "idle_unnamed_pct": 100.0 * (6.2 - 3.9) / 6.2,
    "prep_copies_per_call": (3 + 1) / 2,  # outside the prep and nested copies not counted
}


def _run(spans=True, host=()):
    ev = [Activity(n, "cpu_op", s, e) for n, s, e in SPANS] if spans else []
    trace = Trace(DEVICE, HARNESS + OPS + ev + list(host), (0.0, 10.0))
    with open(os.path.join(ROOT, "benchmark", "peaks.json")) as f:
        peaks = json.load(f)
    work = {layer: {"flops": 1e9, "bytes": 1e8} for layer in ("frontend", "listener", "decoder", "model")}
    return R.TraceRun(trace, 2, trace.window_s, work, {"frontend": "float32", "listener": "bf16",
                                                       "decoder": "float32"}, peaks)


@pytest.mark.parametrize("stem", SPAN_STEMS)
def test_each_span_reader_reads_its_hand_worked_value(stem):
    assert R.read_metric(stem, _run()) == pytest.approx(WANT[stem], rel=1e-9)


@pytest.mark.parametrize("stem", SPAN_STEMS)
def test_a_program_without_spans_reads_nothing(stem):
    assert R.read_metric(stem, _run(spans=False)) is None


def test_a_window_without_plans_copies_or_waits():
    """No plan: the dispatch as the spans give it. A prep that copies
    nothing reads 0 copies, and with no wait in it its whole span."""
    run = _run()
    run.trace.host[:] = [a for a in run.trace.host if a.name != "plt.plan"]
    assert R.read_metric("dispatch_ms", run) == pytest.approx(1e3 * (4.0 - 0.3 - 0.2) / 2, rel=1e-9)
    run.trace.host[:] = [a for a in run.trace.host if a.name not in ("aten::copy_", "aten::cat")
                         and not a.name.startswith("cuda")]
    assert R.read_metric("prep_copies_per_call", run) == 0.0
    assert R.read_metric("decoder_prep_ms", run) == pytest.approx(1e3 * (0.3 + 0.2) / 2, rel=1e-9)


def test_the_idle_share_intersects_and_does_not_take_midpoints():
    """A gap of 2.0-4.0 whose first quarter is a stage's: 75 % unnamed,
    where the gap's middle alone would call it all unnamed."""
    dev = [Activity("void k(A)", "kernel", 0.0, 2.0), Activity("void k(A)", "kernel", 4.0, 6.0)]
    host = [Activity("bench.window", "user_annotation", 0.0, 6.0),
            Activity("plt.transcribe_batch", "cpu_op", 0.0, 6.0), Activity("plt.strings", "cpu_op", 1.5, 2.5)]
    run = R.TraceRun(Trace(dev, host, (0.0, 6.0)), 1, 6.0, {}, {}, {})
    assert R.read_metric("idle_unnamed_pct", run) == pytest.approx(75.0, rel=1e-9)


@pytest.mark.parametrize("stem", OTHER_STEMS)
def test_the_spans_leave_every_other_reader_as_it_was(stem):
    without = R.read_metric(stem, _run(spans=False))
    assert without is not None
    assert R.read_metric(stem, _run()) == without


def test_the_spans_leave_the_device_breakdown_as_it_was():
    assert _run().trace.breakdown()["device_ops"] == _run(spans=False).trace.breakdown()["device_ops"]


@pytest.mark.card
def test_a_traced_window_carries_the_spans_on_the_host_alone():
    """The 3 x 256 cell for a second, traced: every stage's span a host
    operation, none on the device, and the kernels a call as many as in a
    window whose spans are turned off."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels and the device trace run only there")
    from phones_las_torch.utils import diagnostics

    cell = R.load_cell(CELLS[0])
    tr, pool = R.setup(cell, 2**31 + 5, "cuda")
    for i in R.call_shapes(pool) + [0]:
        tr.transcribe_batch(pool.calls[i])
    torch.cuda.synchronize()

    def window():
        calls, _, prof = R.window(tr, pool, 1.0, True)
        return Trace.from_profiler(prof), len(calls)

    t, n = window()
    assert not [a.name for a in t.device if a.name.startswith("plt.")]
    names = {a.name for a in t.host if a.name.startswith("plt.")}
    assert names == {"plt.transcribe_batch", "plt.stage", "plt.encode", "plt.decode", "plt.decode.prep",
                     "plt.fetch", "plt.strings"}
    assert all(a.kind == "cpu_op" for a in t.host if a.name.startswith("plt."))
    off = diagnostics._SPAN
    try:
        diagnostics._SPAN = lambda name: diagnostics._OFF
        t_off, n_off = window()
    finally:
        diagnostics._SPAN = off
    assert not [a for a in t_off.host if a.name.startswith("plt.")]
    assert len(t.kernels) / n == len(t_off.kernels) / n_off
