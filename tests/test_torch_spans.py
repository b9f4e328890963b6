"""The port's spans (``utils/diagnostics.py::annotate``) on the CPU: nothing
opened and nothing allocated while no profiler runs; under
``torch.profiler`` each span an operator-scope host event (``cpu_op``,
never a ``user_annotation``, which would put an event on the device's
timeline); ``Transcriber.transcribe_batch``'s stages nested in its root
span, wave by wave; and a ``plt.plan`` span a plan made, none on a cached
shape."""

import tracemalloc
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from phones_las_torch.utils import diagnostics
from phones_las_torch.utils.diagnostics import annotate
from tests.torch_threads import one_thread

one_thread()

SPANS = ("plt.transcribe_batch", "plt.stage", "plt.encode", "plt.decode", "plt.decode.prep", "plt.fetch",
         "plt.strings", "plt.plan")


def _events(prof):
    """(name, activity type, start ns, end ns) of every host event."""
    return [(e.name(), e.activity_type(), e.start_ns(), e.start_ns() + e.duration_ns())
            for e in prof.profiler.kineto_results.events()]


def _spans(prof):
    return sorted((e for e in _events(prof) if e[0].startswith("plt.")), key=lambda e: (e[2], -e[3]))


def _children(spans, root):
    """The spans whose innermost enclosing span is ``root``, in order."""
    def parent(s):
        around = [p for p in spans if p is not s and p[2] <= s[2] and s[3] <= p[3]]
        return min(around, key=lambda p: p[3] - p[2]) if around else None

    return [s for s in spans if parent(s) is root]


def test_annotate_off_opens_nothing_and_allocates_nothing(monkeypatch):
    def opened(name):
        raise AssertionError(f"a range {name!r} opened with no profiler running")

    monkeypatch.setattr(diagnostics, "_SPAN", opened)
    assert not torch._C._autograd._profiler_enabled()
    assert annotate("plt.stage") is annotate("plt.fetch")  # one shared null context

    def peak(span):  # the memory held past the start, and the peak over it
        tracemalloc.start()
        try:
            base, _ = tracemalloc.get_traced_memory()
            for _ in range(1000):
                with span("plt.stage"):
                    pass
            del _
            now, top = tracemalloc.get_traced_memory()
        finally:
            tracemalloc.stop()
        return now - base, top - base

    null = diagnostics._OFF
    peak(annotate)
    assert peak(annotate) == peak(lambda name: null)  # as the bare loop: nothing made a span
    assert peak(annotate)[0] == 0


@pytest.mark.parametrize("name", SPANS)
def test_a_span_is_a_host_operator_not_a_user_annotation(name):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function("bench.range"):
            with annotate(name):
                torch.ones(4) + 1
    ev = {e[0]: e for e in _events(prof)}
    assert ev["bench.range"][1] == "user_annotation"
    assert ev[name][1] == "cpu_op"
    outer, span, op = ev["bench.range"], ev[name], ev["aten::add"]
    assert outer[2] <= span[2] <= op[2] and op[3] <= span[3] <= outer[3]


@pytest.fixture(scope="module")
def transcriber(tmp_path_factory):
    """A tiny model's artifact served on the CPU, two utterances a wave."""
    from phones_las_torch.api import Transcriber
    from phones_las_torch.models.las import LASConfig, init_las
    from phones_las_torch.models.listener import ListenerConfig
    from phones_las_torch.models.speller import SpellerConfig
    from phones_las_torch.utils.param_io import save_params_npz

    cfg = LASConfig(listener=ListenerConfig(num_layers=2, units=8),
                    speller=SpellerConfig(vocab_size=8, embedding_dim=8, units=8, memory_dim=16,
                                          attention_units=8, attention_layer_size=8))
    path = str(tmp_path_factory.mktemp("spans") / "tiny.npz")
    save_params_npz(path, init_las(cfg, seed=3, device="cpu"), cfg,
                    extras={"vocab": ["a", "b", "c", "d"], "buckets": [16000], "max_target_len": 5})
    return lambda **kw: Transcriber.from_artifact(path, device="cpu", max_device_batch=2, **kw)


@pytest.mark.parametrize("beam", [0, 2])
def test_transcribe_batch_stages_nest_in_order(transcriber, beam):
    t = transcriber(beam_width=beam)
    rs = np.random.RandomState(5)
    clips = [(rs.randn(4000 + 900 * i) * 2000).astype(np.int16) for i in range(3)]  # waves of 2 and 1
    want = t.transcribe_batch(clips)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        got = t.transcribe_batch(clips)
    assert got == want
    spans = _spans(prof)
    roots = [s for s in spans if s[0] == "plt.transcribe_batch"]
    assert len(roots) == 1 and all(s[1] == "cpu_op" for s in spans)
    wave = ["plt.stage", "plt.encode", "plt.decode"]
    assert [s[0] for s in _children(spans, roots[0])] == wave * 2 + ["plt.fetch", "plt.strings"] * 2


def _decoder_plan():
    from phones_las_torch.decode import fused_greedy
    from phones_las_torch.models.speller import SpellerConfig

    fused_greedy._plan.cache_clear()
    return fused_greedy._plan.cache_clear, lambda: fused_greedy.decoder_plan(3, SpellerConfig(), 17)


def _listener_plan(kind, monkeypatch):
    from phones_las_torch.ops import lstm

    monkeypatch.setattr(torch.cuda, "get_device_properties", lambda i: SimpleNamespace(multi_processor_count=132))
    if kind == "forward":
        monkeypatch.setattr(lstm, "forward_plan", lambda *a, **k: ("forward", a[:4], k["sms"]))
        fn = lambda: lstm._card_forward_plan(3, 24, 2, "highest", False, 0)
        cached = lstm._card_forward_plan
    else:
        monkeypatch.setattr(lstm, "backward_plan", lambda *a, **k: ("backward", a[:4], k["sms"]))
        fn = lambda: lstm._card_backward_plan(3, 24, 2, "highest", 0)
        cached = lstm._card_backward_plan
    cached.cache_clear()
    return cached.cache_clear, fn


@pytest.mark.parametrize("which", ["decoder", "listener forward", "listener backward"])
def test_a_plan_span_on_a_new_shape_only(which, monkeypatch):
    clear, plan = _decoder_plan() if which == "decoder" else _listener_plan(which.split()[1], monkeypatch)
    try:
        with profile(activities=[ProfilerActivity.CPU]) as first:
            a = plan()
        with profile(activities=[ProfilerActivity.CPU]) as again:
            b = plan()
    finally:
        clear()  # the listener's plans were stand-ins
    assert a == b
    assert [s[0] for s in _spans(first)] == ["plt.plan"]
    assert _spans(again) == []
