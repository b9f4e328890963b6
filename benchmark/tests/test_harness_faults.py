"""The check that decides ``correct``, shown to fail: the rest of a run
driven on the port's plain path (the look for a card skipped) with the
timed path broken underneath, once for each fault a served cell can have
(in the decoder, the serving API, the listener and the front-end), and
the control (the reference one precision lower) judged by the same check,
at a size a test run holds and, on a card, at each cell's own size."""

import functools

import pytest
import torch

from benchmark import control
from benchmark import run as R
from benchmark.tests.tiny import load, tiny_cell

SEED = 2**31 + 77
CELLS = [w["name"] for w in load("BENCHMARK.json")["workloads"]]


def _run(cell=None, device="cpu", seconds=0.5):
    return R.run(cell or tiny_cell(), SEED, seconds, False, device=device)


def _limit(cell):
    return load(f"benchmark/limits/{cell}.json")["logit_gap"]


def test_the_sound_path_is_correct():
    res = _run()
    assert res["correct"] is True
    assert res["checks"]["logit_gap"]["value"] <= 1e-4


def test_a_token_altered_where_it_is_produced(monkeypatch):
    import phones_las_torch.decode.greedy as G

    real = G.greedy_decode

    def altered(*a, **k):
        toks, lens, al = real(*a, **k)
        toks = toks.clone()
        toks[:, toks.shape[1] // 2] = 4 + (toks[:, toks.shape[1] // 2] - 3) % 30  # another character
        return toks, lens, al

    monkeypatch.setattr(G, "greedy_decode", altered)
    res = _run()
    assert res["correct"] is False
    assert res["checks"]["logit_gap"]["value"] > res["checks"]["logit_gap"]["limit"]


def test_a_decoder_step_that_returns_its_state_unchanged(monkeypatch):
    import phones_las_torch.decode.greedy as G

    real = G.speller_step

    def frozen(params, cfg, carry, *a, **k):
        _, logits, extras = real(params, cfg, carry, *a, **k)
        return carry, logits, extras

    monkeypatch.setattr(G, "speller_step", frozen)
    res = _run()
    assert res["correct"] is False
    assert res["checks"]["logit_gap"]["value"] > res["checks"]["logit_gap"]["limit"]


def test_half_of_the_batch_left_out(monkeypatch):
    from phones_las_torch.api import Transcriber

    real = Transcriber.transcribe_batch

    def half(self, audio, **k):
        return real(self, list(audio)[: max(1, len(audio) // 2)], **k)

    monkeypatch.setattr(Transcriber, "transcribe_batch", half)
    res = _run()
    assert res["correct"] is False
    assert res["failed"] > 0 and res["checks"]["failed"]["value"] == res["failed"]


def test_answers_cut_short(monkeypatch):
    """Rows that end early are judged on the <eos> they imply."""
    from phones_las_torch.api import Transcriber

    real = Transcriber.transcribe_batch

    def short(self, audio, **k):
        return [toks[: len(toks) // 2] for toks in real(self, audio, **k)]

    monkeypatch.setattr(Transcriber, "transcribe_batch", short)
    res = _run()
    assert res["correct"] is False


def _backward_direction_left_out(monkeypatch):
    import phones_las_torch.ops.lstm as L

    real = L.bidir_recurrence

    @functools.wraps(real)  # with the launch counters the kernel's wrapper keeps
    def one_way(*a, **k):
        out_f, out_b, st_f, st_b = real(*a, **k)
        return out_f, torch.zeros_like(out_b), st_f, st_b

    monkeypatch.setattr(L, "bidir_recurrence", one_way)


def _cmvn_left_out(monkeypatch):
    import phones_las_torch.models.las as M

    monkeypatch.setattr(M, "apply_cmvn", lambda feats, mean, std: feats)


def _features_a_frame_late(monkeypatch):
    import phones_las_torch.models.las as M

    real = M.featurize

    @functools.wraps(real)
    def late(*a, **k):
        feats, flens = real(*a, **k)
        return torch.cat([feats[:, :1], feats[:, :-1]], dim=1), flens

    monkeypatch.setattr(M, "featurize", late)


ENCODER_FAULTS = {
    "listener_backward_direction_left_out": _backward_direction_left_out,
    "cmvn_left_out": _cmvn_left_out,
    "features_a_frame_late": _features_a_frame_late,
}


@pytest.mark.parametrize("fault", sorted(ENCODER_FAULTS))
def test_a_fault_in_the_listener_or_the_front_end(monkeypatch, fault):
    """At 160 tokens: a frame's shift flips no token of 36."""
    ENCODER_FAULTS[fault](monkeypatch)
    res = _run(tiny_cell(cap=40, batch=4, check_rows=4))
    assert res["correct"] is False
    assert res["checks"]["logit_gap"]["value"] > res["checks"]["logit_gap"]["limit"]


@pytest.mark.parametrize("cell", CELLS)
def test_the_control_fails_the_check_that_the_program_passes(cell):
    """The reference one precision below the mode's (TF32 for parity; fp8
    recurrent dots and bf16 elsewhere for production) puts tokens first
    that the run's own check, at the cell's limit, finds not correct."""
    traffic = next(w["traffic"] for w in load("BENCHMARK.json")["workloads"] if w["name"] == cell)
    tcell = tiny_cell(traffic, limit=_limit(cell), cap=40, batch=4, check_rows=4)
    rec = control.readings(tcell, 2**31 + 3, 0.0, device="cpu")  # one call: 4 rows
    assert rec["rows"] == 4 and rec["tokens"] == 160 and rec["unknown_tokens"] == 0
    assert rec["program_correct"] is True and rec["control_correct"] is False
    assert rec["control"] > rec["limit"] >= rec["program"]


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the cell's own size runs only there")


@pytest.mark.card
@pytest.mark.parametrize("cell", CELLS)
def test_the_control_at_each_cells_size_on_the_card(cell):
    """The control at the cell's own size, on the card (the chip command
    ``python3 -m benchmark.control`` reads it on a dozen seeds)."""
    _card()
    rec = control.readings(R.load_cell(cell), 2**31 + 99, 1.0)
    assert rec["program_correct"] is True and rec["control_correct"] is False


@pytest.mark.card
@pytest.mark.parametrize("fault", sorted(ENCODER_FAULTS))
@pytest.mark.parametrize("cell", CELLS)
def test_a_listener_or_front_end_fault_at_each_cells_size_on_the_card(monkeypatch, cell, fault):
    _card()
    ENCODER_FAULTS[fault](monkeypatch)
    res = _run(R.load_cell(cell), device="cuda", seconds=1.0)
    assert res["correct"] is False
