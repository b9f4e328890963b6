"""The port's serving API (plain PyTorch, CPU) against the JAX reference:
the pause segmenter, cut finder and window merge; and
``Transcriber.from_artifact`` on the committed long-regime artifact
(monotonic attention, CTC head) decoding synthetic utterances of its
language greedily, with beam 8 and with beam 8 + joint CTC, long-form
with and without stream CMVN, with timestamps, and in forced alignment."""

import os

import numpy as np
import pytest
import torch

from phones_las_tpu import api as japi
from phones_las_tpu.data.speechlike import (
    make_phonotactics,
    speechlike_phone_inventory,
    synth_speech_utterance,
)
from phones_las_tpu.data.vocab import Vocab as JaxVocab

from phones_las_torch import api
from phones_las_torch.data.vocab import Vocab
from tests.torch_threads import one_thread

one_thread()

ASSET = os.path.join(os.path.dirname(__file__), "goldens", "long_gate.npz")
SR = 16000


@pytest.fixture(scope="module")
def utterances():
    """Two 9 s-class utterances of the artifact's language, as the
    long-regime gate synthesizes them, and an 18.5 s stream of 60
    syllables."""
    vocab = JaxVocab(speechlike_phone_inventory())
    lang = make_phonotactics(1234)
    rng = np.random.RandomState(9001)
    utts = [
        synth_speech_utterance(rng, vocab, f"gate-{i}", model=lang, n_syllables_range=(22, 28),
                               word_syllables=(1, 3), snr_db_range=(8.0, 30.0))
        for i in range(2)
    ]
    stream = synth_speech_utterance(np.random.RandomState(9002), vocab, "stream", model=lang,
                                    n_syllables_range=(60, 60), word_syllables=(1, 3),
                                    snr_db_range=(10.0, 30.0))
    return [u.audio for u in utts], stream.audio, [vocab.decode(u.targets) for u in utts]


def _speechy(seed=0, seconds=12.0):
    """Noise bursts with pauses of varying width, float32."""
    rs = np.random.RandomState(seed)
    x = []
    while sum(len(s) for s in x) < seconds * SR:
        x.append((rs.randn(int(rs.uniform(0.2, 0.9) * SR)) * 3000).astype(np.float32))
        x.append((rs.randn(int(rs.uniform(0.02, 0.3) * SR)) * rs.uniform(5, 60)).astype(np.float32))
    return np.concatenate(x)


@pytest.mark.parametrize("window_s,search_s", [(3.0, 0.6), (2.0, 0.9), (4.5, 0.3)])
def test_pause_cuts_match_jax(window_s, search_s):
    audio = _speechy()
    win, search = int(window_s * SR), int(search_s * SR)
    np.testing.assert_array_equal(api._smoothed_energy(audio, 160, 5), japi._smoothed_energy(audio, 160, 5))
    cuts = api.find_pause_cuts(audio, SR, win, search)
    assert cuts == japi.find_pause_cuts(audio, SR, win, search)
    assert len(cuts) > 3
    # streaming: a suffix buffer with lookahead picks the offline cuts
    seg, ref = api.PauseSegmenter(SR, win, search), japi.PauseSegmenter(SR, win, search)
    assert (seg.margin, seg.max_segment) == (ref.margin, ref.max_segment)
    prev = cuts[1]
    total = prev + win + search + seg.margin
    base = (prev // seg.f) * seg.f
    got = seg.next_cut(audio[base:total], base, prev, total, ended=False)
    assert got == ref.next_cut(audio[base:total], base, prev, total, ended=False) == cuts[2]
    with pytest.raises(ValueError):
        api.PauseSegmenter(SR, win, win // 2)


def test_merge_window_hypotheses_matches_jax():
    rs = np.random.RandomState(3)
    starts = [0, 30000, 60000, 90000]
    per_window = []
    for s0 in starts:
        times = np.sort(rs.uniform(0, 40000, 12)) + s0
        per_window.append((rs.randint(4, 26, 12), times))
    for overlap in (10000, 4000):
        assert api.merge_window_hypotheses(per_window, starts, overlap) == \
            japi.merge_window_hypotheses(per_window, starts, overlap)


def test_vocab_copy_matches_jax(tmp_path):
    toks = ["a", "b", "ʃ", "<eos>", "e"]
    v, jv = Vocab(toks), JaxVocab(toks)
    assert v.tokens == jv.tokens and len(v) == len(jv)
    ids = [0, 1, 4, 5, 2, 6, 99 % len(v)]
    assert v.decode(ids) == jv.decode(ids) and v.decode(ids, strip_specials=False) == jv.decode(ids, strip_specials=False)
    assert v.encode(["a", "zz", "e"]) == jv.encode(["a", "zz", "e"])
    v.save(str(tmp_path / "v.txt"))
    assert JaxVocab.load(str(tmp_path / "v.txt")).tokens == v.tokens


MODES = {
    "greedy": {},
    "beam8": {"beam_width": 8},
    "beam8_ctc": {"beam_width": 8, "ctc_joint": 0.7},
}


@pytest.mark.parametrize("mode", list(MODES))
def test_transcribe_batch_matches_jax(utterances, mode):
    """The long-gate artifact on the two gate utterances: the port's tokens
    equal the JAX Transcriber's (beam and greedy differ here, and so does
    the joint CTC beam)."""
    audio, _, refs = utterances
    kw = MODES[mode]
    got = api.Transcriber.from_artifact(ASSET, device="cpu", **kw).transcribe_batch(audio)
    want = japi.Transcriber.from_artifact(ASSET, **kw).transcribe_batch(audio)
    assert got == want
    assert [len(r) for r in refs] == [59, 48]
    assert [len(h) for h in got] == {"greedy": [57, 48], "beam8": [53, 48], "beam8_ctc": [59, 48]}[mode]


@pytest.mark.parametrize("adapt", [False, True])
def test_transcribe_long_matches_jax(utterances, adapt):
    _, stream, _ = utterances
    t = api.Transcriber.from_artifact(ASSET, device="cpu")
    jt = japi.Transcriber.from_artifact(ASSET)
    assert t.long_form_geometry() == jt.long_form_geometry()
    assert t._long_form_cap(152000 + 38000, 25.0) == jt._long_form_cap(152000 + 38000, 25.0)
    assert t.frame_samples() == jt.frame_samples()
    got = t.transcribe_long(stream, adapt_cmvn=adapt)
    assert got == jt.transcribe_long(stream, adapt_cmvn=adapt)
    assert len(got) > 140  # the stream holds 152 phones
    if adapt:
        p = t._stream_adapted_params(stream)
        jp = jt._stream_adapted_params(stream)
        np.testing.assert_allclose(p.cmvn_mean.numpy(), np.asarray(jp.cmvn_mean), rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(p.cmvn_std.numpy(), np.asarray(jp.cmvn_std), rtol=1e-4, atol=1e-4)
        assert p.listener is t.params.listener and p.cmvn_mean is not t.params.cmvn_mean


@pytest.mark.parametrize("beam", [0, 4])
def test_decode_aligned_matches_jax(utterances, beam):
    """Token ids and attention-peak times of three windows (one wave of 4,
    a padded row), greedy and beam."""
    audio, _, _ = utterances
    windows = [audio[0][:100000], audio[1][20000:], audio[0][50000:70000]]
    t = api.Transcriber.from_artifact(ASSET, device="cpu", beam_width=beam)
    jt = japi.Transcriber.from_artifact(ASSET, beam_width=beam)
    got = t.decode_aligned(windows, window_samples=128000)
    want = jt.decode_aligned(windows, window_samples=128000)
    assert len(got) == len(want) == 3
    for (ids, times), (jids, jtimes) in zip(got, want):
        np.testing.assert_array_equal(ids, np.asarray(jids))
        np.testing.assert_array_equal(times, np.asarray(jtimes))
        assert np.all(np.diff(times) >= 0) and len(ids) > 5


def test_align_matches_jax(utterances):
    audio, _, refs = utterances
    t = api.Transcriber.from_artifact(ASSET, device="cpu")
    jt = japi.Transcriber.from_artifact(ASSET)
    got = t.align(audio[1], refs[1])
    assert got == jt.align(audio[1], refs[1])
    ids = t.vocab.encode(refs[0][:20])
    assert t.align(audio[0], ids) == jt.align(audio[0], ids)
    assert [tok for tok, _ in got] == refs[1]


def test_transcriber_rules(monkeypatch, tmp_path):
    with pytest.raises(FileNotFoundError, match="config.json"):
        api.Transcriber(str(tmp_path / "no_such_run"), device="cpu")  # a workdir without a run
    with pytest.raises(ValueError, match="beam"):
        api.Transcriber.from_artifact(ASSET, device="cpu", ctc_joint=0.7)
    t = api.Transcriber.from_artifact(ASSET, device="cpu", max_device_batch=2)
    pcm = (np.random.RandomState(0).randn(3, 20000) * 2000).astype(np.int16)
    assert t.transcribe_batch(list(pcm)) == [t.transcribe(x) for x in pcm]  # two waves
    assert t._wire_dtype(list(pcm)) == np.int16 and t._wire_dtype([pcm[0], pcm[1].astype(np.float32)]) == np.float32
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        api.Transcriber.from_artifact(ASSET)
