"""The port's corpora and corpus prep against the JAX package's: the tone
and formant corpora bitwise (the long-regime gate's seeds included),
CMVN through the port's front-end, and ``prepare_timit`` on a mini TIMIT
tree (records and vocabularies byte for byte, CMVN stats within 1e-4)."""

import dataclasses
import filecmp
import json

import numpy as np
import pytest

from phones_las_tpu.data import speechlike as jax_speechlike
from phones_las_tpu.data import synthetic as jax_synthetic
from phones_las_tpu.data.librispeech import text_to_chars as jax_text_to_chars
from phones_las_tpu.data.prep_common import compute_cmvn as jax_compute_cmvn
from phones_las_tpu.data.timit import prepare_timit as jax_prepare_timit
from phones_las_tpu.data.timit import timit_phone_inventory as jax_timit_phone_inventory
from phones_las_tpu.data.vocab import Vocab as JaxVocab
from phones_las_tpu.frontend.features import FrontendConfig as JaxFrontendConfig

from phones_las_torch.data import speechlike, synthetic
from phones_las_torch.data.librispeech import text_to_chars
from phones_las_torch.data.prep_common import compute_cmvn, finalize_split_dir
from phones_las_torch.data.timit import parse_phn, prepare_timit, timit_phone_inventory
from phones_las_torch.data.vocab import Vocab
from phones_las_torch.frontend.cmvn import CmvnStats
from phones_las_torch.frontend.features import FrontendConfig
from tests.test_audio_io import _write_sphere
from tests.torch_threads import one_thread

one_thread()

CMVN_RTOL = 1e-4


def _assert_same_utterance(a, b):
    assert a.utt_id == b.utt_id and a.text == b.text
    for x, y in ((a.audio, b.audio), (a.targets, b.targets), (a.grapheme_targets, b.grapheme_targets),
                 (a.token_times, b.token_times)):
        assert (x is None) == (y is None)
        if x is not None:
            assert x.dtype == y.dtype
            np.testing.assert_array_equal(x, y)


def test_tone_corpus_bitwise_like_jax(tmp_path):
    mine, vocab = synthetic.write_synth_corpus(str(tmp_path / "a.plu"), n_utts=12, n_phones=8, seed=3,
                                               graphemes=True, vocab_path=str(tmp_path / "a.txt"))
    ref, jvocab = jax_synthetic.write_synth_corpus(str(tmp_path / "b.plu"), n_utts=12, n_phones=8, seed=3,
                                                   graphemes=True, vocab_path=str(tmp_path / "b.txt"))
    assert vocab.tokens == jvocab.tokens
    for suffix in ("", ".idx"):
        assert filecmp.cmp(mine + suffix, ref + suffix, shallow=False)
    assert filecmp.cmp(str(tmp_path / "a.txt"), str(tmp_path / "b.txt"), shallow=False)
    assert synthetic.synth_grapheme_inventory() == jax_synthetic.synth_grapheme_inventory()


@pytest.mark.parametrize(
    "seed,n,kw",
    [
        (7, 6, dict()),  # the card's training corpus (chip_smoke.py phase 7)
        (9001, 8, dict(n_syllables_range=(22, 28), word_syllables=(1, 3), snr_db_range=(8.0, 30.0))),
        (9002, 1, dict(n_syllables_range=(170, 170), word_syllables=(1, 3), snr_db_range=(10.0, 30.0))),
    ],
    ids=["corpus", "gate_batch", "gate_stream"],
)
def test_speechlike_bitwise_like_jax(seed, n, kw):
    """The formant corpus at the seeds and bounds of the long-regime gate
    (``tests/test_long_regime_gate.py``) and of the card's corpus."""
    assert speechlike.speechlike_phone_inventory() == jax_speechlike.speechlike_phone_inventory()
    assert speechlike.speechlike_grapheme_inventory() == jax_speechlike.speechlike_grapheme_inventory()
    vocab, jvocab = Vocab(speechlike.speechlike_phone_inventory()), JaxVocab(speechlike.speechlike_phone_inventory())
    gvocab = Vocab(speechlike.speechlike_grapheme_inventory())
    jgvocab = JaxVocab(speechlike.speechlike_grapheme_inventory())
    lang, jlang = speechlike.make_phonotactics(1234), jax_speechlike.make_phonotactics(1234)
    rng, jrng = np.random.RandomState(seed), np.random.RandomState(seed)
    for i in range(n):
        a = speechlike.synth_speech_utterance(rng, vocab, f"u{i}", model=lang, grapheme_vocab=gvocab, **kw)
        b = jax_speechlike.synth_speech_utterance(jrng, jvocab, f"u{i}", model=jlang, grapheme_vocab=jgvocab, **kw)
        _assert_same_utterance(a, b)


def test_speechlike_corpus_file_like_jax(tmp_path):
    mine, _ = speechlike.write_speechlike_corpus(str(tmp_path / "a.plu"), n_utts=5, seed=8, graphemes=True)
    ref, _ = jax_speechlike.write_speechlike_corpus(str(tmp_path / "b.plu"), n_utts=5, seed=8, graphemes=True)
    for suffix in ("", ".idx"):
        assert filecmp.cmp(mine + suffix, ref + suffix, shallow=False)


def _assert_stats_close(got: CmvnStats, want):
    assert got.count == want.count
    for g, w in ((got.mean, want.mean), (got.std, want.std)):
        np.testing.assert_allclose(g, w, rtol=CMVN_RTOL, atol=CMVN_RTOL * float(np.abs(w).max()))


@pytest.mark.parametrize("frontend", ["logmel", "mfcc_odd_quantum"])
def test_compute_cmvn_like_jax(tmp_path, frontend):
    path, _ = speechlike.write_speechlike_corpus(str(tmp_path / "a.plu"), n_utts=6, seed=2)
    kw, quantum = {}, 32000
    if frontend != "logmel":
        kw, quantum = dict(feature_type="mfcc", num_ceps=13), 12000
    got = compute_cmvn(path, FrontendConfig(**kw), max_utts=5, pad_quantum=quantum, device="cpu")
    want = jax_compute_cmvn(path, JaxFrontendConfig(**kw), max_utts=5, pad_quantum=quantum)
    _assert_stats_close(got, want)
    assert got.sum.shape == (FrontendConfig(**kw).base_dim * 3,)


def test_finalize_split_dir_defaults_to_cuda(tmp_path, monkeypatch):
    import torch

    path, vocab = synthetic.write_synth_corpus(str(tmp_path / "a.plu"), n_utts=2)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        finalize_split_dir(str(tmp_path), vocab, cmvn_from=path)


def _pcm(n=8000, seed=0):
    return (np.random.RandomState(seed).randn(n) * 2000).astype(np.int16)


@pytest.fixture()
def mini_timit(tmp_path):
    """The mini TIMIT tree of ``tests/test_corpora.py``: two speakers' worth
    of SPHERE files with phone and text transcripts, SA sentences among
    them."""
    root = tmp_path / "TIMIT"
    for split in ("TRAIN", "TEST"):
        d = root / split / "DR1" / "FABC0"
        d.mkdir(parents=True)
        for i, utt in enumerate(["SI1", "SX2", "SA1"]):
            _write_sphere(str(d / f"{utt}.WAV"), _pcm(seed=i))
            (d / f"{utt}.PHN").write_text("0 1000 h#\n1000 3000 sh\n3000 5000 iy\n5000 8000 h#\n")
            (d / f"{utt}.TXT").write_text("0 8000 She is.\n")
    return root


@pytest.mark.parametrize("output_ipa", [True, False])
def test_prepare_timit_like_jax(tmp_path, mini_timit, output_ipa):
    mine, ref = tmp_path / "port", tmp_path / "jax"
    counts = prepare_timit(str(mini_timit), str(mine), output_ipa=output_ipa, log=lambda *a: None, device="cpu")
    assert counts == jax_prepare_timit(str(mini_timit), str(ref), output_ipa=output_ipa, log=lambda *a: None)
    assert counts == {"train": 2, "test": 2}  # SA excluded
    for name in ("train.plu", "train.plu.idx", "test.plu", "test.plu.idx", "vocab.txt", "grapheme_vocab.txt"):
        assert filecmp.cmp(str(mine / name), str(ref / name), shallow=False), name
    assert json.loads((mine / "meta.json").read_text()) == json.loads((ref / "meta.json").read_text())
    got, want = CmvnStats.load(str(mine / "cmvn.json")), CmvnStats.load(str(ref / "cmvn.json"))
    _assert_stats_close(got, want)
    assert timit_phone_inventory(output_ipa) == jax_timit_phone_inventory(output_ipa)
    phn = next(mini_timit.rglob("SI1.PHN"))
    assert parse_phn(str(phn)) == ["h#", "sh", "iy", "h#"]


@pytest.mark.parametrize("text", ["She is.", "  HELLO, World's 3 end!  ", "", "a-b c"])
def test_text_to_chars_like_jax(text):
    assert text_to_chars(text) == jax_text_to_chars(text)


def test_frontend_config_fields_match_jax():
    """``compute_cmvn`` takes the port's config where the reference takes
    its own: the same fields with the same defaults."""
    assert {f.name: f.default for f in dataclasses.fields(FrontendConfig)} == {
        f.name: f.default for f in dataclasses.fields(JaxFrontendConfig)
    }
