"""The port's LibriSpeech and Common Voice prep and the G2P CLI against the
JAX package's, on the mini trees of ``tests/test_corpora.py``: record
files (``.plu`` + ``.idx``) and vocabularies byte for byte, CMVN stats
within 1e-4 (the port's front-end against XLA's), with the bundled G2P
model for the out-of-lexicon words; ``cli.g2p apply`` line for line.

The reference's ``prepare_librispeech(targets='phone')`` raises before
it writes anything: its ``_ipa_phone_inventory`` unpacks the English
rules as pairs, and the suffix rules are triples. The phone-target case
holds the port to the reference's prep with that one function replaced by
its evident meaning (every rule's phones), written out here."""

import filecmp
import os

import numpy as np
import pytest

from phones_las_tpu.cli import g2p as jax_g2p_cli
from phones_las_tpu.data import audio_io as jax_audio_io
from phones_las_tpu.data import g2p as jax_g2p
from phones_las_tpu.data import librispeech as jax_librispeech
from phones_las_tpu.data.common_voice import prepare_common_voice as jax_prepare_common_voice
from phones_las_tpu.models.g2p_model import NeuralG2P as JaxNeuralG2P

from phones_las_torch.cli import g2p as g2p_cli
from phones_las_torch.data import librispeech
from phones_las_torch.data.common_voice import iter_common_voice, prepare_common_voice
from phones_las_torch.data.lexicon_en import expanded_lexicon
from phones_las_torch.frontend.cmvn import CmvnStats
from phones_las_torch.models.g2p_model import NeuralG2P, load_g2p
from tests.flac_encoder import encode_flac
from tests.torch_threads import one_thread

one_thread()

CMVN_RTOL = 1e-4
QUIET = dict(log=lambda *a: None)
# out-of-lexicon words the model transcribes, a numeral the rules take
LS_TEXT = ["HELLO WORLD {i}", "THE STATIONS OF XYLOPHONES", "KNIGHTS WRITE PSALMS IN ZEPHYRS"]
CV_SENTENCES = {
    "es": ["hola mundo", "buenos días"],
    "it": ["ciao", "perché no"],
    "en": ["The stations of 42 xylophones.", "Hello, zephyrs!"],
}


def _pcm(n=8000, seed=0):
    return (np.random.RandomState(seed).randn(n) * 2000).astype(np.int16)


@pytest.fixture(scope="module")
def models():
    """The bundled model, the port's on the CPU and JAX's, each loaded once
    (prep takes a path, so the tests hand these in through the loaders)."""
    return {"torch": NeuralG2P.bundled(device="cpu"), "jax": JaxNeuralG2P.bundled()}


@pytest.fixture
def bundled_once(models, monkeypatch):
    monkeypatch.setattr(librispeech, "load_g2p_model", lambda path, device=None: models["torch"])
    monkeypatch.setattr(JaxNeuralG2P, "bundled", classmethod(lambda cls, **kw: models["jax"]))


@pytest.fixture(scope="module")
def mini_librispeech(tmp_path_factory):
    root = tmp_path_factory.mktemp("ls") / "LibriSpeech"
    for split, speaker in (("train-clean-100", "19"), ("dev-clean", "84")):
        d = root / split / speaker / "198"
        d.mkdir(parents=True)
        trans = []
        for i, text in enumerate(LS_TEXT):
            uid = f"{speaker}-198-{i:04d}"
            with open(d / f"{uid}.flac", "wb") as f:
                f.write(encode_flac(_pcm(seed=i + int(speaker)), mode="fixed2"))
            trans.append(f"{uid} {text.format(i=i)}")
        (d / f"{speaker}-198.trans.txt").write_text("\n".join(trans) + "\n")
    return str(root)


@pytest.fixture(scope="module")
def mini_common_voice(tmp_path_factory):
    root = tmp_path_factory.mktemp("cv")
    for lang, sents in CV_SENTENCES.items():
        d = root / lang / "clips"
        d.mkdir(parents=True)
        rows = ["client_id\tpath\tsentence"]
        for i, s in enumerate(sents):
            jax_audio_io.write_wav(str(d / f"clip{i}.wav"), _pcm(seed=10 + i))
            rows.append(f"c{i}\tclip{i}.mp3\t{s}")
        rows.append("c9\tmissing.mp3\tno clip")
        (root / lang / "validated.tsv").write_text("\n".join(rows) + "\n")
    return str(root)


def _reference_inventory():
    """``phones_las_tpu/data/librispeech.py::_ipa_phone_inventory`` as it
    means to be: the phones of the lexicon and of every English rule."""
    phones = set()
    for ps in jax_g2p._EN_LEXICON.values():
        phones.update(ps)
    for rule in jax_g2p._EN_RULES:
        phones.update(rule[1])
    return sorted(phones)


def _assert_same_dirs(ours: str, theirs: str, records):
    for name in records:
        for suffix in ("", ".idx"):
            assert filecmp.cmp(os.path.join(ours, name + suffix), os.path.join(theirs, name + suffix),
                               shallow=False), name + suffix
    for name in ("vocab.txt", "grapheme_vocab.txt"):
        assert filecmp.cmp(os.path.join(ours, name), os.path.join(theirs, name), shallow=False), name
    got, want = CmvnStats.load(os.path.join(ours, "cmvn.json")), CmvnStats.load(os.path.join(theirs, "cmvn.json"))
    assert got.count == want.count
    for g, w in ((got.mean, want.mean), (got.std, want.std)):
        np.testing.assert_allclose(g, w, rtol=CMVN_RTOL, atol=CMVN_RTOL * float(np.abs(w).max()))


def test_reference_phone_inventory_is_what_the_port_uses():
    assert librispeech._ipa_phone_inventory() == _reference_inventory()


@pytest.mark.parametrize("targets", ["char", "phone"])
def test_prepare_librispeech_like_jax(tmp_path, mini_librispeech, bundled_once, monkeypatch, targets):
    splits = ("train-clean-100", "dev-clean")
    ours, theirs = str(tmp_path / "ours"), str(tmp_path / "theirs")
    kw = dict(splits=splits, targets=targets, g2p_model="bundled" if targets == "phone" else None, **QUIET)
    counts = librispeech.prepare_librispeech(mini_librispeech, ours, device="cpu", **kw)
    monkeypatch.setattr(jax_librispeech, "_ipa_phone_inventory", _reference_inventory)
    assert counts == jax_librispeech.prepare_librispeech(mini_librispeech, theirs, **kw) == {s: 3 for s in splits}
    _assert_same_dirs(ours, theirs, [s + ".plu" for s in splits])


def test_librispeech_phone_targets_use_the_model(tmp_path, mini_librispeech, models):
    """The out-of-lexicon words of a transcript take the model's phones,
    the numeral the rules'."""
    from phones_las_torch.data.g2p import text_to_ipa

    m = models["torch"]
    text = LS_TEXT[1]
    got = text_to_ipa(text, "en", model=m)
    assert got != text_to_ipa(text, "en")
    assert m.lookup(["xylophones"])["xylophones"] == got[-len(m.lookup(["xylophones"])["xylophones"]):]


def test_prepare_common_voice_like_jax(tmp_path, mini_common_voice, bundled_once):
    langs = list(CV_SENTENCES)
    ours, theirs = str(tmp_path / "ours"), str(tmp_path / "theirs")
    counts = prepare_common_voice(mini_common_voice, ours, langs, g2p_model="bundled", device="cpu", **QUIET)
    want = jax_prepare_common_voice(mini_common_voice, theirs, langs, g2p_model="bundled", **QUIET)
    assert counts == want == {lang: len(s) for lang, s in CV_SENTENCES.items()}
    _assert_same_dirs(ours, theirs, [f"{lang}.plu" for lang in langs])
    assert [u for u, _, _ in iter_common_voice(os.path.join(mini_common_voice, "es"))] == ["clip0", "clip1"]


def test_cli_apply_like_jax(tmp_path, capsys):
    words = ["hello", "stations", "42", "zephyrs"]
    text = tmp_path / "t.txt"
    text.write_text("Knights write psalms.\n")
    argv = ["apply", "--model", os.path.join("phones_las_tpu", "assets", "g2p_en.npz"), "--beam-width", "1",
            "--text", str(text)] + words
    g2p_cli.main(argv + ["--device", "cpu"])
    ours = capsys.readouterr().out
    jax_g2p_cli.main(argv)
    assert ours == capsys.readouterr().out and "42\t<no-model-coverage>" in ours


def test_cli_train_reads_the_extra_lexicon(tmp_path, capsys):
    """``train --extra-lexicon``: words lower-cased, those with characters
    outside the alphabet skipped, the model file readable by both
    packages (two steps at the CLI's widths on the CPU)."""
    extra = tmp_path / "extra.txt"
    extra.write_text("Zorblax: z ɔ ɹ b l æ k s\nnaïve: n aɪ i v\nempty:\n")
    out = str(tmp_path / "m.npz")
    g2p_cli.main(["train", "--out", out, "--steps", "2", "--batch-size", "4", "--extra-lexicon", str(extra),
                  "--device", "cpu"])
    log = capsys.readouterr().out
    assert "skipping 'naïve'" in log
    assert f"trained on {len(expanded_lexicon()) + 1} pairs" in log
    _, cfg, _, vp = load_g2p(out, device="cpu")
    assert cfg.units == 128 and "ɹ" in vp.tokens
    from phones_las_tpu.models.g2p_model import load_g2p as jax_load_g2p

    assert jax_load_g2p(out)[3].tokens == vp.tokens


def test_cli_runs_on_cuda_unless_told(monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        g2p_cli.main(["apply", "--model", os.path.join("phones_las_tpu", "assets", "g2p_en.npz"), "hello"])
