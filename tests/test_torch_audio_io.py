"""The port's audio input against the JAX package's: WAV, SPHERE (PCM in
both byte orders and µ-law), FLAC through the test encoder, MP3 where an
encoder is available, the polyphase resampler bitwise, a replay of the
fuzz corpus through the port's decoders in subprocesses, and
``Transcriber.transcribe_files`` on the long-regime artifact against the
JAX ``Transcriber`` at 16 kHz and 48 kHz."""

import glob
import os
import subprocess
import sys

import numpy as np
import pytest

from phones_las_tpu import api as japi
from phones_las_tpu.data import audio_io as jax_audio_io
from phones_las_tpu.data.speechlike import make_phonotactics, speechlike_phone_inventory, synth_speech_utterance
from phones_las_tpu.data.vocab import Vocab as JaxVocab

from phones_las_torch import api
from phones_las_torch.data import audio_io
from tests import mp3_encoder
from tests.flac_encoder import encode_flac
from tests.torch_threads import one_thread, subprocess_env

one_thread()

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ASSET = os.path.join(ROOT, "tests", "goldens", "long_gate.npz")
FUZZ = sorted(p for p in glob.glob(os.path.join(ROOT, "tests", "fuzz_corpus", "*")) if not p.endswith(".idx"))


def _pcm(n=12345, seed=0):
    rng = np.random.RandomState(seed)
    # a correlated signal, so fixed predictors leave small residuals
    x = np.cumsum(rng.randn(n) * 300).astype(np.int64)
    return np.clip(x - x.mean(), -30000, 30000).astype(np.int16)


def _same_read(path, **kw):
    got, rate = audio_io.read_audio(path, **kw)
    want, want_rate = jax_audio_io.read_audio(path, **kw)
    assert rate == want_rate and got.dtype == np.int16
    np.testing.assert_array_equal(got, want)
    return got, rate


def test_wav_written_and_read_like_jax(tmp_path):
    pcm = _pcm()
    mine, ref = str(tmp_path / "a.wav"), str(tmp_path / "b.wav")
    audio_io.write_wav(mine, pcm, 22050)
    jax_audio_io.write_wav(ref, pcm, 22050)
    assert open(mine, "rb").read() == open(ref, "rb").read()
    got, rate = _same_read(mine)
    assert rate == 22050
    np.testing.assert_array_equal(got, pcm)
    py, py_rate = audio_io._read_wav_py(mine)
    np.testing.assert_array_equal(py, pcm)
    assert py_rate == 22050


def _write_sphere(path, body: bytes, coding="pcm", nbytes=2, big=False, rate=16000):
    hdr = (
        "NIST_1A\n   1024\n"
        f"sample_rate -i {rate}\n"
        "channel_count -i 1\n"
        f"sample_n_bytes -i {nbytes}\n"
        f"sample_byte_format -s2 {'10' if big else '01'}\n"
        f"sample_coding -s{len(coding)} {coding}\n"
        "end_head\n"
    ).encode()
    with open(path, "wb") as f:
        f.write(hdr + b" " * (1024 - len(hdr)) + body)


@pytest.mark.parametrize("kind", ["pcm_le", "pcm_be", "ulaw"])
def test_sphere_like_jax(tmp_path, kind):
    p = str(tmp_path / "a.sph")
    pcm = _pcm(seed=2)
    if kind == "ulaw":
        body = np.random.RandomState(2).randint(0, 256, 5000).astype(np.uint8).tobytes()
        _write_sphere(p, body, coding="ulaw", nbytes=1)
    else:
        big = kind == "pcm_be"
        _write_sphere(p, pcm.astype(">i2" if big else "<i2").tobytes(), big=big)
    got, _ = _same_read(p)
    py, rate = audio_io._read_sphere_py(p)
    want_py, _ = jax_audio_io._read_sphere_py(p)
    np.testing.assert_array_equal(py, want_py)
    np.testing.assert_array_equal(got, py)
    if kind != "ulaw":
        np.testing.assert_array_equal(got, pcm)


@pytest.mark.parametrize("mode", ["verbatim", "constant", "fixed1", "fixed2", "fixed4", "stereo"])
def test_flac_like_jax(tmp_path, mode):
    if mode == "stereo":
        pcm = np.stack([_pcm(5000, 4), _pcm(5000, 5)], axis=1)
        data = encode_flac(pcm, mode="verbatim")
    else:
        pcm = np.full(10000, 123, np.int16) if mode == "constant" else _pcm(10000, seed=3)
        data = encode_flac(pcm, mode=mode)
    p = tmp_path / "a.flac"
    p.write_bytes(data)
    got, rate = _same_read(str(p))
    assert rate == 16000
    if mode != "stereo":
        np.testing.assert_array_equal(got, pcm)


@pytest.mark.parametrize("rates", [(48000, 16000), (44100, 16000), (8000, 16000), (16000, 48000), (32000, 22050)])
def test_resample_bitwise_like_jax(rates):
    x = _pcm(30011, seed=7)
    got = audio_io.resample(x, *rates)
    want = jax_audio_io.resample(x, *rates)
    np.testing.assert_array_equal(got, want)
    assert abs(len(got) - len(x) * rates[1] / rates[0]) <= 1
    assert audio_io.resample(x, 16000, 16000) is x


def test_mp3_like_jax(tmp_path):
    bad = tmp_path / "x.mp3"
    bad.write_bytes(b"\xff\xfb\x00")
    with pytest.raises(ValueError, match="mp3"):
        audio_io.read_audio(str(bad))
    if not mp3_encoder.available():
        pytest.skip("no MP3 encoder library here")
    p = str(tmp_path / "a.mp3")
    mp3_encoder.write_mp3(p, _pcm(16000, seed=9), 16000)
    got, rate = _same_read(p)
    assert rate == 16000 and len(got) > 15000
    _same_read(p, target_rate=8000)


_REPLAY = r"""
import sys
import numpy as np
from phones_las_torch.data import audio_io
from phones_las_torch.data.native_records import NativeRecordReader
from phones_las_torch.data.records import RecordReader
path = sys.argv[1]
try:
    if path.endswith(".plu"):
        assert NativeRecordReader.available()
        r = NativeRecordReader(path)
        try:
            b = min(len(r), 4)
            if b > 0:
                r.lengths()
                r.read_batch(np.arange(b), np.zeros((b, 2048), np.int16), np.zeros(b, np.int32),
                             np.zeros((b, 16), np.int32), np.zeros(b, np.int32), eos_id=1, pad_id=0, n_threads=2)
        finally:
            r.close()
        for _ in RecordReader(path):
            pass
    else:
        assert audio_io._native() is not None
        audio_io.read_audio(path)
    print("DECODED")
except Exception as e:
    print(f"REJECTED {type(e).__name__}")
"""


@pytest.mark.parametrize("path", FUZZ, ids=[os.path.basename(p) for p in FUZZ])
def test_fuzz_corpus_never_crashes_the_port(path):
    """Every committed hostile input decodes or raises a Python exception
    in the port's decoders; a crash of the native parser fails the test
    instead of the run (each file replays in a subprocess)."""
    env = subprocess_env(PYTHONPATH=ROOT + os.pathsep + os.environ.get("PYTHONPATH", ""))
    proc = subprocess.run([sys.executable, "-c", _REPLAY, path], capture_output=True, text=True, timeout=120,
                          env=env, cwd=ROOT)
    assert proc.returncode == 0, f"{os.path.basename(path)} crashed the decoder:\n{proc.stderr[-2000:]}"
    assert "DECODED" in proc.stdout or "REJECTED" in proc.stdout, proc.stdout
    assert "AssertionError" not in proc.stdout, "the native library did not build"


@pytest.fixture(scope="module")
def gate_files(tmp_path_factory):
    """Four utterances of the long-gate language as 16 kHz WAV files, and
    two of them resampled to 48 kHz."""
    d = tmp_path_factory.mktemp("files")
    vocab = JaxVocab(speechlike_phone_inventory())
    lang = make_phonotactics(1234)
    rng = np.random.RandomState(77)
    utts = [synth_speech_utterance(rng, vocab, f"f{i}", model=lang, n_syllables_range=(4, 9),
                                   word_syllables=(1, 3)) for i in range(4)]
    p16, p48 = [], []
    for i, u in enumerate(utts):
        p16.append(str(d / f"u{i}.wav"))
        audio_io.write_wav(p16[-1], u.audio, 16000)
        if i < 2:
            p48.append(str(d / f"u{i}_48k.wav"))
            audio_io.write_wav(p48[-1], audio_io.resample(u.audio, 16000, 48000), 48000)
    return [u.audio for u in utts], p16, p48


def test_transcribe_files_like_jax(gate_files):
    audio, p16, p48 = gate_files
    t = api.Transcriber.from_artifact(ASSET, device="cpu")
    ref = japi.Transcriber.from_artifact(ASSET)
    got = t.transcribe_files(p16 + p48)
    assert got == ref.transcribe_files(p16 + p48)
    assert got[: len(p16)] == t.transcribe_batch(audio)
    assert all(len(h) > 3 for h in got)
