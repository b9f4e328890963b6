"""The port's data layer against the JAX package's: record files byte for
byte and read across packages, the bucket plan, ``DataSource`` batches
(native and Python fills), the prefetch thread's error and cancellation
semantics, ``shard_plan``, and the native reader's host build."""

import filecmp
import logging
import os
import threading
import time

import numpy as np
import pytest

from phones_las_tpu.data.native_records import NativeRecordReader as JaxNativeRecordReader
from phones_las_tpu.data.pipeline import DataSource as JaxDataSource
from phones_las_tpu.data.pipeline import PipelineConfig as JaxPipelineConfig
from phones_las_tpu.data.pipeline import plan_batches as jax_plan_batches
from phones_las_tpu.data.records import RecordReader as JaxRecordReader
from phones_las_tpu.data.records import RecordWriter as JaxRecordWriter
from phones_las_tpu.data.records import Utterance as JaxUtterance
from phones_las_tpu.data.synthetic import write_synth_corpus as jax_write_synth_corpus
from phones_las_tpu.parallel.multihost import shard_plan as jax_shard_plan

from phones_las_torch.data import audio_io, native_records
from phones_las_torch.data.native_records import NativeRecordReader
from phones_las_torch.data.pipeline import DataSource, PipelineConfig, plan_batches
from phones_las_torch.data.records import RecordReader, RecordWriter, Utterance
from phones_las_torch.data.synthetic import write_synth_corpus
from phones_las_torch.parallel.multihost import shard_plan
from tests.torch_threads import one_thread

one_thread()

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "phones_las_torch", "csrc")


def _utterances(seed=0, n=6):
    rs = np.random.RandomState(seed)
    out = []
    for i in range(n):
        audio = (rs.randn(rs.randint(1, 4000)) * 3000).astype(np.int16)
        targets = rs.randint(4, 30, rs.randint(0, 9)).astype(np.int32)
        g = rs.randint(4, 20, rs.randint(1, 12)).astype(np.int32) if i % 2 else None
        out.append((f"utt-{i}-ü", audio, targets, g, "some text é" if i % 3 else ""))
    return out


def _write(writer_cls, utt_cls, path, utts, meta):
    with writer_cls(path, meta=meta) as w:
        for u in utts:
            w.write(utt_cls(*u))


def _assert_same_utterance(a, b):
    assert a.utt_id == b.utt_id and a.text == b.text
    np.testing.assert_array_equal(a.audio, b.audio)
    np.testing.assert_array_equal(a.targets, b.targets)
    assert (a.grapheme_targets is None) == (b.grapheme_targets is None)
    if a.grapheme_targets is not None:
        np.testing.assert_array_equal(a.grapheme_targets, b.grapheme_targets)


def test_records_byte_equal_and_read_across(tmp_path):
    utts = _utterances()
    meta = {"corpus": "t", "sample_rate": 16000}
    mine, ref = str(tmp_path / "port.plu"), str(tmp_path / "jax.plu")
    _write(RecordWriter, Utterance, mine, utts, meta)
    _write(JaxRecordWriter, JaxUtterance, ref, utts, meta)
    assert filecmp.cmp(mine, ref, shallow=False)
    assert filecmp.cmp(mine + ".idx", ref + ".idx", shallow=False)
    for reader_cls, other_cls, path in ((RecordReader, JaxRecordReader, ref), (JaxRecordReader, RecordReader, mine)):
        got, want = reader_cls(path), other_cls(path)
        assert len(got) == len(want) == len(utts) and got.meta == want.meta
        np.testing.assert_array_equal(got.lengths(), want.lengths())
        for i in range(len(utts)):
            _assert_same_utterance(got[i], want[i])
            assert got.utt_id(i) == utts[i][0]
    # without the index, the reader rebuilds the offsets by scanning
    os.remove(mine + ".idx")
    np.testing.assert_array_equal(RecordReader(mine).lengths(), JaxRecordReader(ref).lengths())
    bad = tmp_path / "bad.plu"
    bad.write_bytes(b"\x0c\x00\x00\x00" + b'{"magic":1}\n')
    with pytest.raises(ValueError, match="magic"):
        RecordReader(str(bad))


_PLAN_CASES = [
    dict(),
    dict(drop_remainder=False),
    dict(drop_too_long=False, min_samples=300),
    dict(max_grapheme_len=6, drop_remainder=False),
]


@pytest.mark.parametrize("kw", _PLAN_CASES, ids=["default", "remainder", "truncate_min", "graphemes"])
def test_plan_batches_equal_jax(kw):
    rs = np.random.RandomState(3)
    n = 200
    lens = rs.randint(100, 5000, n)
    t_lens = rs.randint(0, 12, n)
    g_lens = rs.randint(0, 9, n)
    order = rs.permutation(n)
    common = dict(batch_size=5, buckets=(1000, 2500, 4000), max_target_len=10, **kw)
    got = plan_batches(lens, order, PipelineConfig(**common), t_lens, g_lens)
    want = jax_plan_batches(lens, order, JaxPipelineConfig(**common), t_lens, g_lens)
    assert len(got) == len(want) > 0
    for (gb, gi), (wb, wi) in zip(got, want):
        assert gb == wb
        np.testing.assert_array_equal(gi, wi)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """Two record files of the tone corpus with graphemes (written by the
    port; byte-equal to the reference's writer)."""
    d = tmp_path_factory.mktemp("corpus")
    paths = []
    for seed, n in ((0, 23), (1, 17)):
        p, vocab = write_synth_corpus(str(d / f"s{seed}.plu"), n_utts=n, seed=seed, graphemes=True)
        q, _ = jax_write_synth_corpus(str(d / f"j{seed}.plu"), n_utts=n, seed=seed, graphemes=True)
        assert filecmp.cmp(p, q, shallow=False)
        paths.append(p)
    return paths, vocab


def _assert_batches_equal(got, want):
    assert len(got) == len(want) > 0
    for a, b in zip(got, want):
        assert sorted(a) == sorted(b)
        for k in a:
            if isinstance(a[k], np.ndarray):
                assert a[k].dtype == b[k].dtype, k
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)
            else:
                assert a[k] == b[k], k


@pytest.mark.parametrize("use_native", ["auto", "never"])
def test_datasource_batches_equal_jax(corpus, use_native):
    paths, vocab = corpus
    kw = dict(batch_size=4, buckets=(12000, 24000), max_target_len=7, max_grapheme_len=24,
              eos_id=vocab.eos_id, pad_id=vocab.pad_id, drop_remainder=False, seed=5)
    src = DataSource(paths, PipelineConfig(**kw), use_native=use_native)
    ref = JaxDataSource(paths, JaxPipelineConfig(**kw), use_native="never")
    assert (src.native is not None) == (use_native == "auto")
    for epoch in (0, 1):
        got, want = list(src.epoch(epoch)), list(ref.epoch(epoch))
        _assert_batches_equal(got, want)
        assert any(b["num_real"] < 4 for b in got)  # the flushed partial batches
        assert any(b["target_lengths"].max() == 7 for b in got)  # targets clipped to the row


def test_datasource_shard_matches_jax(corpus):
    paths, vocab = corpus
    kw = dict(batch_size=2, buckets=(12000, 24000), max_target_len=12, eos_id=vocab.eos_id)
    for index in range(2):
        got = list(DataSource(paths, PipelineConfig(**kw), shard=(index, 2)).epoch(1))
        want = list(JaxDataSource(paths, JaxPipelineConfig(**kw), shard=(index, 2), use_native="never").epoch(1))
        _assert_batches_equal(got, want)


@pytest.mark.parametrize("count", [1, 2, 3, 4])
def test_shard_plan_equal_jax(count):
    rs = np.random.RandomState(count)
    plans = [(int(b), np.arange(i, i + 2)) for i, b in enumerate(rs.randint(0, 3, 40))]
    for index in range(count):
        got, want = shard_plan(plans, index, count), jax_shard_plan(plans, index, count)
        assert [(b, list(i)) for b, i in got] == [(b, list(i)) for b, i in want]
    with pytest.raises(ValueError):
        shard_plan(plans, count, count)


def test_producer_exception_propagates(corpus):
    """A crashed reader must not look like a completed epoch."""
    paths, vocab = corpus
    src = DataSource(paths, PipelineConfig(batch_size=4, buckets=(24000,), max_target_len=12, eos_id=vocab.eos_id))

    def boom(*a, **k):
        raise RuntimeError("reader exploded")

    src._fill_batch = boom
    with pytest.raises(RuntimeError, match="reader exploded"):
        list(src.epoch(0))


def test_abandoned_epoch_cancels_producer(corpus):
    """Leaving an epoch mid-stream must not leave the producer blocked on
    the bounded queue."""
    paths, vocab = corpus
    src = DataSource(paths, PipelineConfig(batch_size=2, buckets=(24000,), max_target_len=12, eos_id=vocab.eos_id))
    before = threading.active_count()
    it = src.epoch(0, prefetch=1)
    next(it)
    it.close()
    deadline = time.time() + 5.0
    while threading.active_count() > before and time.time() < deadline:
        time.sleep(0.05)
    assert threading.active_count() <= before, "producer thread leaked"


def test_native_reader_builds_and_fills_like_jax(corpus):
    """The port builds its own copy of the C++ reader with the host
    compiler into its build directory (stamped), loads it beside the JAX
    package's library in one process, and both fill the same rows."""
    paths, vocab = corpus
    assert NativeRecordReader.available()
    so = os.path.join(CSRC, "build", "plu_records.so")
    with open(so + ".sha256") as f:
        src_digest, so_digest = f.read().split()
    assert src_digest == audio_io._sha(os.path.join(CSRC, "plu_records.cc")) and so_digest == audio_io._sha(so)
    mine, ref = NativeRecordReader(paths[0]), JaxNativeRecordReader(paths[0])
    np.testing.assert_array_equal(mine.lengths(), RecordReader(paths[0]).lengths())
    idx = np.asarray([5, 0, 22, 5])
    bufs = []
    for r in (mine, ref):
        b = (np.zeros((6, 9000), np.int16), np.zeros(6, np.int32), np.zeros((6, 5), np.int32),
             np.zeros(6, np.int32), np.zeros((6, 8), np.int32), np.zeros(6, np.int32))
        r.read_batch(idx, b[0], b[1], b[2], b[3], vocab.eos_id, vocab.pad_id, graphemes=b[4],
                     grapheme_lengths=b[5], n_threads=2)
        bufs.append(b)
    for a, b in zip(*bufs):
        np.testing.assert_array_equal(a, b)
    assert not bufs[0][1][4:].any()  # rows past the indices untouched
    with pytest.raises(ValueError):
        mine.read_batch(np.asarray([999]), *bufs[0][:4], vocab.eos_id, vocab.pad_id)
    with pytest.raises(ValueError, match="int16"):
        mine.read_batch(idx, bufs[0][0].astype(np.int32), *bufs[0][1:4], vocab.eos_id, vocab.pad_id)
    mine.close()


def test_python_fill_without_compiler_warns_once(corpus, monkeypatch, caplog):
    paths, vocab = corpus
    monkeypatch.setattr(NativeRecordReader, "available", staticmethod(lambda: False))
    cfg = PipelineConfig(batch_size=4, buckets=(24000,), max_target_len=12, eos_id=vocab.eos_id)
    with caplog.at_level(logging.WARNING, logger="phones_las_torch.data.pipeline"):
        src = DataSource(paths, cfg)
        batches = list(src.epoch(0))
    assert src.native is None and batches
    assert sum("native record reader" in r.getMessage() for r in caplog.records) == 1
    with pytest.raises(ValueError, match="use_native"):
        DataSource(paths, cfg, use_native="always")


def test_concurrent_builds_leave_one_whole_library(tmp_path, monkeypatch):
    """Several concurrent builds of one library (test workers do this) each
    get a loadable library: the compiler writes a temporary file that is
    renamed into place, and so is the stamp."""
    src_dir = tmp_path / "csrc"
    src_dir.mkdir()
    with open(os.path.join(CSRC, "plu_records.cc"), "rb") as f:
        (src_dir / "plu_records.cc").write_bytes(f.read())
    monkeypatch.setattr(audio_io, "_CSRC", str(src_dir))
    monkeypatch.setattr(audio_io, "_BUILD_DIR", str(src_dir / "build"))
    results = []
    threads = [threading.Thread(target=lambda: results.append(audio_io.ensure_built("plu_records.cc", "r.so")))
               for _ in range(3)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=180)
    assert not any(t.is_alive() for t in threads)
    so = str(src_dir / "build" / "r.so")
    assert results == [so] * 3
    assert sorted(os.listdir(src_dir / "build")) == ["r.so", "r.so.sha256"]  # no temporary file left
    lib = audio_io.load_library(so)
    assert lib.plu_open is not None
    assert audio_io.ensure_built("plu_records.cc", "r.so") == so  # the stamp holds: no rebuild
    assert audio_io.ensure_built("missing.cc", "m.so") is None
    assert native_records._load() is not None
