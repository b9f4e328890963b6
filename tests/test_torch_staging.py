"""The serving API's staging of a wave (``api.py::stage_wave`` and
``StagingRing``) on the CPU, where a ring holds plain host memory in place
of pinned (pinning needs CUDA): every array bitwise equal to the old way's
(a fresh ``np.zeros``, the rows filled one by one), for ragged rows, a
partial tail wave and each wire dtype; no stale samples after a longer
call; slots reused, grown only for a larger wave; never two threads in one
slot; replicas with rings of their own; the counters; and
``transcribe_batch`` and ``decode_aligned`` through a ring as through a
fresh array."""

import contextlib
import sys
import threading
import time

import numpy as np
import pytest
import torch

from phones_las_torch import api
from phones_las_torch.api import StagingRing, stage_wave
from tests.torch_threads import one_thread

one_thread()


def old_way(rows, wave, pad, dtype):
    """The staging as ``transcribe_batch`` did it before the ring."""
    audio = np.zeros((wave, pad), dtype)
    lengths = np.zeros((wave,), np.int32)
    for i, a in enumerate(rows):
        audio[i, : len(a)] = a
        lengths[i] = len(a)
    return audio, lengths


def ragged(rs, lens, dtype=np.int16):
    if np.dtype(dtype) == np.int16:
        return [rs.randint(-32768, 32768, size=n).astype(np.int16) for n in lens]
    return [(rs.randn(n) * 3000).astype(dtype) for n in lens]


def staged_equal(rows, wave, pad, dtype, ring):
    got = stage_wave(rows, wave, pad, dtype, "cpu", ring)
    want = old_way(rows, wave, pad, dtype)
    assert got[0].dtype == torch.from_numpy(want[0]).dtype and got[1].dtype == torch.int32
    np.testing.assert_array_equal(got[0].numpy(), want[0])
    np.testing.assert_array_equal(got[1].numpy(), want[1])
    assert got[0].numpy().tobytes() == want[0].tobytes()  # bitwise, -0.0 and all


CASES = {
    # rows of every length up to the pad, one full, one empty; a full wave
    "ragged_int16": (ragged(np.random.RandomState(0), [700, 1, 1024, 0, 333, 1000, 512, 2]), 8, 1024, np.int16),
    # a partial tail wave: 3 rows of a wave of 8
    "tail_wave_int16": (ragged(np.random.RandomState(1), [900, 17, 1024]), 8, 1024, np.int16),
    "ragged_float32": (ragged(np.random.RandomState(2), [640, 5, 999, 1000], np.float32), 6, 1000, np.float32),
    # int16 and float64 rows on a float32 wire, cast as the old way cast them
    "mixed_rows_float32": ([ragged(np.random.RandomState(3), [300])[0],
                            np.random.RandomState(4).randn(257) * 1e4], 3, 320, np.float32),
    # rows wider than a group (one row a group) and groups that end mid-wave
    "groups_of_one_row": (ragged(np.random.RandomState(5), [api.STAGE_GROUP_BYTES // 2 + 3, 10, 0]), 4,
                          api.STAGE_GROUP_BYTES // 2 + 8, np.int16),
    "nothing_to_pad": ([np.zeros(0, np.int16)] * 2, 2, 0, np.int16),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_a_wave_through_a_ring_is_the_old_way_bitwise(case):
    rows, wave, pad, dtype = CASES[case]
    staged_equal(rows, wave, pad, dtype, StagingRing())


@pytest.mark.parametrize("case", sorted(CASES))
def test_a_wave_without_a_ring_is_the_old_way_bitwise(case):
    rows, wave, pad, dtype = CASES[case]
    staged_equal(rows, wave, pad, dtype, None)
    host = stage_wave(rows, wave, pad, dtype, None, None)  # data-parallel shards: host arrays
    want = old_way(rows, wave, pad, dtype)
    assert isinstance(host[0], np.ndarray) and host[0].tobytes() == want[0].tobytes()
    np.testing.assert_array_equal(host[1], want[1])


def test_a_shorter_call_after_a_longer_one_sees_no_stale_samples():
    ring = StagingRing()
    rs = np.random.RandomState(6)
    full = [np.full(2000, 7, np.int16)] * 8
    for _ in range(2):  # both slots full of sevens
        staged_equal(full, 8, 2000, np.int16, ring)
    # the same bytes, shorter rows and fewer of them; then a smaller pad
    staged_equal(ragged(rs, [5, 1999, 0]), 8, 2000, np.int16, ring)
    staged_equal(ragged(rs, [100, 3]), 8, 2000, np.int16, ring)
    staged_equal(ragged(rs, [640, 1]), 4, 1280, np.int16, ring)
    staged_equal(ragged(rs, [20], np.float32), 4, 640, np.float32, ring)
    staged_equal([], 8, 2000, np.int16, ring)


def test_a_slot_is_reused_at_the_same_shape_and_grows_once_for_a_larger():
    ring = StagingRing()
    rows = ragged(np.random.RandomState(7), [500, 800])
    g0 = stage_wave.growths
    for _ in range(2):
        stage_wave(rows, 4, 800, np.int16, "cpu", ring)
    assert stage_wave.growths - g0 == 2  # each slot allocated once
    ptrs = [s.buf.data_ptr() for s in ring.slots]
    for _ in range(4):  # the same shape, a smaller one, another dtype of no more bytes
        stage_wave(rows, 4, 800, np.int16, "cpu", ring)
        stage_wave(rows[:1], 2, 640, np.int16, "cpu", ring)
    stage_wave(rows, 2, 800, np.float32, "cpu", ring)
    assert stage_wave.growths - g0 == 2 and [s.buf.data_ptr() for s in ring.slots] == ptrs
    staged_equal(rows, 8, 800, np.int16, ring)  # a larger wave: the slot in turn grows, once
    assert stage_wave.growths - g0 == 3
    staged_equal(rows, 8, 800, np.int16, ring)
    assert stage_wave.growths - g0 == 4  # the other slot, once
    staged_equal(rows, 8, 800, np.int16, ring)
    staged_equal(rows, 4, 800, np.int16, ring)
    assert stage_wave.growths - g0 == 4


def test_the_counters_count_waves_each_way_and_growths():
    rows = ragged(np.random.RandomState(8), [300, 200])
    before = (stage_wave.pinned_waves, stage_wave.plain_waves, stage_wave.growths)
    ring = StagingRing()
    for _ in range(3):
        stage_wave(rows, 2, 320, np.int16, "cpu", ring)
    stage_wave(rows, 2, 320, np.int16, "cpu", None)
    stage_wave(rows, 2, 320, np.int16, None, None)
    after = (stage_wave.pinned_waves, stage_wave.plain_waves, stage_wave.growths)
    assert tuple(a - b for a, b in zip(after, before)) == (3, 2, 2)


def test_two_threads_never_share_a_slot_in_flight():
    """Four threads on one ring of two slots, each holding its slot a
    moment past its copies: no slot is held by two at once, the threads
    did hold both slots at once, and every wave is the old way's."""
    ring = StagingRing()
    hold, held, errors = ring.hold, [], []

    @contextlib.contextmanager
    def slow_hold(nbytes):
        with hold(nbytes) as slot:
            t0 = time.perf_counter()
            yield slot
            time.sleep(0.002)
            held.append((id(slot), threading.get_ident(), t0, time.perf_counter()))

    ring.hold = slow_hold

    def worker(seed):
        try:
            rs = np.random.RandomState(seed)
            for _ in range(12):
                rows = ragged(rs, rs.randint(0, 1500, size=rs.randint(1, 6)))
                staged_equal(rows, 6, 1500, np.int16, ring)
        except BaseException as e:  # noqa: BLE001 - reported by the main thread
            errors.append(e)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=worker, args=(100 + k,)) for k in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads) and not errors, errors
    assert len(held) == 48 and {s for s, *_ in held} == {id(s) for s in ring.slots}
    at_once = False
    for i, (s1, th1, a1, b1) in enumerate(held):
        for s2, th2, a2, b2 in held[i + 1:]:
            if a1 < b2 and a2 < b1:  # held at once: never one slot
                assert s1 != s2, "two threads held one slot at once"
                at_once |= th1 != th2
    assert at_once


def test_a_ring_for_one_card_only():
    assert api._staging_ring([torch.device("cpu")]) is None
    assert api._staging_ring(["cuda:0", "cuda:0"]) is None  # data-parallel shards stage on the host
    ring = api._staging_ring([torch.device("cuda", 0)])
    assert isinstance(ring, StagingRing) and all(s.buf is None for s in ring.slots)


@pytest.fixture(scope="module")
def artifact(tmp_path_factory):
    """A tiny model's artifact (two rows a wave on the CPU)."""
    from phones_las_torch.models.las import LASConfig, init_las
    from phones_las_torch.models.listener import ListenerConfig
    from phones_las_torch.models.speller import SpellerConfig
    from phones_las_torch.utils.param_io import save_params_npz

    cfg = LASConfig(listener=ListenerConfig(num_layers=2, units=8),
                    speller=SpellerConfig(vocab_size=8, embedding_dim=8, units=8, memory_dim=16,
                                          attention_units=8, attention_layer_size=8))
    path = str(tmp_path_factory.mktemp("staging") / "tiny.npz")
    save_params_npz(path, init_las(cfg, seed=3, device="cpu"), cfg,
                    extras={"vocab": ["a", "b", "c", "d"], "buckets": [16000], "max_target_len": 5})
    return path


@pytest.fixture
def rings_on(monkeypatch):
    """Called: transcribers made after it on the CPU get plain-memory rings,
    as one card's get pinned ones."""
    return lambda: monkeypatch.setattr(
        api, "_staging_ring", lambda devices: StagingRing() if len(devices) == 1 else None)


def test_replicas_do_not_share_a_ring(artifact, rings_on):
    rings_on()
    t = api.Transcriber.from_artifact(artifact, device="cpu")
    reps = t.replicate(2, devices=["cpu", "cpu"])
    rings = [t._ring] + [r._ring for r in reps]
    assert all(isinstance(r, StagingRing) for r in rings) and len({id(r) for r in rings}) == 3
    assert api.Transcriber.from_artifact(artifact, data_parallel=2, devices=["cpu", "cpu"])._ring is None


def test_transcribe_batch_and_decode_aligned_through_a_ring(artifact, rings_on):
    plain = api.Transcriber.from_artifact(artifact, device="cpu", max_device_batch=2)
    assert plain._ring is None
    rings_on()
    t = api.Transcriber.from_artifact(artifact, device="cpu", max_device_batch=2)
    assert isinstance(t._ring, StagingRing)
    rs = np.random.RandomState(9)
    long_call = ragged(rs, [40000, 12000, 33000, 7000, 64000])  # waves of 2, 2 and 1
    short_call = ragged(rs, [5000])
    mixed = [long_call[0], (rs.randn(9000) * 3000).astype(np.float32)]
    pinned0, plain0 = stage_wave.pinned_waves, stage_wave.plain_waves
    for call in (long_call, short_call, mixed, long_call):
        assert t.transcribe_batch(call) == plain.transcribe_batch(call)
    assert stage_wave.pinned_waves - pinned0 == 8 and stage_wave.plain_waves - plain0 == 8
    windows = ragged(rs, [16000, 9000, 16000])
    for ws in (windows, windows[1:2]):
        for (ids, times), (pids, ptimes) in zip(t.decode_aligned(ws, window_samples=16000),
                                                plain.decode_aligned(ws, window_samples=16000)):
            np.testing.assert_array_equal(ids, pids)
            np.testing.assert_array_equal(times, ptimes)
    with pytest.raises(ValueError, match="window of 16001 samples exceeds 16000"):
        t.decode_aligned([windows[0], np.zeros(16001, np.int16)], window_samples=16000)
