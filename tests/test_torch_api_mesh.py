"""Several devices through the library API on the CPU, mirroring
``tests/test_api_mesh.py`` and ``tests/test_serve.py::test_replicated_serving``:
a ``Transcriber`` with ``data_parallel`` > 1 splits each wave into equal
shards, one a device of ``devices=`` (a list that names the CPU more than
once here), and must give the tokens of the single-device path, greedy,
beam and long-form; ``replicate`` makes whole copies that a server's
drainers share one queue with."""

import json
import threading
import urllib.request

import numpy as np
import pytest
import torch

from phones_las_torch.api import Transcriber
from phones_las_torch.cli import prepare as prepare_cli
from phones_las_torch.cli import train as train_cli
from phones_las_torch.cli.serve import make_server
from tests.torch_threads import one_thread

one_thread()


@pytest.fixture(scope="module")
def workdir(tmp_path_factory):
    root = tmp_path_factory.mktemp("api_mesh")
    data, wd = str(root / "d"), str(root / "w")
    prepare_cli.main(["synthetic", "--out", data, "--n-utts", "10", "--n-phones", "4", "--device", "cpu"])
    train_cli.main([
        "--preset", "timit_phone_las", "--data", data, "--workdir", wd, "--num-steps", "2", "--batch-size", "4",
        "--encoder-layers", "2", "--encoder-units", "16", "--decoder-units", "16", "--embedding-dim", "8",
        "--attention-units", "16", "--device", "cpu",
    ])
    return wd


def test_data_parallel_matches_single_device(workdir):
    rs = np.random.RandomState(0)
    clips = [(rs.randn(6000 + 700 * i) * 2000).astype(np.int16) for i in range(6)]
    ref = Transcriber(workdir, device="cpu").transcribe_batch(clips)

    t4 = Transcriber(workdir, data_parallel=4, devices=["cpu"] * 4, max_device_batch=2)
    assert t4.data_parallel == 4 and len(t4._shard_params) == 4
    assert t4._shard_params[1] is not t4.params  # a copy of the weights a shard
    # 6 clips → one wave of 8 (rounded up to a multiple of the shards)
    assert t4._wave_size(6) == 8
    assert t4.transcribe_batch(clips) == ref

    # data_parallel=0: every device given
    t_all = Transcriber(workdir, data_parallel=0, devices=["cpu"] * 3)
    assert t_all.data_parallel == 3
    assert t_all.transcribe_batch(clips) == ref


def test_data_parallel_beam_and_long_form(workdir):
    rs = np.random.RandomState(1)
    audio = (rs.randn(2 * 16000 + 123) * 2000).astype(np.int16)
    for kw in ({"window_seconds": 0.8, "overlap_seconds": 0.3},
               {"window_seconds": 0.8, "overlap_seconds": 0.3, "segmentation": "overlap"}):
        ref = Transcriber(workdir, device="cpu").transcribe_long(audio, **kw)
        t2 = Transcriber(workdir, data_parallel=2, devices=["cpu", "cpu"], max_device_batch=4)
        assert t2.transcribe_long(audio, **kw) == ref
    clips = [audio[:9000], audio[9000:18000], audio[18000:21000]]
    ref_b = Transcriber(workdir, beam_width=2, device="cpu").transcribe_batch(clips)
    t2b = Transcriber(workdir, beam_width=2, data_parallel=2, devices=["cpu", "cpu"])
    assert t2b.transcribe_batch(clips) == ref_b


def test_device_counts_and_exclusive_modes(workdir):
    """More devices than exist is refused naming the count; ``replicate``
    and ``data_parallel`` exclude each other; device= and devices= too."""
    with pytest.raises(ValueError, match="2 devices asked for, but only 1 cpu"):
        Transcriber(workdir, device="cpu", data_parallel=2)
    t = Transcriber(workdir, device="cpu")
    with pytest.raises(ValueError, match="3 devices asked for, but only 1 cpu"):
        t.replicate(3)
    with pytest.raises(ValueError, match="exclusive"):
        Transcriber(workdir, data_parallel=2, devices=["cpu", "cpu"]).replicate(2, devices=["cpu", "cpu"])
    with pytest.raises(ValueError, match="not both"):
        Transcriber(workdir, device="cpu", devices=["cpu"])
    assert [r.device for r in t.replicate(0)] == [torch.device("cpu")]


def _post(url, data):
    req = urllib.request.Request(url, data=data)
    with urllib.request.urlopen(req, timeout=120) as r:
        return r.status, json.loads(r.read())


def test_replicated_serving(workdir):
    """``replicate``: each replica holds its own copy of the weights and
    answers as the original; ``make_server`` over the list drains one
    queue with a thread a replica, the first replica taking the rest."""
    t = Transcriber(workdir, device="cpu")
    reps = t.replicate(2, devices=["cpu", "cpu"])
    assert len(reps) == 2 and reps[0].params is not reps[1].params
    assert reps[0].params.speller.out_w.data_ptr() != t.params.speller.out_w.data_ptr()

    rs = np.random.RandomState(11)
    pcms = [(rs.randn(8000) * 2000).astype(np.int16) for _ in range(6)]
    expected = [t.transcribe(p) for p in pcms]
    for r in reps:
        assert [r.transcribe(p) for p in pcms] == expected

    server, worker = make_server(reps, "127.0.0.1", 0, max_batch=2, batch_wait_ms=5.0)
    assert len(worker.replicas) == 2 and worker.t is reps[0] and len(worker._threads) == 2
    threading.Thread(target=server.serve_forever, daemon=True).start()
    try:
        base = f"http://127.0.0.1:{server.server_address[1]}"
        results = [None] * len(pcms)

        def hit(i):
            results[i] = _post(base + "/transcribe?raw=1", pcms[i].tobytes())

        ths = [threading.Thread(target=hit, args=(i,)) for i in range(len(pcms))]
        for th in ths:
            th.start()
        for th in ths:
            th.join(timeout=120)
            assert not th.is_alive()
        assert [r[0] for r in results] == [200] * len(pcms)
        assert [r[1]["tokens"] for r in results] == expected
        assert sum(worker.served) >= len(pcms) // 2 and worker.q.qsize() == 0
    finally:
        worker.stop()
        server.shutdown()
        server.server_close()
