"""The port's serving CLI (``phones_las_torch/cli/serve.py``, plain PyTorch
on the CPU) against the JAX package's: ``StreamSession`` feed by feed in
pause and overlap modes on the committed long-gate artifact; the HTTP
server's batched, streaming, chunked and long-upload routes answering
with the JAX ``Transcriber``'s tokens; the session endpoints and their
TTL; 429 + Retry-After and the canned 503; and the numerics scope shared
by the server's threads (fault C3)."""

import http.client
import json
import os
import re
import socket
import sys
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from phones_las_tpu import api as japi
from phones_las_tpu.cli import serve as jserve
from phones_las_tpu.data.speechlike import make_phonotactics, speechlike_phone_inventory, synth_speech_utterance
from phones_las_tpu.data.vocab import Vocab as JaxVocab

from phones_las_torch import api
from phones_las_torch.cli.serve import StreamSession, make_server
from phones_las_torch.data.audio_io import write_wav
from phones_las_torch.data.vocab import Vocab
from phones_las_torch.utils.device import matmul_precision_scope
from tests.torch_threads import one_thread

one_thread()

ASSET = os.path.join(os.path.dirname(__file__), "goldens", "long_gate.npz")
SR = 16000
WIN, OV = 1.5, 0.5  # the sessions' window and overlap (pause: search) in seconds
CHUNK = SR // 2


@pytest.fixture(scope="module")
def gate():
    """The long-gate artifact in both packages, a ~5 s stream and a ~2 s
    utterance of its language."""
    vocab, lang = JaxVocab(speechlike_phone_inventory()), make_phonotactics(1234)
    stream = synth_speech_utterance(np.random.RandomState(9002), vocab, "stream", model=lang,
                                    n_syllables_range=(16, 16), word_syllables=(1, 3), snr_db_range=(10.0, 30.0))
    utt = synth_speech_utterance(np.random.RandomState(9003), vocab, "utt", model=lang,
                                 n_syllables_range=(6, 6), word_syllables=(1, 3), snr_db_range=(10.0, 30.0))
    return (api.Transcriber.from_artifact(ASSET, device="cpu"), japi.Transcriber.from_artifact(ASSET),
            stream.audio, utt.audio)


def _serve(t, **kw):
    server, worker = make_server(t, "127.0.0.1", 0, **kw)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    return server, worker, f"http://127.0.0.1:{server.server_address[1]}"


def _stop(server, worker):
    worker.stop()
    server.shutdown()
    server.server_close()


def _post(url, data, headers=None):
    req = urllib.request.Request(url, data=data, headers=headers or {})
    try:
        with urllib.request.urlopen(req, timeout=120) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


@pytest.mark.parametrize("segmentation", ["pause", "overlap"])
def test_stream_session_matches_jax(gate, segmentation):
    """Every feed's tokens and ``end()``'s equal JAX's session fed the same
    chunks, and their concatenation equals ``transcribe_long``."""
    t, jt, audio, _ = gate
    kw = dict(window_seconds=WIN, overlap_seconds=OV, segmentation=segmentation)
    sess, jsess = StreamSession(t, **kw), jserve.StreamSession(jt, **kw)
    toks = []
    for ofs in range(0, len(audio), CHUNK):
        got = sess.feed(audio[ofs: ofs + CHUNK])
        assert got == jsess.feed(audio[ofs: ofs + CHUNK]), ofs
        toks += got
    got = sess.end()
    assert got == jsess.end()
    toks += got
    assert (sess.n_windows, sess.n_tokens) == (jsess.n_windows, jsess.n_tokens)
    assert sess.n_windows > 2 and len(toks) > 25
    assert toks == t.transcribe_long(audio, **kw)
    with pytest.raises(ValueError, match="already ended"):
        sess.feed(audio[:100])


def test_stream_session_short_empty_and_bad_params(gate):
    """A stream within one window delegates to ``transcribe`` as
    ``transcribe_long`` does; an empty one gives nothing; the default
    geometry is the model's; bad client values raise ``ValueError``."""
    t, jt, audio, _ = gate
    sess = StreamSession(t, window_seconds=2.0, overlap_seconds=0.5)
    assert sess.feed(audio[:8000]) == []
    assert sess.end() == t.transcribe(audio[:8000]) == jt.transcribe(audio[:8000])
    assert StreamSession(t).end() == []
    assert StreamSession(t).win == jserve.StreamSession(jt).win
    for kw in ({"window_seconds": 1.0, "overlap_seconds": 1.0}, {"window_seconds": 2.0, "overlap_seconds": 1.5},
               {"segmentation": "bogus"}):
        with pytest.raises(ValueError):
            StreamSession(t, **kw)


def test_http_roundtrip_matches_jax(gate, tmp_path):
    """WAV and raw uploads, two concurrent requests, the 400s and the
    metrics: the tokens are the JAX ``Transcriber``'s."""
    t, jt, _, utt = gate
    want = jt.transcribe(utt)
    assert len(want) > 10
    server, worker, base = _serve(t, max_batch=4, batch_wait_ms=100.0)
    try:
        with urllib.request.urlopen(base + "/healthz", timeout=30) as r:
            health = json.loads(r.read())
        assert health == {"status": "ok", "vocab_size": len(t.vocab.tokens), "head": "phone", "sample_rate": SR}
        wav = str(tmp_path / "u.wav")
        write_wav(wav, utt, SR)
        with open(wav, "rb") as f:
            assert _post(base + "/transcribe", f.read()) == (200, {"tokens": want, "utt_seconds": round(len(utt) / SR, 3)})
        results = [None, None]

        def hit(i):
            results[i] = _post(base + "/transcribe?raw=1", utt.tobytes())

        ths = [threading.Thread(target=hit, args=(i,)) for i in range(2)]
        [th.start() for th in ths]
        [th.join(timeout=120) for th in ths]
        assert [(c, r["tokens"]) for c, r in results] == [(200, want)] * 2
        code, res = _post(base + "/transcribe", b"not audio")
        assert code == 400 and "decode failed" in res["error"]
        assert _post(base + "/transcribe?raw=1", b"")[0] == 400
        assert _post(base + "/nope", b"x") == (404, {"error": "not found"})
        with urllib.request.urlopen(base + "/metrics", timeout=30) as r:
            text = r.read().decode()
        assert 'plu_requests_total{endpoint="/transcribe",status="200"} 3' in text
        assert 'plu_requests_total{endpoint="/transcribe",status="400"} 2' in text
        assert 'plu_requests_total{endpoint="other",status="404"} 1' in text
        assert "plu_queue_depth 0" in text and "plu_request_latency_seconds_count 3" in text
        counter = lambda name: int(re.search(rf"^{name} (\d+)$", text, re.M).group(1))
        # the WAV upload alone, then the two concurrent requests in one batch or two
        assert counter("plu_batched_requests_total") == 3 and 2 <= counter("plu_batches_total") <= 3
    finally:
        _stop(server, worker)


def test_streaming_response_long_upload_and_chunked_body(gate):
    """``?stream=1`` gives NDJSON lines whose tokens join to JAX's
    ``transcribe_long``; an upload above the threshold takes the long-form
    path; a chunked upload is decoded; a malformed one is a clean 400."""
    t, jt, audio, utt = gate
    server, worker, base = _serve(t, max_batch=2, long_form_threshold_s=5.0)
    try:
        url = base + f"/transcribe?raw=1&stream=1&window_s={WIN}&overlap_s={OV}"
        with urllib.request.urlopen(urllib.request.Request(url, data=audio.tobytes()), timeout=300) as r:
            assert r.headers["Content-Type"] == "application/x-ndjson"
            lines = [json.loads(x) for x in r.read().decode().splitlines()]
        assert len(lines) > 2 and lines[-1]["final"] is True
        toks = [tok for ln in lines for tok in ln["tokens"]]
        assert toks == jt.transcribe_long(audio, window_seconds=WIN, overlap_seconds=OV)
        assert lines[-1]["total_tokens"] == len(toks)

        # ~10 s > the 5 s threshold and the model's 7.125 s window: segments
        # of the default long-form geometry
        long = np.concatenate([audio, audio])
        code, res = _post(base + "/transcribe?raw=1", long.tobytes())
        assert code == 200 and res["tokens"] == jt.transcribe_long(long)

        conn = http.client.HTTPConnection("127.0.0.1", server.server_address[1], timeout=120)
        conn.putrequest("POST", "/transcribe?raw=1")
        conn.putheader("Transfer-Encoding", "chunked")
        conn.endheaders()
        body = utt.tobytes()
        for i in range(0, len(body), 10000):
            conn.send(b"%x\r\n" % len(body[i: i + 10000]) + body[i: i + 10000] + b"\r\n")
        conn.send(b"0\r\n\r\n")
        resp = conn.getresponse()
        assert (resp.status, json.loads(resp.read())["tokens"]) == (200, jt.transcribe(utt))
        conn.close()

        conn = http.client.HTTPConnection("127.0.0.1", server.server_address[1], timeout=120)
        conn.putrequest("POST", "/transcribe?raw=1")
        conn.putheader("Transfer-Encoding", "chunked")
        conn.endheaders()
        conn.send(b"NOT_HEX\r\ngarbage\r\n0\r\n\r\n")
        resp = conn.getresponse()
        assert resp.status == 400 and resp.version == 11
        assert "bad body" in json.loads(resp.read())["error"]
        conn.close()
    finally:
        _stop(server, worker)


def test_stream_endpoints_and_ttl(gate):
    """/stream/start → chunks → /end equals JAX's ``transcribe_long``; the
    session is gone after /end; unknown ids are 404 and bad params 400; an
    idle session is evicted by the next start."""
    t, jt, audio, _ = gate
    server, worker, base = _serve(t, max_batch=2, session_ttl_s=1.0)
    try:
        code, res = _post(base + f"/stream/start?window_s={WIN}&overlap_s={OV}", b"")
        assert code == 200, res
        sid, toks = res["id"], []
        for ofs in range(0, len(audio), 2 * CHUNK):
            code, res = _post(base + f"/stream/{sid}", audio[ofs: ofs + 2 * CHUNK].tobytes())
            assert code == 200, res
            toks += res["tokens"]
        code, res = _post(base + f"/stream/{sid}/end", b"")
        assert code == 200
        toks += res["tokens"]
        assert toks == jt.transcribe_long(audio, window_seconds=WIN, overlap_seconds=OV)
        assert res["total_tokens"] == len(toks) and res["total_seconds"] == round(len(audio) / SR, 3)
        assert _post(base + f"/stream/{sid}", b"\x00\x00")[0] == 404
        assert _post(base + "/stream/nope", b"\x00\x00")[0] == 404
        assert _post(base + "/stream/start?window_s=0.1&overlap_s=0.5", b"")[0] == 400

        stale = _post(base + "/stream/start", b"")[1]["id"]
        time.sleep(1.2)
        fresh = _post(base + "/stream/start", b"")[1]["id"]  # sweeps the idle one
        assert _post(base + f"/stream/{stale}", b"\x00\x00")[0] == 404
        assert _post(base + f"/stream/{fresh}", b"\x00\x00")[0] == 200
        with urllib.request.urlopen(base + "/metrics", timeout=30) as r:
            assert "plu_stream_sessions 1" in r.read().decode()
    finally:
        _stop(server, worker)


class _SlowTranscriber:
    """Stands in for a ``Transcriber`` whose batches take 200 ms."""

    sample_rate = _sample_rate = SR
    vocab = Vocab(["a"])

    def transcribe_batch(self, pcms):
        time.sleep(0.2)
        return [["a"]] * len(pcms)


def test_overload_429_retry_after_and_canned_503():
    """A full queue answers 429 with Retry-After at once; beyond the
    in-flight cap a connection gets the canned 503 without a handler."""
    slow = _SlowTranscriber()
    server, worker, base = _serve(slow, max_batch=1, batch_wait_ms=50.0, max_pending=2, max_inflight=0)
    try:
        results, lock = [], threading.Lock()

        def client():
            req = urllib.request.Request(base + "/transcribe?raw=1", data=np.zeros(800, np.int16).tobytes())
            t0 = time.monotonic()
            try:
                with urllib.request.urlopen(req, timeout=60) as r:
                    out = (r.status, json.loads(r.read()), None)
            except urllib.error.HTTPError as e:
                out = (e.code, json.loads(e.read()), e.headers.get("Retry-After"))
            with lock:
                results.append(out + (time.monotonic() - t0,))

        ths = [threading.Thread(target=client) for _ in range(12)]
        [th.start() for th in ths]
        [th.join(timeout=60) for th in ths]
        codes = [r[0] for r in results]
        assert len(codes) == 12 and set(codes) == {200, 429}, codes
        assert all(r[1] == {"tokens": ["a"], "utt_seconds": 0.05} for r in results if r[0] == 200)
        rejected = [r for r in results if r[0] == 429]
        assert all("capacity" in r[1]["error"] and int(r[2]) >= 1 and r[3] < 2.0 for r in rejected)
        assert worker.q.maxsize == 2
    finally:
        _stop(server, worker)

    server, worker, base = _serve(slow, max_batch=1, max_pending=64, max_inflight=1)
    try:
        port = server.server_address[1]
        hog = socket.create_connection(("127.0.0.1", port))
        hog.sendall(b"POST /transcribe?raw=1 HTTP/1.1\r\nHost: x\r\nContent-Length: 16000\r\n\r\n")
        time.sleep(0.3)  # the one in-flight slot is taken
        s = socket.create_connection(("127.0.0.1", port))
        s.settimeout(5)
        resp = b""
        while b"\r\n\r\n" not in resp or not resp.endswith(b"}"):
            chunk = s.recv(4096)
            if not chunk:
                break
            resp += chunk
        assert resp.startswith(b"HTTP/1.1 503") and b"Retry-After: 1" in resp and b"capacity" in resp
        s.close()
        hog.close()
    finally:
        _stop(server, worker)


def test_precision_scope_holds_across_threads():
    """Fault C3: two threads in production-mode scopes; the first leaves
    while the second is inside. TF32 must stay on for the second and be
    off again once both have left; another mode cannot enter meanwhile;
    many threads entering and leaving keep both invariants."""
    before = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    first_in, second_in, first_out = threading.Event(), threading.Event(), threading.Event()
    seen, errors = {}, []

    def first():
        with matmul_precision_scope("default"):
            first_in.set()
            second_in.wait(10)
        first_out.set()

    def second():
        first_in.wait(10)
        with matmul_precision_scope("default"):
            second_in.set()
            first_out.wait(10)
            seen["inside"] = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
            try:
                with matmul_precision_scope("highest"):
                    pass
            except RuntimeError as e:
                errors.append(str(e))

    switch = sys.getswitchinterval()
    try:
        ths = [threading.Thread(target=first), threading.Thread(target=second)]
        [th.start() for th in ths]
        [th.join(timeout=20) for th in ths]
        assert not any(th.is_alive() for th in ths)
        assert seen["inside"] == (True, True)
        assert (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32) == (False, False)
        assert len(errors) == 1 and "process-wide" in errors[0]

        sys.setswitchinterval(1e-6)
        bad = []

        def churn():
            for _ in range(300):
                with matmul_precision_scope("default"):
                    if not torch.backends.cuda.matmul.allow_tf32:
                        bad.append(1)

        ths = [threading.Thread(target=churn) for _ in range(16)]
        [th.start() for th in ths]
        [th.join(timeout=60) for th in ths]
        assert not any(th.is_alive() for th in ths) and not bad
        assert (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32) == (False, False)
    finally:
        sys.setswitchinterval(switch)
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = before
