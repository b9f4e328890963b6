"""Serving CLI: micro-batching HTTP transcription server (port of
``phones_las_tpu/cli/serve.py``; the same routes, limits, metric names and
answers).

Requests are collected into micro-batches so the card always sees batched
work: the front-end, BiLSTM and greedy-decoder kernels run each
micro-batch; streaming sessions and long uploads decode their segments
through ``Transcriber.decode_aligned``. One ``Transcriber`` serves, or
with ``--replicas`` one copy a card, each drained by a thread of its own
from one queue; ``--data-parallel`` shards each micro-batch over cards.

    python -m phones_las_torch.cli.serve --workdir runs/ls --port 8080

    POST /transcribe    body = a WAV/FLAC/SPHERE/MP3 file, or raw int16
                        PCM with ``?raw=1&rate=16000``
                        → {"tokens": [...], "utt_seconds": ...}
                        ``?stream=1``: chunked NDJSON response — one
                        line of finalized tokens (+ window progress)
                        per decoded window as the long-form decode
                        progresses, then a ``"final": true`` line (same
                        transcript as the offline path)
    POST /stream/start, /stream/<id>, /stream/<id>/end
                        incremental sessions (``StreamSession``)
    GET  /healthz       → {"status": "ok", "vocab_size": ..., ...}
    GET  /metrics       Prometheus text (``plu_*`` counters)

Uploads may use ``Transfer-Encoding: chunked`` (decoded server-side;
stdlib doesn't) — clients can stream a recording without knowing its
size up front.

Stdlib-only (ThreadingHTTPServer); each request thread enqueues its PCM
and waits; a worker drains the queue every ``--batch-wait-ms`` (or as
soon as ``--max-batch`` is queued) and answers the whole batch with one
device dispatch. The request threads and the drainer share the
``Transcriber`` and its numerics scope (``utils/device.py::
matmul_precision_scope``, which holds across threads).
"""

from __future__ import annotations

import argparse
import json
import queue
import tempfile
import threading
from typing import Dict, List, Optional

import numpy as np

from phones_las_torch.cli.common import add_device_arg, parse_devices


class _Pending:
    __slots__ = ("pcm", "event", "result", "error")

    def __init__(self, pcm: np.ndarray):
        self.pcm = pcm
        self.event = threading.Event()
        self.result: Optional[List[str]] = None
        self.error: Optional[str] = None


class Metrics:
    """Thread-safe serving counters, rendered in Prometheus text format
    (``GET /metrics``). Stdlib-only, like the rest of the server."""

    _LAT_BUCKETS = (0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0)

    def __init__(self):
        self.lock = threading.Lock()
        self.requests = {}          # (endpoint, status) → count
        self.batches = 0
        self.batched_requests = 0   # sum of per-batch fill
        self.utt_seconds = 0.0
        self.lat_buckets = [0] * (len(self._LAT_BUCKETS) + 1)
        self.lat_sum = 0.0
        self.lat_count = 0

    def request(self, endpoint: str, status: int):
        with self.lock:
            k = (endpoint, status)
            self.requests[k] = self.requests.get(k, 0) + 1

    def batch(self, fill: int):
        with self.lock:
            self.batches += 1
            self.batched_requests += fill

    def audio(self, seconds: float):
        with self.lock:
            self.utt_seconds += seconds

    def latency(self, seconds: float):
        with self.lock:
            for i, ub in enumerate(self._LAT_BUCKETS):
                if seconds <= ub:
                    self.lat_buckets[i] += 1
                    break
            else:
                self.lat_buckets[-1] += 1
            self.lat_sum += seconds
            self.lat_count += 1

    def render(self, extra_gauges=()) -> str:
        with self.lock:
            lines = [
                "# TYPE plu_requests_total counter",
            ]
            for (ep, st), n in sorted(self.requests.items()):
                lines.append(
                    f'plu_requests_total{{endpoint="{ep}",status="{st}"}} {n}'
                )
            lines += [
                "# TYPE plu_batches_total counter",
                f"plu_batches_total {self.batches}",
                "# TYPE plu_batched_requests_total counter",
                f"plu_batched_requests_total {self.batched_requests}",
                "# TYPE plu_audio_seconds_total counter",
                f"plu_audio_seconds_total {self.utt_seconds:.3f}",
                "# TYPE plu_request_latency_seconds histogram",
            ]
            acc = 0
            for ub, n in zip(self._LAT_BUCKETS, self.lat_buckets):
                acc += n
                lines.append(
                    f'plu_request_latency_seconds_bucket{{le="{ub}"}} {acc}'
                )
            lines.append(
                f'plu_request_latency_seconds_bucket{{le="+Inf"}} '
                f"{acc + self.lat_buckets[-1]}"
            )
            lines.append(
                f"plu_request_latency_seconds_sum {self.lat_sum:.4f}"
            )
            lines.append(
                f"plu_request_latency_seconds_count {self.lat_count}"
            )
            for name, value in extra_gauges:
                lines.append(f"# TYPE {name} gauge")
                lines.append(f"{name} {value}")
            return "\n".join(lines) + "\n"


class BatchingWorker:
    """Collects pending requests into micro-batches and transcribes each
    batch with one device dispatch, on a drainer thread of its own.

    Given a list of transcribers (``Transcriber.replicate()``) for
    replica-per-card serving, each has a drainer thread on the one shared
    queue, so an idle card takes the next micro-batch as soon as it is
    free (no router). ``served[i]`` counts replica i's batches."""

    def __init__(self, transcriber, max_batch: int = 16,
                 batch_wait_ms: float = 20.0, metrics: "Metrics" = None,
                 max_pending: int = 128):
        ts = list(transcriber) if isinstance(transcriber, (list, tuple)) else [transcriber]
        self.t = ts[0]
        self.replicas = ts
        self.served = [0] * len(ts)
        self.metrics = metrics
        self.max_batch = max_batch
        self.wait_s = batch_wait_ms / 1000.0
        # bounded: under overload, admission fails fast (HTTP 429) instead
        # of growing the queue — and the thread pinned to each entry —
        # without bound. 0 → unbounded.
        self.max_pending = max_pending
        self.q: "queue.Queue[_Pending]" = queue.Queue(maxsize=max_pending)
        # rolling per-batch service time (seconds) — feeds Retry-After;
        # seeded with the batch-open window until the first measurement
        self.batch_seconds = max(self.wait_s, 0.05)
        self._stop = False
        self._threads = [threading.Thread(target=self._run, args=(i,), daemon=True) for i in range(len(ts))]
        for th in self._threads:
            th.start()

    def submit(self, pcm: np.ndarray) -> _Pending:
        """Raises ``queue.Full`` when ``max_pending`` requests are already
        waiting — the caller maps that to 429 + Retry-After."""
        p = _Pending(pcm)
        self.q.put_nowait(p)
        return p

    def stop(self):
        self._stop = True

    def _drain(self) -> List[_Pending]:
        import time

        batch = [self.q.get()]  # block for the first request
        deadline = time.monotonic() + self.wait_s
        try:
            while len(batch) < self.max_batch:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    break
                batch.append(self.q.get(timeout=remaining))
        except queue.Empty:
            pass
        return batch

    def _run(self, replica: int):
        t = self.replicas[replica]
        while not self._stop:
            try:
                batch = self._drain()
            except Exception:
                continue
            if self.metrics is not None:
                self.metrics.batch(len(batch))
            try:
                # pad to a fixed batch size, so the card sees the shapes the
                # server warmed (one per pad quantum) whatever the fill
                import time

                pcms = [p.pcm for p in batch]
                pad_rows = self.max_batch - len(pcms)
                if pad_rows > 0:
                    pcms += [np.zeros(1600, np.int16)] * pad_rows
                t0 = time.monotonic()
                results = t.transcribe_batch(pcms)
                dt = time.monotonic() - t0
                # EMA over batch service time (no lock: float store is
                # atomic and Retry-After only needs an estimate)
                self.batch_seconds = 0.8 * self.batch_seconds + 0.2 * dt
                for p, r in zip(batch, results):
                    p.result = r
                self.served[replica] += 1
            except BaseException as e:  # answer the whole batch with the
                # error — including KeyboardInterrupt/SystemExit: dying
                # without setting the events would hang every waiting
                # request thread forever while /healthz still answers
                for p in batch:
                    p.error = f"{type(e).__name__}: {e}"
                if not isinstance(e, Exception):
                    for p in batch:
                        p.event.set()
                    raise
            for p in batch:
                p.event.set()


class StreamSession:
    """Incremental long-form transcription session.

    Audio arrives in chunks. With ``segmentation="pause"`` (default), a
    segment is decoded as soon as its end cut is final — the cut snaps to
    the energy minimum near the nominal window boundary
    (``api.PauseSegmenter``), which needs only the smoothing lookahead —
    and *all* its tokens are returned immediately (cuts sit in pauses, so
    no token straddles one). With ``segmentation="overlap"``, complete
    fixed-stride sliding windows are decoded as soon as the *next* window
    is guaranteed to exist (so each window's ownership range under the
    overlap-midpoint cut rule — see ``api.merge_window_hypotheses`` — is
    already final), and the tokens they own are returned. ``end()``
    decodes the partial tail and flushes the rest. Either way the final
    concatenated transcript is identical to
    ``Transcriber.transcribe_long`` (same mode) over the whole recording.
    """

    def __init__(self, transcriber, window_seconds: Optional[float] = None,
                 overlap_seconds: float = 2.0,
                 max_tokens_per_second: float = 25.0,
                 segmentation: str = "pause"):
        sr = transcriber.sample_rate
        self.t = transcriber
        if window_seconds is None:
            # match Transcriber.transcribe_long: pause mode sizes the
            # window (and clamps the search width) to the trained bucket
            # lengths (segments past every training length trigger
            # decoder runaway)
            if segmentation == "pause":
                window_seconds, overlap_seconds = (
                    transcriber.long_form_geometry(overlap_seconds)
                )
            else:
                window_seconds = 20.0
        self.win = int(window_seconds * sr)
        self.ov = int(overlap_seconds * sr)
        # explicit raise, not assert: these gate client-supplied values
        # (0 < overlap < window also guarantees hop > 0, i.e. feed's
        # window enumeration always advances) and must survive python -O
        if not 0 < self.ov < self.win:
            raise ValueError(
                f"need 0 < overlap ({self.ov}) < window ({self.win})"
            )
        if segmentation not in ("pause", "overlap"):
            raise ValueError(f"unknown segmentation {segmentation!r}")
        self.segmentation = segmentation
        self.seg = None
        if segmentation == "pause":
            from phones_las_torch.api import PauseSegmenter

            try:
                self.seg = PauseSegmenter(sr, self.win, self.ov)
            except ValueError as e:  # client-supplied overlap ≥ window/2
                raise ValueError(str(e))
        self.hop = self.win - self.ov
        self.mtps = max_tokens_per_second
        self.rate = sr          # client sample rate (resampled on feed)
        self._chunks: List[np.ndarray] = []
        self.base = 0           # absolute position of the buffer's first sample
        self.total = 0          # samples received
        self.next_start = 0     # absolute start of the next window to decode
        self.prev_cut = 0       # pause mode: absolute end of the last segment
        self.n_windows = 0      # windows decoded so far
        self.n_tokens = 0       # tokens emitted so far
        self.ended = False
        self.last_used = 0.0    # monotonic time of the last feed (TTL sweep)
        self.lock = threading.Lock()

    def _audio(self) -> np.ndarray:
        if len(self._chunks) > 1:
            self._chunks = [np.concatenate(self._chunks)]
        return self._chunks[0] if self._chunks else np.zeros(0, np.int16)

    def _decode(self, starts: List[int], last_is_final: bool) -> List[str]:
        """Decode the windows at ``starts`` and return the token strings
        they own (lo/hi per the overlap-midpoint rule)."""
        audio = self._audio()
        decoded = self.t.decode_aligned(
            [audio[s - self.base : s - self.base + self.win] for s in starts],
            window_samples=self.win, max_tokens_per_second=self.mtps,
        )
        out_ids = []
        for j, (s, (ids, times)) in enumerate(zip(starts, decoded)):
            idx = self.n_windows + j
            lo = -np.inf if idx == 0 else s + self.ov / 2.0
            hi = (
                np.inf
                if (last_is_final and j == len(starts) - 1)
                else s + self.hop + self.ov / 2.0
            )
            for tok, tm in zip(ids, s + times):
                if lo <= tm < hi:
                    out_ids.append(int(tok))
        self.n_windows += len(starts)
        self.n_tokens += len(out_ids)
        return self.t.vocab.decode(np.asarray(out_ids, np.int64))

    def _decode_segments(self, bounds: List) -> List[str]:
        """Pause mode: decode the segments at ``bounds`` (absolute
        ``(start, end)`` pairs) and return all their tokens — cuts sit in
        pauses, so every token is final at decode time."""
        audio = self._audio()
        pad = self.win + 2 * self.ov
        decoded = self.t.decode_aligned(
            [audio[a - self.base : b - self.base] for a, b in bounds],
            window_samples=pad,
            max_tokens_per_second=self.mtps,
            steps_cap=self.t._long_form_cap(pad, self.mtps),
        )
        out_ids = [int(tok) for ids, _ in decoded for tok in ids]
        self.n_windows += len(bounds)
        self.n_tokens += len(out_ids)
        return self.t.vocab.decode(np.asarray(out_ids, np.int64))

    def _pause_cuts(self, ended: bool) -> List:
        """Advance ``prev_cut`` through every now-final cut; return the
        finalized segment bounds."""
        bounds = []
        audio = self._audio()
        while True:
            c = self.seg.next_cut(
                audio, self.base, self.prev_cut, self.total, ended
            )
            if c is None:
                break
            bounds.append((self.prev_cut, int(c)))
            self.prev_cut = int(c)
        return bounds

    def feed(self, pcm: np.ndarray) -> List[str]:
        with self.lock:
            if self.ended:
                raise ValueError("session already ended")
            self._chunks.append(np.asarray(pcm))
            self.total += len(pcm)
            if self.seg is not None:
                bounds = self._pause_cuts(ended=False)
                out = self._decode_segments(bounds) if bounds else []
                # samples before the last cut are never read again; keep
                # the buffer start frame-aligned so the segmenter's
                # absolute framing (and therefore its cuts) match the
                # offline pass
                keep = (self.prev_cut // self.seg.f) * self.seg.f
                if keep > self.base:
                    audio = self._audio()
                    self._chunks = [audio[keep - self.base :]]
                    self.base = keep
                return out
            # a window is decodable once the stream extends strictly past
            # it: then the next window exists in the final enumeration
            # (total > s + win = s_next + overlap ⇒ s_next < total − overlap)
            # and this window's hi-cut is already correct
            starts = []
            while self.next_start + self.win < self.total:
                starts.append(self.next_start)
                self.next_start += self.hop
            out = self._decode(starts, last_is_final=False) if starts else []
            # samples before the next window's start are never read again
            if self.next_start > self.base:
                audio = self._audio()
                self._chunks = [audio[self.next_start - self.base :]]
                self.base = self.next_start
            return out

    def end(self) -> List[str]:
        with self.lock:
            if self.ended:
                raise ValueError("session already ended")
            self.ended = True
            if self.n_windows == 0 and self.total <= self.win:
                # short stream: exactly what transcribe_long does for
                # audio within one window — delegate to transcribe() so
                # the transcript is identical with or without streaming
                # (decode_aligned's mtps-derived step cap and window
                # padding can differ from the plain path)
                audio = self._audio()
                self._chunks = []
                if self.total == 0:
                    return []
                out = self.t.transcribe(audio)
                self.n_windows += 1
                self.n_tokens += len(out)
                return out
            if self.seg is not None:
                bounds = self._pause_cuts(ended=True)
                if self.prev_cut < self.total:  # the tail segment
                    bounds.append((self.prev_cut, self.total))
                    self.prev_cut = self.total
                out = self._decode_segments(bounds) if bounds else []
                self._chunks = []
                return out
            starts = []
            s = self.next_start
            while s < self.total - self.ov:
                starts.append(s)
                s += self.hop
            out = self._decode(starts, last_is_final=True) if starts else []
            self._chunks = []
            return out


def make_server(transcriber, host: str, port: int, *, max_batch: int = 16,
                batch_wait_ms: float = 20.0, head: str = "phone",
                session_ttl_s: float = 600.0,
                long_form_threshold_s: float = 40.0,
                max_pending: int = 128, max_inflight: int = 256):
    """→ (ThreadingHTTPServer, BatchingWorker). ``serve_forever()`` to run.

    ``transcriber`` may be a list (``Transcriber.replicate()``) for
    replica-per-card serving: the micro-batches go to whichever replica is
    idle, and the first serves the non-batched paths (long-form uploads and
    streaming sessions, from the request threads).
    ``session_ttl_s``: streaming sessions whose client vanished without
    ``/end`` are evicted after this idle time (otherwise abandoned
    sessions pin the ``max_sessions`` cap forever).
    ``long_form_threshold_s``: ``/transcribe`` uploads longer than this
    are routed through the sliding-window long-form path — a one-shot
    decode of a much-longer-than-training utterance would silently
    truncate at the decode cap (0 disables).
    ``max_pending``: admission cap on queued ``/transcribe`` requests;
    excess requests get an immediate 429 + Retry-After instead of an
    unbounded queue (0 = unbounded).
    ``max_inflight``: cap on concurrently live handler threads; excess
    connections get a canned 503 written from the accept path without
    spawning a handler thread (0 = unbounded).
    """
    import time as _time

    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    from phones_las_torch.data.audio_io import read_audio

    metrics = Metrics()
    worker = BatchingWorker(transcriber, max_batch, batch_wait_ms, metrics,
                            max_pending=max_pending)
    transcriber = worker.t  # the first replica serves the non-batched paths
    sample_rate = transcriber._sample_rate
    sessions: Dict[str, StreamSession] = {}
    sessions_lock = threading.Lock()
    max_sessions = 256

    def _evict_idle_sessions():
        if session_ttl_s <= 0:
            return
        cutoff = _time.monotonic() - session_ttl_s
        with sessions_lock:
            for sid in [s for s, v in sessions.items() if v.last_used < cutoff]:
                del sessions[sid]

    class Handler(BaseHTTPRequestHandler):
        # chunked responses (``?stream=1``) are only legal on HTTP/1.1
        # (RFC 7230 §3.3.1 — strict clients ignore Transfer-Encoding on
        # a 1.0 status line and would read raw chunk framing); every
        # response carries Content-Length or a terminating chunk, so
        # 1.1 keep-alive is safe
        protocol_version = "HTTP/1.1"
        # idle keep-alive read timeout: without it a handler thread blocks
        # in readline() forever after its last response, permanently
        # pinning a max_inflight slot — 256 pooled (or slowloris)
        # connections would 503 an otherwise idle server. On timeout
        # handle_one_request closes the connection and frees the slot.
        timeout = 60

        def log_message(self, fmt, *args):  # quiet access log
            pass

        def _json(self, code: int, obj, headers=()):
            self._last_status = code
            body = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            for k, v in headers:
                self.send_header(k, v)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path.startswith("/healthz"):
                self._json(200, {
                    "status": "ok",
                    "vocab_size": len(transcriber.vocab.tokens),
                    "head": head,
                    "sample_rate": sample_rate,
                })
            elif self.path.startswith("/metrics"):
                body = metrics.render(extra_gauges=[
                    ("plu_queue_depth", worker.q.qsize()),
                    ("plu_stream_sessions", len(sessions)),
                    ("plu_inflight_requests", getattr(self.server, "_inflight", 0)),
                ]).encode()
                self.send_response(200)
                self.send_header("Content-Type",
                                 "text/plain; version=0.0.4")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)
            else:
                self._json(404, {"error": "not found"})

        def _read_body(self) -> bytes:
            """Request body: Content-Length or chunked transfer coding
            (HTTP/1.1 §7.1 — lets clients upload long recordings without
            knowing the size up front; stdlib doesn't decode it)."""
            te = self.headers.get("Transfer-Encoding", "")
            if "chunked" in te.lower():
                out = []
                while True:
                    line = self.rfile.readline(1026)
                    if not line.endswith(b"\n"):
                        # size line longer than the cap: consuming the
                        # remainder as body bytes would silently shift
                        # every subsequent sample
                        raise ValueError("chunk-size line too long")
                    try:
                        size = int(line.split(b";")[0].strip() or b"0", 16)
                    except ValueError:
                        raise ValueError("malformed chunk size")
                    if size == 0:
                        # consume optional trailers up to the blank line
                        while self.rfile.readline(1026) not in (b"\r\n", b"\n", b""):
                            pass
                        return b"".join(out)
                    out.append(self.rfile.read(size))
                    self.rfile.read(2)  # chunk-terminating CRLF
            n = int(self.headers.get("Content-Length", 0))
            return self.rfile.read(n) if n > 0 else b""

        def _ndjson_chunk(self, obj):
            data = (json.dumps(obj) + "\n").encode()
            self.wfile.write(b"%x\r\n" % len(data) + data + b"\r\n")
            self.wfile.flush()

        def _stream_response(self, pcm, qs):
            """``/transcribe?stream=1``: chunked NDJSON response — one
            line per finalized window as decoding progresses (the
            incremental ``StreamSession`` machinery re-used server-side;
            the concatenated tokens equal the offline long-form path),
            then a ``"final": true`` line."""
            # construct before sending headers: bad params → clean 400
            sess = StreamSession(
                transcriber,
                window_seconds=(float(qs["window_s"][-1])
                                if "window_s" in qs else None),
                overlap_seconds=float(qs.get("overlap_s", ["2"])[-1]),
                segmentation=qs.get("segmentation", ["pause"])[-1],
            )
            self._last_status = 200
            self.send_response(200)
            self.send_header("Content-Type", "application/x-ndjson")
            self.send_header("Transfer-Encoding", "chunked")
            self.end_headers()
            try:
                done = 0
                for s in range(0, pcm.shape[0], sess.hop):
                    toks = sess.feed(pcm[s : s + sess.hop])
                    if toks or sess.n_windows > done:
                        # progress even when a window owns no tokens yet
                        # (its tokens' timestamps may fall past the
                        # midpoint cut)
                        done = sess.n_windows
                        self._ndjson_chunk({"tokens": toks, "windows": done})
                toks = sess.end()
                metrics.audio(pcm.shape[0] / sample_rate)
                self._ndjson_chunk({
                    "tokens": toks,
                    "final": True,
                    "total_tokens": sess.n_tokens,
                    "utt_seconds": round(pcm.shape[0] / sample_rate, 3),
                })
            except Exception as e:
                # headers are already out — a 400/500 status line here
                # would land as undeclared bytes inside the chunk stream.
                # Abort at the NDJSON level instead and end the response
                # cleanly (no "final" line = decode did not complete).
                self._ndjson_chunk(
                    {"error": f"{type(e).__name__}: {e}", "aborted": True}
                )
            self.wfile.write(b"0\r\n\r\n")

        def _read_pcm(self, qs, data):
            """Raw int16 PCM body → model-rate int16 samples."""
            pcm = np.frombuffer(data, np.int16)
            rate = int(qs.get("rate", [sample_rate])[-1])
            if rate != sample_rate:
                from phones_las_torch.data.audio_io import resample

                pcm = resample(pcm, rate, sample_rate)
            return pcm

        def _do_stream(self, url, qs, data):
            """Streaming session endpoints:

            POST /stream/start[?window_s=20&overlap_s=2&rate=16000]
                → {"id": ...}
            POST /stream/<id>     body = raw int16 PCM chunk
                → {"tokens": [now-final tokens], "buffered_seconds": ...}
            POST /stream/<id>/end
                → {"tokens": [remaining tokens], "total_tokens": N}
            """
            parts = url.path.split("/")  # ['', 'stream', ...]
            if parts[2:] == ["start"]:
                import time
                import uuid

                _evict_idle_sessions()
                with sessions_lock:
                    if len(sessions) >= max_sessions:
                        return self._json(429, {"error": "too many sessions"})
                    sid = uuid.uuid4().hex[:16]
                    try:
                        sess = StreamSession(
                            transcriber,
                            window_seconds=(
                                float(qs["window_s"][-1])
                                if "window_s" in qs else None),
                            overlap_seconds=float(
                                qs.get("overlap_s", ["2"])[-1]),
                            segmentation=qs.get(
                                "segmentation", ["pause"])[-1],
                        )
                        sess.rate = int(qs.get("rate", [sample_rate])[-1])
                        sess.last_used = time.monotonic()
                        sessions[sid] = sess
                    except (AssertionError, ValueError) as e:
                        return self._json(400, {"error": f"bad params: {e}"})
                return self._json(200, {"id": sid})
            with sessions_lock:
                sess = sessions.get(parts[2])
            if sess is None:
                return self._json(404, {"error": "no such session"})
            if parts[3:] == ["end"]:
                try:
                    toks = sess.end()
                finally:
                    with sessions_lock:
                        sessions.pop(parts[2], None)
                return self._json(200, {
                    "tokens": toks, "total_tokens": sess.n_tokens,
                    "total_seconds": round(sess.total / sample_rate, 3),
                })
            if parts[3:]:
                return self._json(404, {"error": "not found"})
            pcm = np.frombuffer(data, np.int16)
            if sess.rate != sample_rate and pcm.size:
                from phones_las_torch.data.audio_io import resample

                pcm = resample(pcm, sess.rate, sample_rate)
            try:
                toks = sess.feed(pcm)
            except AssertionError as e:
                return self._json(400, {"error": str(e)})
            import time

            sess.last_used = time.monotonic()
            metrics.audio(pcm.shape[0] / sample_rate)
            return self._json(200, {
                "tokens": toks,
                "buffered_seconds": round(
                    (sess.total - sess.next_start) / sample_rate, 3),
            })

        def do_POST(self):
            import time

            t0 = time.monotonic()
            self._last_status = 0
            try:
                self._handle_post()
            finally:
                ep = self.path.split("?")[0]
                if ep.startswith("/stream/"):
                    ep = "/stream"  # collapse session ids to one label
                elif ep != "/transcribe":
                    # unknown paths share one label: client-chosen bytes
                    # never reach the exposition format, and a scanner
                    # can't grow the label set without bound
                    ep = "other"
                metrics.request(ep, self._last_status)
                if self._last_status == 200:
                    metrics.latency(time.monotonic() - t0)

        def _handle_post(self):
            from urllib.parse import parse_qs, urlparse

            url = urlparse(self.path)
            qs = parse_qs(url.query)
            if url.path not in ("/transcribe",) and not url.path.startswith("/stream/"):
                # drain the body first: connections are HTTP/1.1 keep-alive,
                # so unread body bytes would be parsed as the next request on
                # the same connection, desyncing clients that reuse it
                try:
                    self._read_body()
                except ValueError:
                    self.close_connection = True
                return self._json(404, {"error": "not found"})
            try:
                data = self._read_body()
            except ValueError as e:
                # the connection's byte stream is desynced — close it
                self.close_connection = True
                return self._json(400, {"error": f"bad body: {e}"})
            if url.path.startswith("/stream/"):
                try:
                    return self._do_stream(url, qs, data)
                except Exception as e:
                    return self._json(500, {"error": f"{type(e).__name__}: {e}"})
            if not data:
                return self._json(400, {"error": "empty body"})
            try:
                if qs.get("raw", ["0"])[-1] == "1":
                    pcm = self._read_pcm(qs, data)
                else:
                    # the native decoders dispatch on file content
                    with tempfile.NamedTemporaryFile(suffix=".bin") as f:
                        f.write(data)
                        f.flush()
                        pcm, rate = read_audio(f.name, target_rate=sample_rate)
            except Exception as e:
                return self._json(400, {"error": f"decode failed: {e}"})
            if pcm.size == 0:
                return self._json(400, {"error": "no samples"})
            if qs.get("stream", ["0"])[-1] == "1":
                try:
                    return self._stream_response(pcm, qs)
                except (AssertionError, ValueError) as e:
                    return self._json(400, {"error": f"bad params: {e}"})
            if (
                long_form_threshold_s > 0
                and pcm.shape[0] > long_form_threshold_s * sample_rate
            ):
                # one-shot decode of a much-longer-than-training upload
                # would truncate at the decode cap; use the sliding-window
                # path (dispatched directly — it batches its own windows)
                try:
                    tokens = transcriber.transcribe_long(pcm)
                except Exception as e:
                    return self._json(500, {"error": f"{type(e).__name__}: {e}"})
            else:
                try:
                    p = worker.submit(pcm)
                except queue.Full:
                    # overload: fail fast instead of pinning this thread
                    # + queue entry until the backlog drains. Retry-After
                    # = batches queued × measured per-batch service time
                    # (not batch *count* — that overestimated ~10-50x).
                    batches = -(-worker.q.qsize() // max(max_batch, 1))
                    import math

                    retry = max(1, math.ceil(batches * worker.batch_seconds))
                    return self._json(
                        429, {"error": "server over capacity"},
                        headers=[("Retry-After", str(retry))],
                    )
                p.event.wait()
                if p.error is not None:
                    return self._json(500, {"error": p.error})
                tokens = p.result
            metrics.audio(pcm.shape[0] / sample_rate)
            self._json(200, {
                "tokens": tokens,
                "utt_seconds": round(pcm.shape[0] / sample_rate, 3),
            })

    _overload_body = json.dumps({"error": "server over capacity"}).encode()
    _overload_resp = (
        b"HTTP/1.1 503 Service Unavailable\r\n"
        b"Content-Type: application/json\r\n"
        b"Retry-After: 1\r\n"
        b"Connection: close\r\n"
        b"Content-Length: " + str(len(_overload_body)).encode() + b"\r\n\r\n"
        + _overload_body
    )

    class Server(ThreadingHTTPServer):
        # stdlib default backlog is 5: a burst of concurrent clients
        # (the whole point of a batching server) gets connection resets
        # at the accept queue before the handler ever runs
        request_queue_size = 512
        daemon_threads = True

        _inflight = 0
        _inflight_lock = threading.Lock()

        def process_request(self, request, client_address):
            # cap live handler threads: beyond max_inflight, answer with a
            # canned 503 straight from the accept path — no thread spawn,
            # no header parse, so overload costs O(1) per connection
            # instead of an unbounded thread + socket pileup
            if max_inflight > 0:
                with self._inflight_lock:
                    over = self._inflight >= max_inflight
                    if not over:
                        type(self)._inflight += 1
                if over:
                    metrics.request("overload", 503)
                    try:
                        request.sendall(_overload_resp)
                        # drain already-buffered request bytes before
                        # closing: close() with unread data in the receive
                        # buffer emits a TCP RST that discards the
                        # in-flight 503 client-side (ECONNRESET instead of
                        # 503 + Retry-After). Non-blocking only — this
                        # runs in the accept thread, so it must not wait
                        # on a slow sender.
                        request.setblocking(False)
                        drained = 0
                        while drained < (1 << 20):
                            chunk = request.recv(65536)
                            if not chunk:
                                break
                            drained += len(chunk)
                    except OSError:
                        pass
                    self.shutdown_request(request)
                    return
                try:
                    super().process_request(request, client_address)
                except BaseException:
                    # thread spawn failed: the paired decrement in
                    # process_request_thread will never run
                    with self._inflight_lock:
                        type(self)._inflight -= 1
                    raise
                return
            super().process_request(request, client_address)

        def process_request_thread(self, request, client_address):
            try:
                super().process_request_thread(request, client_address)
            finally:
                if max_inflight > 0:
                    with self._inflight_lock:
                        type(self)._inflight -= 1

    return Server((host, port), Handler), worker


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--workdir", required=True)
    p.add_argument("--host", default="0.0.0.0")
    p.add_argument("--port", type=int, default=8080)
    p.add_argument("--max-batch", type=int, default=16,
                   help="micro-batch cap per device dispatch")
    p.add_argument("--batch-wait-ms", type=float, default=20.0,
                   help="how long to hold a batch open for more requests")
    p.add_argument("--max-pending", type=int, default=128,
                   help="admission cap on queued /transcribe requests; "
                        "excess get 429 + Retry-After (0 = unbounded)")
    p.add_argument("--max-inflight", type=int, default=256,
                   help="cap on concurrent request handler threads; "
                        "excess connections get a fast 503 (0 = unbounded)")
    p.add_argument("--session-ttl-s", type=float, default=600.0,
                   help="evict /stream sessions idle this long (0 = never)")
    p.add_argument("--long-form-threshold-s", type=float, default=40.0,
                   help="/transcribe uploads longer than this go through "
                        "the segmented long-form path (0 = never)")
    p.add_argument("--beam-width", type=int, default=None)
    p.add_argument("--head", default="phone", choices=["phone", "grapheme"])
    p.add_argument("--data-parallel", type=int, default=1,
                   help="shard each micro-batch over this many cards (0 = every card): one "
                        "server drives them all")
    p.add_argument("--replicas", type=int, default=1,
                   help="replica-per-card serving (0 = every card): each card holds a whole "
                        "model and takes whole micro-batches off the shared queue (better tail "
                        "latency under independent requests than --data-parallel)")
    p.add_argument("--devices", default=None, metavar="DEV,DEV,...",
                   help="the devices --data-parallel or --replicas take, in order, "
                        "one may repeat (default: every card)")
    p.add_argument("--average-checkpoints", type=int, default=1, metavar="K",
                   help="serve the mean of the newest K checkpoints")
    p.add_argument("--lm", default=None, metavar="LM.npz",
                   help="shallow-fusion n-gram LM (beam decoding only)")
    p.add_argument("--lm-weight", type=float, default=0.3)
    p.add_argument("--ctc-joint", type=float, default=None, metavar="ALPHA",
                   help="one-pass joint CTC-attention beam decoding "
                        "(score = ALPHA*attn + (1-ALPHA)*ctc prefix)")
    add_device_arg(p)
    args = p.parse_args(argv)
    if args.replicas != 1 and args.data_parallel != 1:
        p.error("--replicas and --data-parallel are exclusive "
                "(a whole model a card against one batch sharded over cards)")
    devices = parse_devices(args.devices, args.device)

    from phones_las_torch.api import Transcriber

    t = Transcriber(
        args.workdir, beam_width=args.beam_width, head=args.head,
        average_checkpoints=args.average_checkpoints,
        lm=args.lm, lm_weight=args.lm_weight, ctc_joint=args.ctc_joint,
        data_parallel=args.data_parallel, device=args.device if devices is None else None, devices=devices,
    )
    if args.max_batch % t.data_parallel:
        p.error(f"--max-batch {args.max_batch} must be a multiple of --data-parallel {t.data_parallel}")
    serve_t = t.replicate(args.replicas, devices) if args.replicas != 1 else [t]
    for rep in serve_t:
        # run the shapes the worker dispatches (a full max_batch micro-batch
        # at the smallest pad quantum) before any request thread exists: the
        # kernels are built at their first launch
        rep.transcribe_batch([np.zeros(16000, np.int16)] * args.max_batch)
    if args.long_form_threshold_s > 0:
        # and the aligned decode of the long-form and streaming paths
        # (pause-snapped segments pad to window + 2 × search), which the
        # first replica serves
        win = 20 * t.sample_rate
        serve_t[0].decode_aligned([np.zeros(win, np.int16)], window_samples=win + 4 * t.sample_rate)
    server, worker = make_server(
        serve_t, args.host, args.port, max_batch=args.max_batch,
        batch_wait_ms=args.batch_wait_ms, head=args.head,
        session_ttl_s=args.session_ttl_s,
        long_form_threshold_s=args.long_form_threshold_s,
        max_pending=args.max_pending, max_inflight=args.max_inflight,
    )
    print(f"serving {args.workdir} on {args.host}:{server.server_address[1]} "
          f"(max_batch={args.max_batch}, wait={args.batch_wait_ms}ms)", flush=True)
    try:
        server.serve_forever()
    finally:
        worker.stop()
        server.server_close()


if __name__ == "__main__":
    main()
