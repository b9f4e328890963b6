"""Audio input: the native (C++) decoder with Python fallbacks (port of
``phones_las_tpu/data/audio_io.py``).

``csrc/plu_audio.cc`` (WAV / NIST-SPHERE / FLAC / MP3 → int16 mono, and a
Kaiser-windowed polyphase resampler) is a copy of the reference's source.
It is compiled at first use with the host's ``g++`` (never ``nvcc``) into
``csrc/build/`` and loaded with ``ctypes``. Pure-Python fallbacks cover
WAV and SPHERE when no compiler is available; FLAC and MP3 need the native
decoder, and MP3 also needs ``libmpg123``, which the decoder opens at run
time (``read_audio`` raises where it is missing, as the reference does).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import struct
import subprocess
import tempfile
import threading
from typing import Optional, Tuple

import numpy as np

_CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "csrc")
_BUILD_DIR = os.path.join(_CSRC, "build")
# the reference's flags (``audio_io.py:75-76``)
_CXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC", "-pthread")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_lib_failed = False


def _sha(path: str) -> str:
    with open(path, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


def _replace_atomically(path: str, write) -> None:
    """``write(tmp_path)``, then rename the temporary file onto ``path``:
    a reader sees the old file or the whole new one, never a half-written
    one (test workers may build the same library at once)."""
    fd, tmp = tempfile.mkstemp(dir=os.path.dirname(path), prefix=os.path.basename(path) + ".", suffix=".tmp")
    os.close(fd)
    try:
        write(tmp)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def ensure_built(src_name: str, so_name: str) -> Optional[str]:
    """Compile ``csrc/<src_name>`` → ``csrc/build/<so_name>`` if needed and
    return the library's path, or None when there is no source or the
    compiler fails.

    A ``.sha256`` stamp of (source, binary) gates reuse: a library whose
    stamp is missing, whose source has changed, or whose bytes do not
    match the stamp is rebuilt from source. The compiler writes a
    temporary file that is renamed into place, and so is the stamp."""
    src = os.path.join(_CSRC, src_name)
    if not os.path.exists(src):
        return None
    so = os.path.join(_BUILD_DIR, so_name)
    stamp = so + ".sha256"
    src_digest = _sha(src)
    if os.path.exists(so) and os.path.exists(stamp):
        with open(stamp) as f:
            if f.read().strip() == f"{src_digest} {_sha(so)}":
                return so
    try:
        os.makedirs(_BUILD_DIR, exist_ok=True)
        compile_to = lambda out: subprocess.run(
            ["g++", *_CXX_FLAGS, "-o", out, src, "-ldl"], check=True, capture_output=True, timeout=120
        )
        _replace_atomically(so, compile_to)
        digest = f"{src_digest} {_sha(so)}"

        def write_stamp(out):
            with open(out, "w") as f:
                f.write(digest)

        _replace_atomically(stamp, write_stamp)
    except (OSError, subprocess.SubprocessError):
        return None
    return so


def load_library(so: str) -> ctypes.CDLL:
    """Load a built library with its symbols local: the JAX package's copy
    of the same source exports the same ``plu_*`` names, and a process
    (the tests) may load both."""
    return ctypes.CDLL(so, mode=os.RTLD_LOCAL)


def _native() -> Optional[ctypes.CDLL]:
    global _lib, _lib_failed
    with _lock:
        if _lib is not None or _lib_failed:
            return _lib
        so = ensure_built("plu_audio.cc", "plu_audio.so")
        if so is None:
            _lib_failed = True
            return None
        lib = load_library(so)
        lib.plu_decode_audio.argtypes = [
            ctypes.c_char_p,
            ctypes.POINTER(ctypes.POINTER(ctypes.c_int16)),
            ctypes.POINTER(ctypes.c_longlong),
            ctypes.POINTER(ctypes.c_int),
            ctypes.c_char_p,
            ctypes.c_int,
        ]
        lib.plu_decode_audio.restype = ctypes.c_int
        lib.plu_resample.argtypes = [
            ctypes.POINTER(ctypes.c_int16),
            ctypes.c_longlong,
            ctypes.c_int,
            ctypes.c_int,
            ctypes.POINTER(ctypes.POINTER(ctypes.c_int16)),
            ctypes.POINTER(ctypes.c_longlong),
            ctypes.c_char_p,
            ctypes.c_int,
        ]
        lib.plu_resample.restype = ctypes.c_int
        lib.plu_free.argtypes = [ctypes.POINTER(ctypes.c_int16)]
        lib.plu_free.restype = None
        _lib = lib
        return _lib


def _read_native(path: str) -> Tuple[np.ndarray, int]:
    lib = _native()
    if lib is None:
        raise ValueError(f"{path}: the native decoder (csrc/plu_audio.cc) could not be built")
    buf = ctypes.POINTER(ctypes.c_int16)()
    n = ctypes.c_longlong()
    rate = ctypes.c_int()
    err = ctypes.create_string_buffer(256)
    rc = lib.plu_decode_audio(path.encode(), ctypes.byref(buf), ctypes.byref(n), ctypes.byref(rate), err, 256)
    if rc != 0:
        raise ValueError(f"{path}: {err.value.decode()}")
    try:
        arr = np.ctypeslib.as_array(buf, shape=(n.value,)).copy()
    finally:
        lib.plu_free(buf)
    return arr, rate.value


# ---------------------------------------------------------------------------
# Pure-Python fallbacks
# ---------------------------------------------------------------------------


def _read_wav_py(path: str) -> Tuple[np.ndarray, int]:
    with open(path, "rb") as f:
        data = f.read()
    if data[:4] != b"RIFF" or data[8:12] != b"WAVE":
        raise ValueError(f"{path}: not WAV")
    pos, rate, channels, bits, fmt = 12, 16000, 1, 16, 1
    pcm = b""
    while pos + 8 <= len(data):
        tag = data[pos : pos + 4]
        (ln,) = struct.unpack("<I", data[pos + 4 : pos + 8])
        body = data[pos + 8 : pos + 8 + ln]
        if tag == b"fmt ":
            fmt, channels, rate = struct.unpack("<HHI", body[:8])
            (bits,) = struct.unpack("<H", body[14:16])
        elif tag == b"data":
            pcm = body
        pos += 8 + ln + (ln & 1)
    if bits == 16:
        arr = np.frombuffer(pcm, "<i2").astype(np.int32)
    elif bits == 8:
        arr = (np.frombuffer(pcm, "u1").astype(np.int32) - 128) << 8
    elif bits == 32 and fmt == 3:
        arr = (np.frombuffer(pcm, "<f4") * 32767).astype(np.int32)
    else:
        raise ValueError(f"{path}: unsupported wav ({fmt=}, {bits=})")
    if channels > 1:
        arr = arr[: len(arr) // channels * channels].reshape(-1, channels).mean(1)
    return np.clip(arr, -32768, 32767).astype(np.int16), rate


def _ulaw_table() -> np.ndarray:
    u = np.arange(256, dtype=np.uint8) ^ 0xFF
    t = ((u & 0x0F).astype(np.int32) << 3) + 0x84
    t <<= (u & 0x70) >> 4
    return np.where(u & 0x80, 0x84 - t, t - 0x84).astype(np.int16)


def _read_sphere_py(path: str) -> Tuple[np.ndarray, int]:
    with open(path, "rb") as f:
        data = f.read()
    if data[:7] != b"NIST_1A":
        raise ValueError(f"{path}: not NIST sphere")
    hdr_size = int(data[8:16].split()[0])
    hdr = data[:hdr_size].decode("ascii", "ignore")
    fields = {}
    for line in hdr.splitlines():
        parts = line.split(" ", 2)
        if len(parts) == 3 and parts[1].startswith("-"):
            fields[parts[0]] = parts[2]
    rate = int(fields.get("sample_rate", "16000"))
    channels = int(fields.get("channel_count", "1"))
    nbytes = int(fields.get("sample_n_bytes", "2"))
    coding = fields.get("sample_coding", "pcm")
    byte_fmt = fields.get("sample_byte_format", "01")
    if "shorten" in coding or "shorten" in byte_fmt:
        raise ValueError(f"{path}: shorten-compressed sphere unsupported (use sph2pipe)")
    body = data[hdr_size:]
    if "ulaw" in coding or nbytes == 1:
        arr = _ulaw_table()[np.frombuffer(body, np.uint8)].astype(np.int32)
    else:
        dt = ">i2" if byte_fmt == "10" else "<i2"
        arr = np.frombuffer(body[: len(body) // 2 * 2], dt).astype(np.int32)
    if channels > 1:
        arr = arr[: len(arr) // channels * channels].reshape(-1, channels).mean(1)
    return arr.astype(np.int16), rate


def resample(samples: np.ndarray, in_rate: int, out_rate: int) -> np.ndarray:
    """Rational polyphase resample (the native Kaiser-windowed sinc)."""
    if in_rate == out_rate:
        return samples
    lib = _native()
    if lib is None:
        raise ValueError(
            f"resampling {in_rate}->{out_rate} needs the native decoder "
            "(csrc/plu_audio.cc) and no C++ compiler is available"
        )
    samples = np.ascontiguousarray(samples, np.int16)
    buf = ctypes.POINTER(ctypes.c_int16)()
    n = ctypes.c_longlong()
    err = ctypes.create_string_buffer(256)
    rc = lib.plu_resample(
        samples.ctypes.data_as(ctypes.POINTER(ctypes.c_int16)),
        len(samples), in_rate, out_rate,
        ctypes.byref(buf), ctypes.byref(n), err, 256,
    )
    if rc != 0:
        raise ValueError(err.value.decode())
    try:
        out = np.ctypeslib.as_array(buf, shape=(n.value,)).copy()
    finally:
        lib.plu_free(buf)
    return out


def read_audio(path: str, target_rate: Optional[int] = None) -> Tuple[np.ndarray, int]:
    """→ (int16 mono samples, sample_rate), dispatching on content.

    With ``target_rate``, streams at other rates are resampled to it."""
    low = path.lower()
    if _native() is not None:
        samples, rate = _read_native(path)
    elif low.endswith(".flac") or low.endswith(".mp3"):
        raise ValueError(
            f"{path}: FLAC/MP3 need the native decoder (csrc/plu_audio.cc) "
            "and no C++ compiler is available"
        )
    else:
        with open(path, "rb") as f:
            magic = f.read(7)
        if magic[:4] == b"RIFF":
            samples, rate = _read_wav_py(path)
        elif magic == b"NIST_1A":
            samples, rate = _read_sphere_py(path)
        else:
            raise ValueError(f"{path}: unrecognized audio container")
    if target_rate is not None and rate != target_rate:
        samples, rate = resample(samples, rate, target_rate), target_rate
    return samples, rate


def write_wav(path: str, samples: np.ndarray, rate: int = 16000) -> None:
    """Minimal PCM16 mono writer."""
    samples = np.ascontiguousarray(samples, np.int16)
    with open(path, "wb") as f:
        data = samples.tobytes()
        f.write(b"RIFF" + struct.pack("<I", 36 + len(data)) + b"WAVE")
        f.write(b"fmt " + struct.pack("<IHHIIHH", 16, 1, 1, rate, rate * 2, 2, 16))
        f.write(b"data" + struct.pack("<I", len(data)) + data)
