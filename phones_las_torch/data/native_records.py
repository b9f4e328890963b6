"""ctypes bindings for the native C++ record reader (port of
``phones_las_tpu/data/native_records.py``; ``csrc/plu_records.cc`` is a
copy of the reference's source).

Fills padded batches directly in C++ — no per-utterance Python parsing on
the training hot path. Built at first use with the host compiler beside
the audio decoder (``audio_io.ensure_built``);
``NativeRecordReader.available()`` gates the fallback to the Python
reader. The reader bounds-checks every length field of the file, so a
corrupt record raises instead of reading past the mapping.
"""

from __future__ import annotations

import ctypes
import os
import threading
from typing import Optional

import numpy as np

from phones_las_torch.data.audio_io import ensure_built, load_library

_lock = threading.Lock()
_lib = None
_failed = False


def _load():
    global _lib, _failed
    with _lock:
        if _lib is not None or _failed:
            return _lib
        so = ensure_built("plu_records.cc", "plu_records.so")
        if so is None:
            _failed = True
            return None
        try:
            lib = load_library(so)
        except OSError:
            _failed = True
            return None
        vp, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.plu_open.restype = vp
        lib.plu_open.argtypes = [ctypes.c_char_p, ctypes.c_char_p, i]
        lib.plu_num_records.restype = ll
        lib.plu_num_records.argtypes = [vp]
        lib.plu_lengths.restype = i
        lib.plu_lengths.argtypes = [vp, vp]
        lib.plu_read_batch.restype = i
        lib.plu_read_batch.argtypes = [
            vp, vp, i,  # handle, indices, n
            vp, ll, vp,  # audio [n, S], S, audio_lengths
            vp, ll, i, i, vp,  # targets [n, L], L, eos, pad, target_lengths
            vp, ll, vp,  # graphemes [n, G], G, grapheme_lengths
            i,  # threads
            ctypes.c_char_p, i,  # err, errlen
        ]
        lib.plu_close.restype = None
        lib.plu_close.argtypes = [vp]
        _lib = lib
        return _lib


def _check_rows(name: str, a: np.ndarray, dtype, ndim: int, rows: int) -> None:
    if a.dtype != dtype or a.ndim != ndim or a.shape[0] < rows or not a.flags.c_contiguous:
        raise ValueError(f"{name}: want a C-contiguous {dtype.__name__} array of {ndim} dims and ≥ {rows} rows, "
                         f"got {a.dtype} {a.shape}")


class NativeRecordReader:
    """Random-access batch filler over one ``.plu`` file."""

    @staticmethod
    def available() -> bool:
        return _load() is not None

    def __init__(self, path: str):
        lib = _load()
        if lib is None:
            raise RuntimeError("the native record reader (csrc/plu_records.cc) could not be built")
        self._lib = lib
        err = ctypes.create_string_buffer(256)
        self._h = lib.plu_open(path.encode(), err, 256)
        if not self._h:
            raise ValueError(f"{path}: {err.value.decode()}")
        self._n = int(lib.plu_num_records(self._h))

    def __len__(self) -> int:
        return self._n

    def lengths(self) -> np.ndarray:
        """[n, 3] int64: (samples, targets, graphemes) of each record."""
        out = np.zeros((self._n, 3), np.int64)
        if self._lib.plu_lengths(self._h, out.ctypes.data_as(ctypes.c_void_p)) != 0:
            raise ValueError("a record's length fields are corrupt")
        return out

    def read_batch(
        self,
        indices: np.ndarray,
        audio: np.ndarray,  # [B, S] int16 (rows >= len(indices) untouched)
        audio_lengths: np.ndarray,  # [B] int32
        targets: np.ndarray,  # [B, L] int32
        target_lengths: np.ndarray,  # [B] int32
        eos_id: int,
        pad_id: int,
        graphemes: Optional[np.ndarray] = None,
        grapheme_lengths: Optional[np.ndarray] = None,
        n_threads: Optional[int] = None,
    ) -> None:
        """Fill the first ``len(indices)`` rows of the given buffers in
        place: audio clipped to S samples, targets clipped to L − 1 with
        ``<eos>`` appended (and counted), the rest ``pad_id``.
        ``n_threads=None`` → one fill thread per core, at most 8."""
        if n_threads is None:
            n_threads = min(8, os.cpu_count() or 1)
        idx = np.ascontiguousarray(indices, np.int64)
        n = len(idx)
        _check_rows("audio", audio, np.int16, 2, n)
        _check_rows("audio_lengths", audio_lengths, np.int32, 1, n)
        _check_rows("targets", targets, np.int32, 2, n)
        _check_rows("target_lengths", target_lengths, np.int32, 1, n)
        if graphemes is not None:
            _check_rows("graphemes", graphemes, np.int32, 2, n)
            _check_rows("grapheme_lengths", grapheme_lengths, np.int32, 1, n)
        err = ctypes.create_string_buffer(256)
        vp = lambda a: a.ctypes.data_as(ctypes.c_void_p) if a is not None else None
        rc = self._lib.plu_read_batch(
            self._h, vp(idx), n,
            vp(audio), audio.shape[1], vp(audio_lengths),
            vp(targets), targets.shape[1], eos_id, pad_id, vp(target_lengths),
            vp(graphemes), graphemes.shape[1] if graphemes is not None else 0,
            vp(grapheme_lengths),
            int(n_threads),
            err, 256,
        )
        if rc != 0:
            raise ValueError(err.value.decode())

    def close(self) -> None:
        if self._h:
            self._lib.plu_close(self._h)
            self._h = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
