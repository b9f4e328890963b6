"""Packed binary utterance records with random access (a copy of
``phones_las_tpu/data/records.py``: the writer produces byte-identical
files and each package reads the other's).

  ``<name>.plu``  — a uint32 header length, a header JSON line, then
  length-prefixed records
  ``<name>.plu.idx`` — uint64 byte offsets per record (enables shuffled
  and bucketed access without parsing the stream)

Record layout (little-endian):
  uint32 record_bytes
  uint32 utt_id_bytes, utf-8 id
  uint32 n_samples,   int16 PCM
  uint32 n_targets,   int32 phone ids
  uint32 n_graphemes, int32 grapheme ids (0 if absent)
  uint32 text_bytes,  utf-8 transcript (may be 0)

The C++ batch filler (``csrc/plu_records.cc``, ``native_records.py``)
reads the same files on the training hot path; this module is its
Python twin and the fallback.
"""

from __future__ import annotations

import dataclasses
import json
import os
import struct
from typing import Iterator, List, Optional

import numpy as np

MAGIC = "PLU1"


@dataclasses.dataclass
class Utterance:
    utt_id: str
    audio: np.ndarray  # int16 [S]
    targets: np.ndarray  # int32 phone ids (no sos/eos; eos added in batching)
    grapheme_targets: Optional[np.ndarray] = None
    text: str = ""
    # optional per-target (start_sample, end_sample) ground-truth spans —
    # filled by the speechlike synthesizer (which knows them exactly) for
    # alignment/stitching diagnostics; NOT serialized to .plu records
    token_times: Optional[np.ndarray] = None

    @property
    def num_samples(self) -> int:
        return int(self.audio.shape[0])


class RecordWriter:
    def __init__(self, path: str, meta: Optional[dict] = None):
        self.path = path
        self._f = open(path, "wb")
        self._offsets: List[int] = []
        header = dict(meta or {})
        header["magic"] = MAGIC
        hdr = (json.dumps(header) + "\n").encode()
        self._f.write(struct.pack("<I", len(hdr)))
        self._f.write(hdr)

    def write(self, utt: Utterance) -> None:
        audio = np.ascontiguousarray(utt.audio, dtype=np.int16)
        targets = np.ascontiguousarray(utt.targets, dtype=np.int32)
        graphemes = (
            np.ascontiguousarray(utt.grapheme_targets, dtype=np.int32)
            if utt.grapheme_targets is not None
            else np.zeros(0, np.int32)
        )
        uid = utt.utt_id.encode()
        text = utt.text.encode()
        payload = b"".join(
            [
                struct.pack("<I", len(uid)), uid,
                struct.pack("<I", audio.shape[0]), audio.tobytes(),
                struct.pack("<I", targets.shape[0]), targets.tobytes(),
                struct.pack("<I", graphemes.shape[0]), graphemes.tobytes(),
                struct.pack("<I", len(text)), text,
            ]
        )
        self._offsets.append(self._f.tell())
        self._f.write(struct.pack("<I", len(payload)))
        self._f.write(payload)

    def close(self) -> None:
        self._f.close()
        with open(self.path + ".idx", "wb") as f:
            f.write(np.asarray(self._offsets, dtype=np.uint64).tobytes())

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def _parse_record(buf: bytes) -> Utterance:
    off = 0

    def take(n):
        nonlocal off
        b = buf[off : off + n]
        off += n
        return b

    (n,) = struct.unpack("<I", take(4))
    uid = take(n).decode()
    (n,) = struct.unpack("<I", take(4))
    audio = np.frombuffer(take(2 * n), dtype=np.int16)
    (n,) = struct.unpack("<I", take(4))
    targets = np.frombuffer(take(4 * n), dtype=np.int32)
    (n,) = struct.unpack("<I", take(4))
    graphemes = np.frombuffer(take(4 * n), dtype=np.int32) if n else None
    (n,) = struct.unpack("<I", take(4))
    text = take(n).decode()
    return Utterance(uid, audio, targets, graphemes, text)


class RecordReader:
    """Random-access reader over one ``.plu`` file (mmap-backed)."""

    def __init__(self, path: str):
        self.path = path
        self._data = np.memmap(path, dtype=np.uint8, mode="r")
        (hdr_len,) = struct.unpack("<I", self._data[:4].tobytes())
        self.meta = json.loads(self._data[4 : 4 + hdr_len].tobytes().decode())
        if self.meta.get("magic") != MAGIC:
            raise ValueError(f"bad magic in {path}")
        idx_path = path + ".idx"
        if os.path.exists(idx_path):
            self._offsets = np.fromfile(idx_path, dtype=np.uint64)
        else:  # rebuild by scanning
            offs, pos = [], 4 + hdr_len
            total = self._data.shape[0]
            while pos < total:
                offs.append(pos)
                (n,) = struct.unpack("<I", self._data[pos : pos + 4].tobytes())
                pos += 4 + n
            self._offsets = np.asarray(offs, dtype=np.uint64)

    def __len__(self) -> int:
        return int(self._offsets.shape[0])

    def __getitem__(self, i: int) -> Utterance:
        pos = int(self._offsets[i])
        (n,) = struct.unpack("<I", self._data[pos : pos + 4].tobytes())
        return _parse_record(self._data[pos + 4 : pos + 4 + n].tobytes())

    def __iter__(self) -> Iterator[Utterance]:
        for i in range(len(self)):
            yield self[i]

    def utt_id(self, i: int) -> str:
        """Read only the id field of record ``i`` (no full parse)."""
        pos = int(self._offsets[i]) + 4
        (n,) = struct.unpack("<I", self._data[pos : pos + 4].tobytes())
        return self._data[pos + 4 : pos + 4 + n].tobytes().decode()

    def lengths(self) -> np.ndarray:
        """Per-record (n_samples, n_targets, n_graphemes) without full
        parse — reads just the fixed-size prefixes. Used by the bucketing
        batcher to plan static shapes."""
        out = np.zeros((len(self), 3), np.int64)
        for i in range(len(self)):
            pos = int(self._offsets[i]) + 4
            (n_uid,) = struct.unpack("<I", self._data[pos : pos + 4].tobytes())
            pos += 4 + n_uid
            (n_s,) = struct.unpack("<I", self._data[pos : pos + 4].tobytes())
            pos += 4 + 2 * n_s
            (n_t,) = struct.unpack("<I", self._data[pos : pos + 4].tobytes())
            pos += 4 + 4 * n_t
            (n_g,) = struct.unpack("<I", self._data[pos : pos + 4].tobytes())
            out[i] = (n_s, n_t, n_g)
        return out
