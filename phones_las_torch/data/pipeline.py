"""Length-bucketed, static-shape batch pipeline (port of
``phones_las_tpu/data/pipeline.py``).

Record files → shuffle (a seed per epoch) → a greedy bucket plan →
padded batches filled by the native C++ reader when it builds (else the
Python twin) → a prefetch thread. Every batch has one of a few static
audio lengths (the bucket bounds), so padding waste is bounded by the
buckets' granularity. Audio stays int16 on the host and on the wire to
the device, where the front-end consumes raw PCM values.

Targets get ``<eos>`` appended here (counted in ``target_lengths``);
decoder input shifting happens inside the model.
"""

from __future__ import annotations

import dataclasses
import logging
import queue
import threading
from typing import Dict, Iterator, List, Optional, Sequence

import numpy as np

from phones_las_torch.data.records import RecordReader, Utterance

log = logging.getLogger(__name__)


@dataclasses.dataclass(frozen=True)
class PipelineConfig:
    """Same fields and defaults as the reference's."""

    batch_size: int = 32
    # bucket upper bounds, in samples (16 kHz: 2/4/8/16/30 s)
    buckets: Sequence[int] = (32000, 64000, 128000, 256000, 480000)
    max_target_len: int = 100  # static target length incl. <eos>
    max_grapheme_len: int = 0  # 0 → no grapheme targets in batches
    eos_id: int = 2
    pad_id: int = 0
    shuffle: bool = True
    seed: int = 0
    drop_remainder: bool = True  # False → pad final partial batch with empty rows
    drop_too_long: bool = True  # False → truncate to the largest bucket
    min_samples: int = 0  # length filter lower bound


def _bucket_for(n: int, buckets: Sequence[int]) -> Optional[int]:
    for i, b in enumerate(buckets):
        if n <= b:
            return i
    return None


def _empty_batch(cfg: PipelineConfig, bucket_len: int) -> Dict:
    b = cfg.batch_size
    batch = {
        "audio": np.zeros((b, bucket_len), np.int16),
        "audio_lengths": np.zeros((b,), np.int32),
        "targets": np.full((b, cfg.max_target_len), cfg.pad_id, np.int32),
        "target_lengths": np.zeros((b,), np.int32),
    }
    if cfg.max_grapheme_len:
        batch["grapheme_targets"] = np.full((b, cfg.max_grapheme_len), cfg.pad_id, np.int32)
        batch["grapheme_lengths"] = np.zeros((b,), np.int32)
    return batch


def _fill_rows(cfg: PipelineConfig, batch: Dict, utts: List[Utterance], row0: int = 0) -> List[str]:
    """Fill consecutive rows of a padded batch from Utterances (the
    Python twin of the C++ ``plu_read_batch``)."""
    bucket_len = batch["audio"].shape[1]
    utt_ids = []
    for i, u in enumerate(utts, start=row0):
        s = min(u.num_samples, bucket_len)
        batch["audio"][i, :s] = u.audio[:s]
        batch["audio_lengths"][i] = s
        t = u.targets[: cfg.max_target_len - 1]
        batch["targets"][i, : len(t)] = t
        batch["targets"][i, len(t)] = cfg.eos_id
        batch["target_lengths"][i] = len(t) + 1
        if cfg.max_grapheme_len:
            g = (u.grapheme_targets if u.grapheme_targets is not None else np.zeros(0, np.int32))[
                : cfg.max_grapheme_len - 1
            ]
            batch["grapheme_targets"][i, : len(g)] = g
            batch["grapheme_targets"][i, len(g)] = cfg.eos_id
            batch["grapheme_lengths"][i] = len(g) + 1
        utt_ids.append(u.utt_id)
    return utt_ids


def plan_batches(
    sample_lengths: np.ndarray,
    order: np.ndarray,
    cfg: PipelineConfig,
    target_lengths: Optional[np.ndarray] = None,
    grapheme_lengths: Optional[np.ndarray] = None,
) -> List:
    """Greedy bucket assignment in data order → [(bucket_idx, indices)]:
    drop or truncate what is too long, full batches emitted in arrival
    order, an optional flush of partial batches at the end of the epoch.

    Utterances whose targets (or graphemes) cannot fit the static row
    (len > max_*_len − 1, the <eos> slot) are dropped and counted:
    training on silently clipped labels is worse than skipping them."""
    pending: Dict[int, List[int]] = {i: [] for i in range(len(cfg.buckets))}
    plans = []
    dropped_long_target = 0
    for j in order:
        if sample_lengths[j] < cfg.min_samples:
            continue
        if target_lengths is not None and target_lengths[j] > cfg.max_target_len - 1:
            dropped_long_target += 1
            continue
        if cfg.max_grapheme_len and grapheme_lengths is not None and grapheme_lengths[j] > cfg.max_grapheme_len - 1:
            dropped_long_target += 1
            continue
        bi = _bucket_for(int(sample_lengths[j]), cfg.buckets)
        if bi is None:
            if cfg.drop_too_long:
                continue
            bi = len(cfg.buckets) - 1
        pending[bi].append(int(j))
        if len(pending[bi]) == cfg.batch_size:
            plans.append((bi, np.asarray(pending[bi])))
            pending[bi] = []
    if not cfg.drop_remainder:
        for bi, items in pending.items():
            if items:
                plans.append((bi, np.asarray(items)))
    if dropped_long_target:
        log.warning(
            "dropped %d utterance(s) with targets longer than the static row (max_target_len=%d, max_grapheme_len=%d)",
            dropped_long_target, cfg.max_target_len, cfg.max_grapheme_len,
        )
    return plans


class DataSource:
    """Epoch iterator over record files: shuffle → bucket plan → padded
    batch fill (native C++ when it builds) → threaded prefetch.

    ``use_native='auto'`` fills batches with the C++ reader and, where it
    cannot be built (no compiler), logs one warning and fills them in
    Python; ``'never'`` always fills in Python. ``native`` holds the C++
    readers, or None. ``shard=(process_index, process_count)`` takes one
    process's stride of every epoch's plan (``parallel.multihost.shard_plan``)."""

    def __init__(
        self,
        paths: Sequence[str],
        cfg: PipelineConfig,
        use_native: str = "auto",
        shard: Optional[Sequence[int]] = None,
    ):
        if use_native not in ("auto", "never"):
            raise ValueError(f"use_native must be 'auto' or 'never', got {use_native!r}")
        self.shard = tuple(shard) if shard is not None else None
        self.readers = [RecordReader(p) for p in paths]
        self.cfg = cfg
        self._index = [(ri, i) for ri, r in enumerate(self.readers) for i in range(len(r))]
        self.native = None
        if use_native == "auto":
            from phones_las_torch.data.native_records import NativeRecordReader

            if NativeRecordReader.available():
                self.native = [NativeRecordReader(p) for p in paths]
            else:
                log.warning("the native record reader could not be built (no C++ compiler?): "
                            "filling batches in Python")
        lens = [r.lengths() for r in self.readers]
        self._lengths = np.concatenate(lens, axis=0) if lens else np.zeros((0, 3), np.int64)

    def __len__(self) -> int:
        return len(self._index)

    def _fill_batch(self, bucket_len: int, indices: np.ndarray) -> Dict:
        cfg = self.cfg
        n = len(indices)
        batch = _empty_batch(cfg, bucket_len)
        utt_ids = []
        if self.native is not None:
            # fill runs of same-reader rows in C++, preserving plan order
            readers = np.asarray([self._index[j][0] for j in indices])
            locals_ = np.asarray([self._index[j][1] for j in indices])
            row = 0
            while row < n:
                ri = int(readers[row])
                end = row
                while end < n and readers[end] == ri:
                    end += 1
                rows = slice(row, end)
                self.native[ri].read_batch(
                    locals_[rows],
                    batch["audio"][rows], batch["audio_lengths"][rows],
                    batch["targets"][rows], batch["target_lengths"][rows],
                    cfg.eos_id, cfg.pad_id,
                    graphemes=batch["grapheme_targets"][rows] if cfg.max_grapheme_len else None,
                    grapheme_lengths=batch["grapheme_lengths"][rows] if cfg.max_grapheme_len else None,
                )
                utt_ids += [self.readers[ri].utt_id(int(i)) for i in locals_[rows]]
                row = end
        else:
            utts = [self.readers[ri][i] for ri, i in (self._index[j] for j in indices)]
            utt_ids = _fill_rows(cfg, batch, utts)
        batch["utt_ids"] = utt_ids + [""] * (cfg.batch_size - n)
        batch["num_real"] = n
        return batch

    def _plan(self, epoch: int) -> List:
        order = np.arange(len(self._index))
        if self.cfg.shuffle:
            np.random.RandomState(self.cfg.seed + epoch).shuffle(order)
        plans = plan_batches(
            self._lengths[:, 0], order, self.cfg,
            target_lengths=self._lengths[:, 1], grapheme_lengths=self._lengths[:, 2],
        )
        if self.shard is not None:
            from phones_las_torch.parallel.multihost import shard_plan

            plans = shard_plan(plans, *self.shard)
        return plans

    def epoch(self, epoch: int = 0, prefetch: int = 4) -> Iterator[Dict]:
        """One pass over the data as batches, prefetched on a thread.

        A producer exception reaches the consumer (a crashed reader must
        not look like a completed epoch), and abandoning the iterator
        mid-epoch (``break`` in the training loop) cancels the producer
        instead of leaving it blocked on the bounded queue."""
        q: queue.Queue = queue.Queue(maxsize=prefetch)
        stop = object()
        cancelled = threading.Event()

        def put(item) -> bool:
            while not cancelled.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def producer():
            try:
                for bi, idx in self._plan(epoch):
                    if not put(self._fill_batch(self.cfg.buckets[bi], idx)):
                        return
                put(stop)
            except BaseException as e:  # re-raised in the consumer
                put(e)

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is stop:
                    break
                if isinstance(item, BaseException):
                    raise item
                yield item
        finally:
            cancelled.set()

    def repeat(self, start_epoch: int = 0) -> Iterator[Dict]:
        e = start_epoch
        while True:
            yield from self.epoch(e)
            e += 1
