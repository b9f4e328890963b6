"""Batch-pipeline configuration (port of ``PipelineConfig`` from
``phones_las_tpu/data/pipeline.py``): the static batch shapes a preset
trains and decodes with. Batches are padded to one of a few bucket
lengths of audio; targets carry an appended ``<eos>``."""

from __future__ import annotations

import dataclasses
from typing import Sequence


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
