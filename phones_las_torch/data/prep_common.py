"""Shared corpus-preparation machinery (port of
``phones_las_tpu/data/prep_common.py``): serialize utterances, write the
vocabulary files, accumulate global CMVN stats.

CMVN is computed with the port's own front-end (``frontend/
fused_frontend.py``: the CUDA kernel on the card, its plain version on
the CPU), so the stats match training numerics instead of trusting a
separate offline implementation.
"""

from __future__ import annotations

import json
import os
from typing import Callable, Iterable, List, Optional, Tuple

import numpy as np
import torch

from phones_las_torch.data.records import RecordReader, RecordWriter, Utterance
from phones_las_torch.data.vocab import Vocab
from phones_las_torch.frontend.cmvn import CmvnStats
from phones_las_torch.frontend.features import FrontendConfig, num_frames
from phones_las_torch.utils.device import DeviceLike, resolve_device


def write_corpus_split(
    out_path: str,
    items: Iterable[Tuple[str, str, List[str], Optional[List[str]], str]],
    vocab: Vocab,
    grapheme_vocab: Optional[Vocab] = None,
    *,
    read_audio: Optional[Callable] = None,
    meta: Optional[dict] = None,
    expected_rate: int = 16000,
    log_every: int = 500,
    log=print,
) -> int:
    """items: (utt_id, audio_path, tokens, grapheme_tokens|None, text).
    Returns the number of utterances written. Streams at other rates are
    resampled to ``expected_rate``; an undecodable clip is skipped and
    counted, but a missing decoder or resampler (which fails every clip)
    raises, and so does a split in which every clip failed."""
    if read_audio is None:
        from phones_las_torch.data.audio_io import read_audio
    n = 0
    skipped = 0
    with RecordWriter(out_path, meta=meta) as w:
        for utt_id, path, tokens, graphemes, text in items:
            try:
                audio, rate = read_audio(path, target_rate=expected_rate)
            except ValueError as e:
                if "native decoder" in str(e) or "resampler" in str(e):
                    raise
                skipped += 1
                log(f"  skipping undecodable clip: {e}")
                continue
            if rate != expected_rate:
                raise ValueError(f"{path}: sample rate {rate} != {expected_rate}")
            w.write(
                Utterance(
                    utt_id,
                    audio,
                    np.asarray(vocab.encode(tokens), np.int32),
                    (
                        np.asarray(grapheme_vocab.encode(graphemes), np.int32)
                        if grapheme_vocab is not None and graphemes is not None
                        else None
                    ),
                    text,
                )
            )
            n += 1
            if log_every and n % log_every == 0:
                log(f"  {out_path}: {n} utterances")
    if skipped:
        log(f"  {out_path}: skipped {skipped} undecodable clip(s)")
        if n == 0:
            raise ValueError(
                f"{out_path}: every clip failed to decode ({skipped} skipped) — "
                "systemic decode problem, not corrupt data"
            )
    return n


def compute_cmvn(
    record_path: str,
    frontend_cfg: FrontendConfig,
    *,
    max_utts: Optional[int] = 500,
    pad_quantum: int = 32000,
    device: DeviceLike = None,
) -> CmvnStats:
    """Global per-dim feature stats through the port's front-end on
    ``device`` (None → CUDA, where the front-end kernel computes them).
    Each utterance is padded to a multiple of ``pad_quantum`` samples, as
    the reference pads it, and only its ``num_frames(length)`` frames
    count. ``max_utts=None`` streams the entire corpus (exact global
    CMVN); the default caps the pass at 500 utterances."""
    from phones_las_torch.frontend.fused_frontend import extract_features_fused

    dev = resolve_device(device)
    reader = RecordReader(record_path)
    dim = frontend_cfg.base_dim * (3 if frontend_cfg.add_deltas else 1)
    stats = CmvnStats.zeros(dim)
    take = len(reader) if max_utts is None else min(len(reader), max_utts)
    with torch.no_grad():
        for i in range(take):
            u = reader[i]
            s = u.num_samples
            padded = ((s + pad_quantum - 1) // pad_quantum) * pad_quantum
            audio = np.zeros((1, padded), np.float32)
            audio[0, :s] = u.audio
            n = int(num_frames(padded, frontend_cfg))
            f = extract_features_fused(
                torch.from_numpy(audio).to(dev), frontend_cfg, n_frames=n,
                sample_lengths=torch.tensor([s], dtype=torch.int32, device=dev),
            )
            stats.update(f[0].cpu().numpy(), length=int(num_frames(s, frontend_cfg)))
    return stats


def finalize_split_dir(
    out_dir: str,
    vocab: Vocab,
    *,
    grapheme_vocab: Optional[Vocab] = None,
    cmvn_from: Optional[str] = None,
    frontend_cfg: Optional[FrontendConfig] = None,
    meta: Optional[dict] = None,
    cmvn_max_utts: Optional[int] = 500,
    device: DeviceLike = None,
) -> None:
    """Write vocab/grapheme_vocab/cmvn/meta files next to the records; the
    CMVN pass runs on ``device`` (None → CUDA)."""
    vocab.save(os.path.join(out_dir, "vocab.txt"))
    if grapheme_vocab is not None:
        grapheme_vocab.save(os.path.join(out_dir, "grapheme_vocab.txt"))
    if cmvn_from is not None:
        cfg = frontend_cfg or FrontendConfig()
        stats = compute_cmvn(cmvn_from, cfg, max_utts=cmvn_max_utts, device=device)
        stats.save(os.path.join(out_dir, "cmvn.json"))
    if meta is not None:
        with open(os.path.join(out_dir, "meta.json"), "w") as f:
            json.dump(meta, f, indent=2)
