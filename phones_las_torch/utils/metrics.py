"""Eval metrics: edit-distance PER/CER, word error rate and the attention
alignment image (a copy of ``phones_las_tpu/train/metrics.py``, so the port
imports nothing of the JAX package)."""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

try:
    import Levenshtein as _lev

    def _edit_distance(a: Sequence[int], b: Sequence[int]) -> int:
        # map ids to unicode chars so the C implementation applies
        sa = "".join(chr(i + 1) for i in a)
        sb = "".join(chr(i + 1) for i in b)
        return _lev.distance(sa, sb)

except ImportError:  # pragma: no cover

    def _edit_distance(a: Sequence[int], b: Sequence[int]) -> int:
        la, lb = len(a), len(b)
        dp = list(range(lb + 1))
        for i in range(1, la + 1):
            prev, dp[0] = dp[0], i
            for j in range(1, lb + 1):
                cur = min(dp[j] + 1, dp[j - 1] + 1, prev + (a[i - 1] != b[j - 1]))
                prev, dp[j] = dp[j], cur
        return dp[lb]


def _trim(ids: np.ndarray, length: int) -> List[int]:
    return [int(x) for x in ids[:length]]


def edit_distance_stats(
    hyp_ids: np.ndarray,  # [B, S]
    hyp_lengths: np.ndarray,  # [B]
    ref_ids: np.ndarray,  # [B, S']
    ref_lengths: np.ndarray,  # [B]
    *,
    num_real: Optional[int] = None,
    fold: Optional[Dict[int, Optional[int]]] = None,
) -> Tuple[int, int]:
    """→ (total edit distance, total reference tokens). ``fold`` maps
    id → folded id (None deletes the token), applied to both sides.
    ``ref_lengths`` should exclude <eos>."""

    def apply_fold(seq):
        if fold is None:
            return seq
        out = []
        for t in seq:
            t2 = fold.get(t, t)
            if t2 is not None:
                out.append(t2)
        return out

    n = num_real if num_real is not None else hyp_ids.shape[0]
    dist = tokens = 0
    for i in range(n):
        h = apply_fold(_trim(hyp_ids[i], int(hyp_lengths[i])))
        r = apply_fold(_trim(ref_ids[i], int(ref_lengths[i])))
        dist += _edit_distance(h, r)
        tokens += len(r)
    return dist, tokens


def per_from_stats(dist: int, tokens: int) -> float:
    return dist / max(tokens, 1)


def attention_image(
    probs: np.ndarray,  # [S_dec, T_enc]
    dec_len: int,
    enc_len: int,
) -> np.ndarray:
    """Alignment heatmap, cropped to true lengths and normalized to [0, 1],
    shaped [S, T, 1] for image summaries."""
    img = np.asarray(probs[:dec_len, :enc_len], np.float32)
    mx = img.max() or 1.0
    return (img / mx)[..., None]


def word_error_stats(
    hyp_ids: np.ndarray,  # [B, S]
    hyp_lengths: np.ndarray,  # [B]
    ref_ids: np.ndarray,  # [B, S']
    ref_lengths: np.ndarray,  # [B]
    sep_id: int,
    *,
    num_real: Optional[int] = None,
) -> Tuple[int, int]:
    """→ (total word edit distance, total reference words): token id
    sequences are split on ``sep_id`` (the word-break token of char or
    grapheme targets) and Levenshtein runs over whole words."""

    def words(seq):
        out, cur = [], []
        for t in seq:
            if t == sep_id:
                if cur:
                    out.append(tuple(cur))
                cur = []
            else:
                cur.append(t)
        if cur:
            out.append(tuple(cur))
        return out

    intern: Dict[tuple, int] = {}

    def ids(ws):
        return [intern.setdefault(w, len(intern)) for w in ws]

    n = num_real if num_real is not None else hyp_ids.shape[0]
    dist = nwords = 0
    for i in range(n):
        h = words(_trim(hyp_ids[i], int(hyp_lengths[i])))
        r = words(_trim(ref_ids[i], int(ref_lengths[i])))
        dist += _edit_distance(ids(h), ids(r))
        nwords += len(r)
    return dist, nwords
