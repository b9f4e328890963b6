"""Edit-distance PER (a copy of ``phones_las_tpu/train/metrics.py::
edit_distance_stats`` and its helpers, so the port imports nothing of the
JAX package)."""

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
