"""N-gram language model for shallow-fusion beam decoding (port of
``phones_las_tpu/decode/lm.py``).

A token-level n-gram LM fitted on transcripts is fused into the beam's
per-step scores as ``log P_am + λ·log P_lm``. The LM is a dense log-prob
table (``[V, V]`` bigram or ``[V, V, V]`` trigram, a few KB to MB at
phone or character vocabularies), so the lookup inside the beam step is
one gather. Smoothing is Jelinek-Mercer interpolation down to an add-k
unigram: ``P(w|h) = λ·ML(w|h) + (1−λ)·P_lower(w)``; every row is a proper
distribution. Fitting, saving and loading are numpy, as the reference's.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch


def fit_ngram_lm(
    sequences: Sequence[np.ndarray],
    vocab_size: int,
    bos_id: int,
    eos_id: int,
    order: int = 2,
    interp: float = 0.8,
    add_k: float = 0.5,
) -> np.ndarray:
    """Count-based interpolated n-gram over token sequences.

    Each sequence is the raw target ids without bos/eos; the fit appends
    ``eos_id`` and uses ``bos_id`` as the left context, as the beam
    consumes the table. → log-prob table ``[V, V]`` (order 2, row = the
    previous token) or ``[V, V, V]`` (order 3, indexed ``[prev2, prev1]``).
    """
    if order not in (2, 3):
        raise ValueError(f"order must be 2 or 3, got {order}")
    v = vocab_size
    uni = np.full((v,), add_k, np.float64)
    big = np.zeros((v, v), np.float64)
    tri = np.zeros((v, v, v), np.float64) if order == 3 else None
    for seq in sequences:
        toks = [int(t) for t in seq] + [eos_id]
        ctx2, ctx1 = bos_id, bos_id  # (prev2, prev1)
        for w in toks:
            uni[w] += 1.0
            big[ctx1, w] += 1.0
            if tri is not None:
                tri[ctx2, ctx1, w] += 1.0
            ctx2, ctx1 = ctx1, w
    p_uni = uni / uni.sum()
    row = big.sum(axis=-1, keepdims=True)
    ml_big = np.divide(big, row, out=np.zeros_like(big), where=row > 0)
    # unseen contexts fall all the way back to the unigram
    lam_b = np.where(row > 0, interp, 0.0)
    p_big = lam_b * ml_big + (1.0 - lam_b) * p_uni[None, :]
    if order == 2:
        return np.log(p_big).astype(np.float32)
    rows3 = tri.sum(axis=-1, keepdims=True)
    ml_tri = np.divide(tri, rows3, out=np.zeros_like(tri), where=rows3 > 0)
    lam_t = np.where(rows3 > 0, interp, 0.0)
    p_tri = lam_t * ml_tri + (1.0 - lam_t) * p_big[None, :, :]
    return np.log(p_tri).astype(np.float32)


def save_lm(path: str, logp: np.ndarray, vocab_tokens: Optional[List[str]] = None):
    np.savez_compressed(
        path,
        logp=logp,
        order=np.int32(logp.ndim),
        vocab=np.asarray(vocab_tokens if vocab_tokens is not None else [], object),
    )


def load_lm(path: str) -> np.ndarray:
    with np.load(path, allow_pickle=True) as z:
        logp = z["logp"].astype(np.float32)
    if logp.ndim not in (2, 3):
        raise ValueError(f"{path}: an n-gram table is [V, V] or [V, V, V], got {logp.shape}")
    return logp


def lm_step_scores(logp: torch.Tensor, prev1: torch.Tensor, prev2: torch.Tensor) -> torch.Tensor:
    """The beam's per-step LM rows: [B, K] contexts → [B, K, V], a gather
    of the table by the last token (bigram) or the last two (trigram).
    The reference multiplies a one-hot of the context by the table (row
    gathers are serial on a TPU); the gather selects the same rows."""
    if logp.ndim == 2:
        return logp[prev1]
    return logp[prev2, prev1]
