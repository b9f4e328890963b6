"""Attention mechanisms for the speller (port of
``phones_las_tpu/ops/attention.py``): Bahdanau (additive, optionally
weight-normalised) and Luong (multiplicative, optionally scaled) with a
softmax over masked encoder positions, and their ``*_monotonic`` forms
(the parallel recursion of Raffel et al. 2017 in training and by default,
hard attend-first decisions at test time). A 3-D query ``[B, K, Q]`` (the
beam axis) is scored against the same ``[B, T, A]`` keys: keys and memory
are never tiled over beams. Parameters are created frozen
(``requires_grad=False``); a trainer turns gradients on."""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from phones_las_torch.ops.lstm import glorot_, uniform_

_NEG = -1e9
SOFTMAX_VARIANTS = ("bahdanau", "bahdanau_norm", "luong", "luong_scaled")


class AttentionParams(nn.Module):
    """Parameters of one attention head, with the reference's layout.

    wq: [Q, A] query projection (bahdanau only; None for luong)
    wk: [M, A] memory/key projection
    v:  [A] score vector (bahdanau); scalar gain for luong_scaled
    b:  [A] normalised-bahdanau bias (None otherwise)
    score_bias: scalar bias on monotonic scores (None otherwise)
    g:  scalar weight-norm gain (bahdanau_norm only)
    """

    def __init__(self, variant: str, query_dim: int, memory_dim: int, attn_units: int, device=None):
        super().__init__()
        monotonic = variant.endswith("_monotonic")
        base = variant[: -len("_monotonic")] if monotonic else variant
        if base not in SOFTMAX_VARIANTS:
            raise ValueError(f"unknown attention variant {variant!r}")

        def slot(name, shape):
            t = None if shape is None else nn.Parameter(
                torch.zeros(shape, device=device), requires_grad=False
            )
            self.register_parameter(name, t)

        bahdanau = base in ("bahdanau", "bahdanau_norm")
        slot("wq", (query_dim, attn_units) if bahdanau else None)
        slot("wk", (memory_dim, attn_units))
        slot("v", (attn_units,) if bahdanau else (() if base == "luong_scaled" else None))
        slot("b", (attn_units,) if base == "bahdanau_norm" else None)
        slot("score_bias", () if monotonic else None)
        slot("g", () if base == "bahdanau_norm" else None)


def init_attention_params(
    variant: str, query_dim: int, memory_dim: int, attn_units: int,
    generator: torch.Generator, device=None,
) -> AttentionParams:
    """The reference's initialisation: glorot-uniform projections, v
    uniform in ±sqrt(3/A), zero bias; ``bahdanau_norm``'s gain starts at
    sqrt(1/A) and ``luong_scaled``'s at 1 (draws from ``generator``, on
    the CPU)."""
    p = AttentionParams(variant, query_dim, memory_dim, attn_units, device)
    if p.wq is not None:  # bahdanau: query projection and score vector
        glorot_(p.wq, generator)
    glorot_(p.wk, generator)
    with torch.no_grad():
        if p.wq is not None:
            uniform_(p.v, math.sqrt(3.0 / attn_units), generator)
        elif p.v is not None:  # luong_scaled: scalar gain
            p.v.fill_(1.0)
        if p.g is not None:
            p.g.fill_(math.sqrt(1.0 / attn_units))
    return p


def precompute_keys(params: AttentionParams, memory: torch.Tensor) -> torch.Tensor:
    """[B, T, M] → [B, T, A]; one matrix product, done once per utterance."""
    return torch.matmul(memory, params.wk)


def _raw_scores(params: AttentionParams, base_variant: str, query: torch.Tensor, keys: torch.Tensor):
    """query [B, Q] → scores [B, T]; query [B, K, Q] → [B, K, T] against
    the shared keys (the beamed additive form holds a [B, K, T, A]
    intermediate)."""
    beamed = query.ndim == 3
    if base_variant in ("bahdanau", "bahdanau_norm"):
        q = torch.matmul(query, params.wq)  # [B, A] or [B, K, A]
        v = params.v
        act = keys[:, None, :, :] + q[:, :, None, :] if beamed else keys + q[:, None, :]
        if base_variant == "bahdanau_norm":
            v = params.g * v * torch.rsqrt(torch.sum(v * v) + 1e-12)
            act = act + params.b
        return torch.matmul(torch.tanh(act), v)
    scores = torch.einsum("bta,bka->bkt" if beamed else "bta,ba->bt", keys, query)
    if base_variant == "luong_scaled":
        scores = scores * params.v
    return scores


def hard_monotonic_attention(choose: torch.Tensor, prev_align: torch.Tensor) -> torch.Tensor:
    """Test-time hard monotonic attention: attend the first position at or
    after the previous one whose decision ``choose`` is 1; all zeros when
    there is none (the head has run off the end)."""
    allowed = torch.cumsum(prev_align, dim=-1)  # 1 at and after the previous position
    candidates = choose * torch.clamp_max(allowed, 1.0)
    return candidates * (torch.cumsum(candidates, dim=-1) == 1.0).to(candidates.dtype)


def monotonic_attention(p_choose: torch.Tensor, prev_align: torch.Tensor) -> torch.Tensor:
    """The parallel monotonic recursion:
    ``p · cumprod_excl(1 − p) · cumsum(α_prev / clip(cumprod_excl(1 − p)))``."""
    cp = torch.cumprod(1.0 - p_choose, dim=-1)
    cp_excl = torch.cat([torch.ones_like(cp[..., :1]), cp[..., :-1]], dim=-1)
    q = prev_align / torch.clamp(cp_excl, 1e-10, 1.0)
    return p_choose * cp_excl * torch.cumsum(q, dim=-1)


def attention_scores(
    params: AttentionParams,
    variant: str,
    query: torch.Tensor,  # [B, Q] or [B, K, Q]
    keys: torch.Tensor,  # [B, T, A]
    mask: torch.Tensor,  # [B, T] 1 for valid
    *,
    prev_align: Optional[torch.Tensor] = None,  # monotonic variants only
    sigmoid_noise: float = 0.0,
    generator: Optional[torch.Generator] = None,
    monotonic_mode: str = "parallel",  # 'parallel' | 'hard'
    monotonic_bias: float = 0.0,
) -> torch.Tensor:
    """Attention probabilities [B, T] ([B, K, T] for a beamed query): a
    softmax over ``where(mask, s, -1e9)`` for the standard variants; for
    ``*_monotonic``, the scores plus ``score_bias`` and the decode-time
    ``monotonic_bias`` go through the parallel recursion or, with
    ``monotonic_mode='hard'``, the attend-first decisions ``s > 0``.
    ``sigmoid_noise`` > 0 adds that much Gaussian noise from ``generator``
    to the pre-sigmoid scores (training)."""
    monotonic = variant.endswith("_monotonic")
    base = variant[: -len("_monotonic")] if monotonic else variant
    if base not in SOFTMAX_VARIANTS:
        raise ValueError(f"unknown attention variant {variant!r}")
    scores = _raw_scores(params, base, query, keys)
    if scores.ndim == 3 and mask.ndim == 2:
        mask = mask[:, None, :]  # broadcast over beams
    if not monotonic:
        scores = torch.where(mask > 0, scores, torch.full_like(scores, _NEG))
        return torch.softmax(scores, dim=-1)
    if prev_align is None:
        raise ValueError("monotonic attention needs prev_align")
    scores = scores + params.score_bias + monotonic_bias
    if monotonic_mode == "hard":
        choose = (scores > 0).to(scores.dtype) * mask
        return hard_monotonic_attention(choose, prev_align)
    if sigmoid_noise > 0.0 and generator is not None:
        noise = torch.randn(scores.shape, generator=generator, device=scores.device, dtype=scores.dtype)
        scores = scores + sigmoid_noise * noise
    p_choose = torch.sigmoid(scores) * mask  # never select padding
    return monotonic_attention(p_choose, prev_align)


def attention_context(probs: torch.Tensor, memory: torch.Tensor) -> torch.Tensor:
    """[B, T] × [B, T, M] → [B, M]; beamed [B, K, T] → [B, K, M] (memory
    read once per utterance, not once per beam)."""
    if probs.ndim == 3:
        return torch.einsum("bkt,btm->bkm", probs, memory)
    return torch.einsum("bt,btm->bm", probs, memory)
