"""Attention mechanisms for the speller (port of
``phones_las_tpu/ops/attention.py``): Bahdanau (additive, optionally
weight-normalised) and Luong (multiplicative, optionally scaled) with a
softmax over masked encoder positions. The ``*_monotonic`` variants are
not ported yet and raise ``NotImplementedError``. Parameters are created
frozen (``requires_grad=False``); a trainer turns gradients on."""

from __future__ import annotations

import math

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
    """query [B, Q] → scores [B, T]."""
    if base_variant in ("bahdanau", "bahdanau_norm"):
        q = torch.matmul(query, params.wq)  # [B, A]
        v = params.v
        act = keys + q[:, None, :]
        if base_variant == "bahdanau_norm":
            v = params.g * v * torch.rsqrt(torch.sum(v * v) + 1e-12)
            act = act + params.b
        return torch.matmul(torch.tanh(act), v)
    scores = torch.einsum("bta,ba->bt", keys, query)
    if base_variant == "luong_scaled":
        scores = scores * params.v
    return scores


def attention_scores(
    params: AttentionParams,
    variant: str,
    query: torch.Tensor,  # [B, Q]
    keys: torch.Tensor,  # [B, T, A]
    mask: torch.Tensor,  # [B, T] 1 for valid
) -> torch.Tensor:
    """Attention probabilities [B, T]: softmax over ``where(mask, s, -1e9)``."""
    if variant.endswith("_monotonic"):
        raise NotImplementedError(f"{variant!r}: monotonic attention is not ported yet")
    if variant not in SOFTMAX_VARIANTS:
        raise ValueError(f"unknown attention variant {variant!r}")
    scores = _raw_scores(params, variant, query, keys)
    scores = torch.where(mask > 0, scores, torch.full_like(scores, _NEG))
    return torch.softmax(scores, dim=-1)


def attention_context(probs: torch.Tensor, memory: torch.Tensor) -> torch.Tensor:
    """[B, T] × [B, T, M] → [B, M]."""
    return torch.einsum("bt,btm->bm", probs, memory)
