"""CTC decoding with the encoder CTC head (port of
``phones_las_tpu/decode/ctc.py``).

Three uses of the head trained by joint CTC-attention training
(``LASConfig.ctc_weight``):

  * greedy CTC, frame-synchronous: ``ctc_frame_ids`` (per-frame argmax,
    blank at pad) and ``collapse`` on the host (merge repeats, drop blanks);
  * two-pass joint decoding: ``rescore_beams`` rescores the beam's K
    hypotheses with the CTC sequence log-probability and repicks;
  * one-pass joint decoding: the CTC prefix scores inside the beam loop
    (Watanabe et al. 2017, Algorithm 2), ``ctc_prefix_init`` /
    ``ctc_prefix_scores`` / ``ctc_prefix_update`` on a static-shape
    ``[B, K, T'+1]`` state. The per-candidate score is one product and a
    log-sum-exp over frames; the per-step DP update is two affine
    recurrences over frames, each a log-depth scan (``_affine_log_scan``).

Conventions: ``lp`` is the log-softmax CTC head ``[B, T', V]``, blank = id 0
(the pad id, which the attention decoder never emits); state arrays have
T'+1 slots, slot t meaning "after consuming frame t" (slot 0: before any
frame). Padded frames are identity in the DP and left out of score
reductions, so slot T' holds the value at the true encoder length.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional

import numpy as np
import torch
import torch.nn.functional as Fn

_NEG = -1.0e9


def _length_penalty(lengths: torch.Tensor, alpha: float) -> torch.Tensor:
    """Google-NMT length penalty ``((5 + len) / 6)^α`` (1 when α = 0)."""
    if alpha == 0.0:
        return torch.ones_like(lengths, dtype=torch.float32)
    return torch.pow((5.0 + lengths.to(torch.float32)) / 6.0, alpha)


def ctc_frame_ids(params, memory: torch.Tensor, enc_mask: torch.Tensor) -> torch.Tensor:
    """Per-frame argmax ids of the CTC head [B, T'] int32, pad frames
    forced to blank 0."""
    logits = torch.matmul(memory, params.ctc_w) + params.ctc_b
    ids = torch.argmax(logits, dim=-1).to(torch.int32)
    return torch.where(enc_mask > 0, ids, torch.zeros_like(ids))


def rescore_beams(
    ctc_logits: torch.Tensor,  # [B, T', V] encoder CTC head logits
    enc_mask: torch.Tensor,  # [B, T']
    beam_tokens: torch.Tensor,  # [B, K, S] <eos>-padded hypotheses
    beam_lengths: torch.Tensor,  # [B, K] token counts excluding <eos>
    beam_logp: torch.Tensor,  # [B, K] raw attention log probs
    alpha: float = 0.7,
    *,
    beam_finished: Optional[torch.Tensor] = None,  # [B, K] bool
    length_penalty: float = 0.0,
):
    """Two-pass joint decoding: score = α·logP_att + (1−α)·logP_ctc over
    the K hypotheses, divided by the length penalty, and repick (with
    ``beam_finished``, under the beam's prefer-finished rule).

    → (best_idx [B], combined [B, K]). The CTC term is
    ``-F.ctc_loss`` per hypothesis; an empty hypothesis gets its exact
    score, the all-blank path; a hypothesis CTC cannot reach (longer than
    the frames) gets the floor −1e7 and so keeps its attention-only rank.
    ``F.ctc_loss`` runs with ``zero_infinity=False`` here: its
    ``zero_infinity`` would score an unreachable hypothesis 0, the best
    score there is (the reference's optax loss gives a large finite value
    that the same floor bounds)."""
    b, k, s = beam_tokens.shape
    lp = torch.log_softmax(ctc_logits.to(torch.float32), dim=-1)  # [B, T', V]
    in_lens = enc_mask.sum(dim=1).long()
    lab_lens = torch.clamp_min(beam_lengths.long(), 1).reshape(b * k)
    pos = torch.arange(s, device=beam_tokens.device)[None, :]
    labels = beam_tokens.reshape(b * k, s).long()
    # an empty hypothesis still needs one label slot for the DP; its
    # score is replaced below
    labels = torch.where(pos >= lab_lens[:, None], torch.zeros_like(labels), labels)
    lp_rep = lp.repeat_interleave(k, dim=0).transpose(0, 1)  # [T', B·K, V]
    nll = Fn.ctc_loss(
        lp_rep, labels, in_lens.repeat_interleave(k), lab_lens,
        blank=0, reduction="none", zero_infinity=False,
    )
    ctc = (-nll).reshape(b, k)
    empty = torch.sum(lp[:, :, 0] * enc_mask.to(torch.float32), dim=-1)  # all-blank path
    ctc = torch.where(beam_lengths == 0, empty[:, None].expand(b, k), ctc)
    ctc = torch.clamp_min(ctc, -1e7)
    combined = alpha * beam_logp + (1.0 - alpha) * ctc
    combined = combined / _length_penalty(beam_lengths, length_penalty)
    if beam_finished is not None:
        any_fin = beam_finished.any(dim=1, keepdim=True)
        combined = torch.where(any_fin & ~beam_finished, torch.full_like(combined, _NEG), combined)
    return torch.argmax(combined, dim=1), combined


class CTCPrefixState(NamedTuple):
    """Per-beam CTC prefix-DP state for hypotheses g.

    lrn[b,k,t] = log P(a CTC path emits exactly g within frames ≤ t and
    ends in g's last symbol); lrb likewise, ending in blank; psi[b,k] =
    log CTC prefix probability of g (already banked in the beam score).
    """

    lrn: torch.Tensor  # [B, K, T'+1] f32
    lrb: torch.Tensor  # [B, K, T'+1] f32
    psi: torch.Tensor  # [B, K] f32


def _affine_log_scan(la: torch.Tensor, lb: torch.Tensor) -> torch.Tensor:
    """Cumulative ``x_t = a_t·x_{t−1} + b_t`` in log space along the last
    axis for x_0 = 0 (log −inf) → log x_t.

    The pairs compose associatively, (a1, b1)∘(a2, b2) = (a1a2, a2·b1 + b2),
    so an inclusive Hillis–Steele scan takes ⌈log₂ T'⌉ passes of whole-array
    ops on shifted views. It sums in another order than the reference's
    ``lax.associative_scan``: values agree to rounding."""
    t = la.shape[-1]
    d = 1
    while d < t:
        lb = torch.cat([lb[..., :d], torch.logaddexp(lb[..., :-d] + la[..., d:], lb[..., d:])], dim=-1)
        la = torch.cat([la[..., :d], la[..., :-d] + la[..., d:]], dim=-1)
        d *= 2
    return lb


def _gather_frames(lp: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """lp [B, T', V], ids [B, K] → lp[b, :, ids[b, k]] as [B, K, T']."""
    b, t, _ = lp.shape
    return torch.gather(lp.transpose(1, 2), 1, ids.long()[..., None].expand(b, ids.shape[1], t))


def ctc_prefix_init(lp: torch.Tensor, valid: torch.Tensor, beam_width: int) -> CTCPrefixState:
    """State of the empty prefix ∅ over K beams: r^b_t(∅) = Π_{τ≤t} p_τ(blank),
    r^n_t(∅) = 0, ψ(∅) = 1. lp [B, T', V]; valid [B, T'] frame mask."""
    b, t, _ = lp.shape
    lpb = torch.where(valid > 0, lp[:, :, 0], torch.zeros_like(lp[:, :, 0]))  # pad frames: identity
    lrb = torch.cat([torch.zeros((b, 1), dtype=torch.float32, device=lp.device), torch.cumsum(lpb, dim=-1)], dim=-1)
    lrb = lrb[:, None, :].expand(b, beam_width, t + 1).contiguous()
    lrn = torch.full((b, beam_width, t + 1), _NEG, dtype=torch.float32, device=lp.device)
    psi = torch.zeros((b, beam_width), dtype=torch.float32, device=lp.device)
    return CTCPrefixState(lrn=lrn, lrb=lrb, psi=psi)


def ctc_prefix_scores(
    state: CTCPrefixState,
    lp: torch.Tensor,  # [B, T', V] log-softmax CTC head
    pexp: torch.Tensor,  # [B, T', V] = exp(lp), computed once per decode
    valid: torch.Tensor,  # [B, T'] frame mask
    prev: torch.Tensor,  # [B, K] last token of each hypothesis (bos at ∅)
    eos_id: int,
    bos_id: int,
) -> torch.Tensor:
    """log CTC prefix probability ψ(g·c) for every candidate token c →
    [B, K, V]; column eos holds the complete-sequence CTC score of g,
    columns blank and bos −1e9 (not extendable under CTC)."""
    v = lp.shape[-1]
    lrn_p, lrb_p = state.lrn[..., :-1], state.lrb[..., :-1]  # value at t−1
    vmask = (valid > 0)[:, None, :]  # [B, 1, T']
    neg = torch.full_like(lrn_p, _NEG)

    # generic column (c ≠ last(g)): Φ_t = r^b_{t−1} + r^n_{t−1}; the
    # reduction ψ(c) = Σ_t Φ_t·p_t(c) is a product in probability space,
    # shifted by each beam's max
    lphi = torch.where(vmask, torch.logaddexp(lrb_p, lrn_p), neg)
    m = torch.clamp_min(torch.amax(lphi, dim=-1, keepdim=True), _NEG)  # [B, K, 1]
    phi = torch.exp(lphi - m)
    psi_all = m + torch.log(torch.clamp_min(torch.matmul(phi, pexp), 1e-38))

    # repeat column (c == last(g)): Φ_t = r^b_{t−1} only (a repeated label
    # must cross a blank)
    lp_prev = _gather_frames(lp, prev)
    psi_rep = torch.logsumexp(torch.where(vmask, lrb_p + lp_prev, neg), dim=-1)  # [B, K]

    is_prev = torch.arange(v, device=lp.device) == prev.long()[..., None]  # [B, K, V]
    psi = torch.where(is_prev, psi_rep[..., None].expand_as(psi_all), psi_all)
    # eos: ψ = the full-sequence CTC probability of g itself
    psi[..., eos_id] = torch.logaddexp(state.lrn[..., -1], state.lrb[..., -1])
    psi[..., 0] = _NEG  # blank/pad is not a label
    psi[..., bos_id] = _NEG
    return torch.clamp_min(psi, _NEG)


def ctc_prefix_update(
    state: CTCPrefixState,  # the parents' states, reordered
    psi_flat: torch.Tensor,  # [B, K·V] this step's ψ, flattened
    flat_idx: torch.Tensor,  # [B, K] top-k picks into psi_flat
    tok: torch.Tensor,  # [B, K] chosen tokens c
    parent_prev: torch.Tensor,  # [B, K] last token of the parent hypothesis
    frozen: torch.Tensor,  # [B, K] bool: keep the parent state (finished beams)
    lp: torch.Tensor,  # [B, T', V]
    valid: torch.Tensor,  # [B, T']
) -> CTCPrefixState:
    """Advance the prefix DP to g·c for the chosen extensions:
    r^n_t(g·c) = (r^n_{t−1}(g·c) + Φ_t)·p_t(c) and
    r^b_t(g·c) = (r^b_{t−1}(g·c) + r^n_{t−1}(g·c))·p_t(blank), two affine
    recurrences along t."""
    b, k, _ = state.lrn.shape
    vmask = (valid > 0)[:, None, :]
    lrn_p, lrb_p = state.lrn[..., :-1], state.lrb[..., :-1]
    neg = torch.full_like(lrn_p, _NEG)
    zero = torch.zeros_like(lrn_p)
    neg1 = torch.full((b, k, 1), _NEG, dtype=torch.float32, device=lp.device)

    lp_tok = _gather_frames(lp, tok)  # [B, K, T']
    rep = (tok == parent_prev)[..., None]
    lphi = torch.where(rep, lrb_p, torch.logaddexp(lrb_p, lrn_p))

    # r^n scan (x_0 = 0): a_t = p_t(c), b_t = Φ_t·p_t(c); pad → identity
    la = torch.where(vmask, lp_tok, zero)
    lb = torch.where(vmask, lphi + lp_tok, neg)
    lrn_full = torch.cat([neg1, _affine_log_scan(la, lb)], dim=-1)

    # r^b scan (x_0 = 0): a_t = p_t(blank), b_t = r^n_{t−1}(g·c)·p_t(blank)
    lpb = lp[:, None, :, 0].expand_as(lrn_p)
    la_b = torch.where(vmask, lpb, zero)
    lb_b = torch.where(vmask, lrn_full[..., :-1] + lpb, neg)
    lrb_full = torch.cat([neg1, _affine_log_scan(la_b, lb_b)], dim=-1)

    psi_new = torch.gather(psi_flat, 1, flat_idx)  # [B, K]
    keep = frozen[..., None]
    return CTCPrefixState(
        lrn=torch.where(keep, state.lrn, torch.clamp_min(lrn_full, _NEG)),
        lrb=torch.where(keep, state.lrb, torch.clamp_min(lrb_full, _NEG)),
        psi=torch.where(frozen, state.psi, psi_new),
    )


def collapse(ids: np.ndarray, lengths: np.ndarray, blank: int = 0) -> List[List[int]]:
    """Host half of greedy CTC: merge consecutive repeats, drop blanks."""
    out = []
    ids = np.asarray(ids)
    for b in range(ids.shape[0]):
        row, prev, seq = ids[b, : int(lengths[b])], blank, []
        for t in row:
            t = int(t)
            if t != prev and t != blank:
                seq.append(t)
            prev = t
        out.append(seq)
    return out
