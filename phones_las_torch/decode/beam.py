"""Static-shape vectorised beam search (port of ``phones_las_tpu/decode/beam.py``).

Beams are an explicit second batch axis ``[B, K]`` and the loop runs a
fixed ``max_steps`` trips with finished-beam masking, as the reference's
``lax.scan``: no step reads anything back to the host.

  * Keys and memory are never tiled over beams: attention takes the
    ``[B, K, Q]`` queries against the shared ``[B, T, A]`` keys (the
    additive score holds a ``[B, K, T, A]`` intermediate) and the context
    is one ``bkt,btm->bkm`` product.
  * The carry (and the CTC prefix state) is reordered by parent beam with
    an index gather; the reference multiplies by a one-hot of the parents,
    which selects the same values.
  * The top K of the ``[B, K·V]`` candidates come from a stable descending
    sort, so equal scores rank the lower index first, as ``lax.top_k``
    does; ``torch.topk`` promises no order among equal values, and exact
    ties are common (a −1e9 start beam plus a step log-prob is −1e9 in
    float32; a finished beam's non-<eos> entries all tie).
  * Token histories are not carried: each step records (token, parent,
    attention peak), and the beams are rebuilt by a backtrace afterwards.

Semantics: log-softmax accumulation; a finished beam extends only with
<eos> at log-prob 0 (its score frozen); optional one-pass joint CTC
(``step = α·attn + (1−α)·Δψ_ctc``) and n-gram shallow fusion outside the
α-mix (``+ λ·lm``, masked for finished beams); the Google-NMT length
penalty ``((5+len)/6)^α``; the final pick prefers finished beams.

Plain PyTorch on both devices: the step is a few dozen small operations,
so on the card the loop is bound by their launches.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from phones_las_torch.decode.ctc import (
    CTCPrefixState,
    _length_penalty,
    ctc_prefix_init,
    ctc_prefix_scores,
    ctc_prefix_update,
)
from phones_las_torch.decode.lm import lm_step_scores
from phones_las_torch.models.speller import (
    SpellerCarry,
    SpellerConfig,
    SpellerParams,
    embed_tokens,
    init_speller_carry,
    speller_step,
)
from phones_las_torch.ops.attention import precompute_keys

_NEG = -1e9


class BeamResult(NamedTuple):
    tokens: torch.Tensor  # [B, max_steps] best beam, <eos>-padded
    lengths: torch.Tensor  # [B] token count excluding <eos>
    scores: torch.Tensor  # [B] length-normalised log prob of the best beam
    beam_tokens: torch.Tensor  # [B, K, max_steps]
    beam_lengths: torch.Tensor  # [B, K]
    beam_scores: torch.Tensor  # [B, K] length-penalty-normalised
    # raw log probs and finished flags, for external rescorers
    beam_logp: Optional[torch.Tensor] = None  # [B, K]
    beam_finished: Optional[torch.Tensor] = None  # [B, K] bool
    # the best beam's attention-peak encoder frame per token (timestamps)
    peaks: Optional[torch.Tensor] = None  # [B, max_steps] int32


def _map_carry(fn, carry: SpellerCarry) -> SpellerCarry:
    return SpellerCarry(
        tuple((fn(h), fn(c)) for h, c in carry.states), fn(carry.attn_vec), fn(carry.alignment)
    )


def topk_stable(x: torch.Tensor, k: int):
    """The k largest entries of each row of ``x`` [B, N] → (values, indices),
    equal values in ascending index order (``lax.top_k``'s order)."""
    values, indices = torch.sort(x, dim=1, descending=True, stable=True)
    return values[:, :k], indices[:, :k]


def beam_decode(
    params: SpellerParams,
    cfg: SpellerConfig,
    memory: torch.Tensor,  # [B, Tenc, M]
    enc_mask: torch.Tensor,  # [B, Tenc]
    max_steps: int,
    beam_width: int = 8,
    length_penalty: float = 0.0,
    lm_logp: Optional[torch.Tensor] = None,  # [V, V] or [V, V, V] n-gram table (decode.lm)
    lm_weight: float = 0.0,
    ctc_logp: Optional[torch.Tensor] = None,  # [B, Tenc, V] log-softmax CTC head
    ctc_alpha: float = 0.7,  # step score = α·attn + (1−α)·Δψ_ctc
    prec: str = "highest",
) -> BeamResult:
    """Beam search over the speller on ``memory``'s device → ``BeamResult``.
    ``ctc_logp`` with ``ctc_alpha < 1`` turns on one-pass joint CTC
    decoding; ``lm_logp`` with ``lm_weight != 0`` n-gram fusion. ``prec``
    is the speller's recurrent-dot precision, as in ``ops.lstm``."""
    b, t_enc, _ = memory.shape
    k, v = beam_width, cfg.vocab_size
    dev = memory.device
    joint = ctc_logp is not None and ctc_alpha < 1.0
    use_lm = lm_logp is not None and lm_weight != 0.0

    keys = precompute_keys(params.attention, memory)  # [B, T, A], not tiled
    c0 = init_speller_carry(cfg, b * k, t_enc, dev)
    carry = _map_carry(lambda x: x.reshape(b, k, -1), c0)  # [B, K, ...] throughout
    # beam 0 live, the others at −1e9 so step 1 spreads over distinct tokens
    logp = torch.full((b, k), _NEG, dtype=torch.float32, device=dev)
    logp[:, 0] = 0.0
    finished = torch.zeros((b, k), dtype=torch.bool, device=dev)
    lengths = torch.zeros((b, k), dtype=torch.int32, device=dev)
    prev = torch.full((b, k), cfg.bos_id, dtype=torch.long, device=dev)
    prev2 = prev.clone()  # trigram-LM context
    # finished-beam continuation row: <eos> at log-prob 0, the rest impossible
    eos_row = torch.full((v,), _NEG, dtype=torch.float32, device=dev)
    eos_row[cfg.eos_id] = 0.0
    rows = torch.arange(b, device=dev)[:, None]  # gather index of the batch axis
    if joint:
        ctc_lp = ctc_logp.to(torch.float32)
        ctc_pexp = torch.exp(ctc_lp)
        cstate = ctc_prefix_init(ctc_lp, enc_mask, k)
    if use_lm:
        lm_logp = lm_logp.to(device=dev, dtype=torch.float32)

    toks_s, parents_s, peaks_s = [], [], []
    for _ in range(max_steps):
        emb = embed_tokens(params, cfg, prev)  # [B, K, E]
        carry, logits, extras = speller_step(params, cfg, carry, emb, keys, memory, enc_mask, prec=prec)
        peak = torch.argmax(extras["probs"], dim=-1)  # [B, K]
        fin = finished[..., None]
        step_logp = torch.where(fin, eos_row, torch.log_softmax(logits, dim=-1))  # [B, K, V]
        if joint:
            psi_mat = ctc_prefix_scores(cstate, ctc_lp, ctc_pexp, enc_mask, prev, cfg.eos_id, cfg.bos_id)
            delta = torch.where(fin, 0.0, psi_mat - cstate.psi[..., None])
            step_logp = ctc_alpha * step_logp + (1.0 - ctc_alpha) * delta
        if use_lm:
            # shallow fusion outside the joint α-mix (α·att + (1−α)·ctc + λ·lm),
            # masked so a finished beam's <eos> continuation stays at 0
            step_logp = step_logp + torch.where(fin, 0.0, lm_weight * lm_step_scores(lm_logp, prev, prev2))

        total = logp[..., None] + step_logp  # [B, K, V]
        logp, flat_idx = topk_stable(total.reshape(b, k * v), k)
        parent = torch.div(flat_idx, v, rounding_mode="floor")  # [B, K]
        tok = flat_idx - parent * v

        carry = _map_carry(lambda x: x[rows, parent], carry)
        finished = finished[rows, parent] | (tok == cfg.eos_id)
        lengths = lengths[rows, parent] + (~finished).to(torch.int32)
        # the step's attention peak belongs to the parent beam's step
        peaks_s.append(peak[rows, parent])
        # the new beam's previous-previous token is its parent's last token
        prev2 = prev[rows, parent]
        if joint:
            cparent = CTCPrefixState(*(x[rows, parent] for x in cstate))
            cstate = ctc_prefix_update(
                cparent, psi_mat.reshape(b, k * v), flat_idx, tok, prev2, finished, ctc_lp, enc_mask
            )
        prev = tok
        toks_s.append(tok)
        parents_s.append(parent)

    # backtrace: rebuild [B, K, S] token histories and attention peaks
    idx = torch.arange(k, device=dev)[None, :].expand(b, k)
    toks_out, peaks_out = [], []
    for tok, parent, pk in zip(reversed(toks_s), reversed(parents_s), reversed(peaks_s)):
        toks_out.append(tok[rows, idx])
        peaks_out.append(pk[rows, idx])
        idx = parent[rows, idx]
    tokens = torch.stack(toks_out[::-1], dim=-1).to(torch.int32)  # [B, K, S]
    peaks = torch.stack(peaks_out[::-1], dim=-1).to(torch.int32)

    scores = logp / _length_penalty(lengths, length_penalty)
    any_fin = finished.any(dim=1, keepdim=True)
    pick_scores = torch.where(any_fin & ~finished, torch.full_like(scores, _NEG), scores)
    best = torch.argmax(pick_scores, dim=1)  # [B]
    bidx = torch.arange(b, device=dev)
    return BeamResult(
        tokens=tokens[bidx, best],
        lengths=lengths[bidx, best],
        scores=pick_scores[bidx, best],
        beam_tokens=tokens,
        beam_lengths=lengths,
        beam_scores=scores,
        beam_logp=logp,
        beam_finished=finished,
        peaks=peaks[bidx, best],
    )
