"""Greedy decoding (port of ``phones_las_tpu/decode/greedy.py``).

TF ``GreedyEmbeddingHelper`` + ``dynamic_decode`` semantics: start from
<sos>, feed back the argmax token, and stop a row once it emits <eos>
(finished rows keep emitting <eos>). A CUDA tensor whose config the
fused decoder supports goes through the CUDA kernel
(``decode/fused_greedy.py``) at every batch size, in the layout its plan's
step model says is the fastest at the shape (clusters, or the whole card
with the weights held in shared memory or streamed); otherwise the decode is
a Python loop over ``speller_step``. That loop is also the reference's
own path for what the kernel does not compute (the ``*_monotonic``
attention variants, binf 'logits' and 'embedding', no attention layer).
A kernel that fails to build or launch raises: it never gives way to the
loop.

``prec`` is the speller's recurrent-dot precision ('highest' or 'bf16',
``ops.lstm.resolve_rnn_precision`` of the config's ``matmul_precision``):
the loop runs its dots at it. The fused kernel computes float32 whatever
``prec`` says, as the reference kernel runs HIGHEST dots in every mode.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from phones_las_torch.decode.fused_greedy import decoded_lengths, greedy_decode_fused, supports
from phones_las_torch.models.speller import (
    SpellerConfig,
    SpellerParams,
    embed_tokens,
    init_speller_carry,
    speller_step,
)
from phones_las_torch.ops.attention import precompute_keys


def greedy_decode_steps(
    params: SpellerParams,
    cfg: SpellerConfig,
    memory: torch.Tensor,  # [B, Tenc, M]
    enc_mask: torch.Tensor,  # [B, Tenc]
    max_steps: int,
    *,
    return_alignments: bool = False,
    prec: str = "highest",
) -> Tuple[torch.Tensor, torch.Tensor, Optional[torch.Tensor]]:
    """The speller-step loop, a fixed ``max_steps`` trips as the
    reference's ``lax.scan`` → (tokens [B, max_steps], lengths [B]
    excluding <eos>, alignments [B, max_steps, Tenc] or None)."""
    b, t_enc = memory.shape[:2]
    dev = memory.device
    keys = precompute_keys(params.attention, memory)
    carry = init_speller_carry(cfg, b, t_enc, dev)
    token = torch.full((b,), cfg.bos_id, dtype=torch.long, device=dev)
    finished = torch.zeros((b,), dtype=torch.bool, device=dev)
    tokens = torch.empty((b, max_steps), dtype=torch.int32, device=dev)
    aligns = torch.empty((b, max_steps, t_enc), device=dev) if return_alignments else None
    for s in range(max_steps):
        emb = embed_tokens(params, cfg, token)
        carry, logits, extras = speller_step(params, cfg, carry, emb, keys, memory, enc_mask, prec=prec)
        nxt = torch.where(finished, cfg.eos_id, torch.argmax(logits, dim=-1))
        finished = finished | (nxt == cfg.eos_id)
        tokens[:, s] = nxt.to(torch.int32)
        if return_alignments:
            aligns[:, s] = extras["probs"]
        token = nxt
    return tokens, decoded_lengths(tokens, cfg.eos_id), aligns


def greedy_decode(
    params: SpellerParams,
    cfg: SpellerConfig,
    memory: torch.Tensor,  # [B, Tenc, M]
    enc_mask: torch.Tensor,  # [B, Tenc]
    max_steps: int,
    *,
    return_alignments: bool = False,
    prec: str = "highest",
) -> Tuple[torch.Tensor, torch.Tensor, Optional[torch.Tensor]]:
    """→ (tokens [B, max_steps] (<eos>-padded), lengths [B] excluding
    <eos>, alignments or None). The fused kernel returns no alignments,
    so ``return_alignments=True`` takes the loop."""
    if memory.is_cuda and supports(cfg) and not return_alignments:
        # float32 in both modes: the kernel ignores ``prec``
        tokens, lengths = greedy_decode_fused(params, cfg, memory, enc_mask, max_steps)
        return tokens, lengths, None
    return greedy_decode_steps(
        params, cfg, memory, enc_mask, max_steps, return_alignments=return_alignments, prec=prec
    )
