"""Speller: attention decoder over the listener's output (port of
``phones_las_tpu/models/speller.py``, decode side).

TF1 ``AttentionWrapper`` semantics: the cell input is ``[embedding;
previous attention vector]``, the attention vector is a linear projection
of ``[cell_output; context]``, and an output projection gives the vocab
logits. Training runs ``teacher_forced_decode``, with optional
scheduled sampling (``ScheduledEmbeddingTrainingHelper``-style per-step
Bernoulli mixing) from an explicit ``torch.Generator``, which also draws
the sigmoid noise of the ``*_monotonic`` attention variants. The same
``speller_step`` serves the teacher-forced loop, the greedy loop and the
beam search, whose carry has an explicit beam axis ``[B, K, ·]``.

Binf output modes:
  * ``head``      — auxiliary sigmoid head on the attention vector;
  * ``logits``    — output projection into binf space, phone logits
    recovered through the static phone-code matrix;
  * ``embedding`` — token embeddings derived from the phone codes.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Tuple, Union

import torch
from torch import nn

from phones_las_torch.ops.attention import (
    AttentionParams,
    attention_context,
    attention_scores,
    init_attention_params,
    precompute_keys,
)
from phones_las_torch.ops.lstm import LSTMParams, glorot_, glorot_lstm_, rec_dot

BINF_MODES = ("none", "head", "logits", "embedding")


@dataclasses.dataclass(frozen=True)
class SpellerConfig:
    vocab_size: int = 50
    embedding_dim: int = 128
    num_layers: int = 1
    units: int = 256
    memory_dim: int = 512  # listener output dim (2 × encoder units)
    attention_type: str = "bahdanau"
    attention_units: int = 256
    monotonic_noise: float = 1.0
    monotonic_mode: str = "parallel"
    monotonic_bias: float = 0.0
    attention_layer_size: int = 256  # 0 → raw [cell_out; context] as attn vector
    sampling_probability: float = 0.0
    bos_id: int = 1
    eos_id: int = 2
    num_binf: int = 0  # 0 → no binf machinery
    binf_mode: str = "none"  # 'none' | 'head' | 'logits' | 'embedding'

    @property
    def attn_vec_dim(self) -> int:
        if self.attention_layer_size > 0:
            return self.attention_layer_size
        return self.units + self.memory_dim


class SpellerParams(nn.Module):
    """Decoder parameters with the reference's layout; absent leaves are None."""

    def __init__(self, cfg: SpellerConfig, device=None):
        super().__init__()

        def slot(name, shape):
            t = None if shape is None else nn.Parameter(
                torch.zeros(shape, device=device), requires_grad=False
            )
            self.register_parameter(name, t)

        emb_rows = cfg.num_binf if cfg.binf_mode == "embedding" else cfg.vocab_size
        slot("embedding", (emb_rows, cfg.embedding_dim))
        in_dims = [cfg.embedding_dim + cfg.attn_vec_dim] + [cfg.units] * (cfg.num_layers - 1)
        self.cells = nn.ModuleList([LSTMParams(d, cfg.units, device) for d in in_dims])
        self.attention = AttentionParams(
            cfg.attention_type, cfg.units, cfg.memory_dim, cfg.attention_units, device
        )
        al = cfg.attention_layer_size
        slot("attention_layer", (cfg.units + cfg.memory_dim, al) if al > 0 else None)
        out_dim = cfg.num_binf if cfg.binf_mode == "logits" else cfg.vocab_size
        slot("out_w", (cfg.attn_vec_dim, out_dim))
        slot("out_b", (out_dim,))
        head = cfg.binf_mode == "head"
        slot("binf_w", (cfg.attn_vec_dim, cfg.num_binf) if head else None)
        slot("binf_b", (cfg.num_binf,) if head else None)
        slot("binf_codes", (cfg.vocab_size, cfg.num_binf) if cfg.binf_mode != "none" else None)


def init_speller(
    cfg: SpellerConfig,
    generator: torch.Generator,
    binf_codes=None,
    device=None,
) -> SpellerParams:
    """The reference's initialisation: embedding N(0, 1), LSTM cells by
    the TF fan-in rule, glorot-uniform attention layer, output and binf
    heads, zero biases (``binf_mode='embedding'``: a glorot [F, E]
    projection in place of the table); ``binf_codes`` [V, F] is data,
    required when a binf mode is on (draws from ``generator``, on the
    CPU)."""
    _check_binf(cfg)
    p = SpellerParams(cfg, device)
    if cfg.binf_mode == "embedding":  # a [num_binf, E] projection
        glorot_(p.embedding, generator)
    else:
        with torch.no_grad():
            p.embedding.copy_(torch.randn(p.embedding.shape, generator=generator))
    for cell in p.cells:
        glorot_lstm_(cell, generator)
    p.attention = init_attention_params(
        cfg.attention_type, cfg.units, cfg.memory_dim, cfg.attention_units, generator, device
    )
    for t in (p.attention_layer, p.out_w, p.binf_w):
        if t is not None:
            glorot_(t, generator)
    if p.binf_codes is not None:
        if binf_codes is None:
            raise ValueError(f"binf_mode={cfg.binf_mode!r} needs binf_codes")
        with torch.no_grad():
            p.binf_codes.copy_(torch.as_tensor(binf_codes, dtype=torch.float32))
    return p


class SpellerCarry(NamedTuple):
    states: Tuple[Tuple[torch.Tensor, torch.Tensor], ...]  # per layer (h, c)
    attn_vec: torch.Tensor  # [B, attn_vec_dim]
    alignment: torch.Tensor  # [B, T_enc] previous attention distribution


def _check_binf(cfg: SpellerConfig) -> None:
    if cfg.binf_mode not in BINF_MODES:
        raise ValueError(f"unknown binf_mode {cfg.binf_mode!r}")


def init_speller_carry(cfg: SpellerConfig, batch: int, enc_len: int = 1, device=None) -> SpellerCarry:
    """Zero decoder state, float32; the ``*_monotonic`` variants start
    from a dirac alignment on the first frame (TF's initial alignment)."""
    z = lambda *shape: torch.zeros(shape, dtype=torch.float32, device=device)
    states = tuple((z(batch, cfg.units), z(batch, cfg.units)) for _ in range(cfg.num_layers))
    align = z(batch, enc_len)
    if cfg.attention_type.endswith("_monotonic"):
        align[:, 0] = 1.0
    return SpellerCarry(states, z(batch, cfg.attn_vec_dim), align)


def embed_tokens(params: SpellerParams, cfg: SpellerConfig, tokens: torch.Tensor) -> torch.Tensor:
    """Token ids [...] → embeddings [..., E]; ``binf_mode='embedding'``
    goes through the code matrix (``binf_codes[tokens] @ embedding``)."""
    _check_binf(cfg)
    if cfg.binf_mode == "embedding":
        return torch.matmul(params.binf_codes[tokens], params.embedding)
    return params.embedding[tokens]


def speller_step(
    params: SpellerParams,
    cfg: SpellerConfig,
    carry: SpellerCarry,
    token_emb: torch.Tensor,  # [B, E] or [B, K, E]
    keys: torch.Tensor,  # [B, Tenc, A] precomputed attention keys
    memory: torch.Tensor,  # [B, Tenc, M] listener outputs
    enc_mask: torch.Tensor,  # [B, Tenc]
    forget_bias: float = 1.0,
    prec: str = "highest",
    *,
    generator: Optional[torch.Generator] = None,
    sigmoid_noise: float = 0.0,
    monotonic_mode: Optional[str] = None,  # None → cfg.monotonic_mode
):
    """One decode step → (carry', logits [B, V] ([B, K, V] on a beamed
    carry), extras dict with 'probs' and, in binf 'head' and 'logits'
    modes, 'binf_logits'). ``prec`` is the recurrent dot's precision, as
    in ``ops.lstm``; ``generator`` and ``sigmoid_noise`` feed the
    monotonic variants' training noise."""
    _check_binf(cfg)
    x = torch.cat([token_emb, carry.attn_vec], dim=-1)
    new_states = []
    for (h, c), cell in zip(carry.states, params.cells):
        gates = torch.matmul(x, cell.wx) + cell.b + rec_dot(h, cell.wh, prec)
        i, f, g, o = torch.chunk(gates, 4, dim=-1)
        c = torch.sigmoid(f + forget_bias) * c + torch.sigmoid(i) * torch.tanh(g)
        h = torch.sigmoid(o) * torch.tanh(c)
        new_states.append((h, c))
        x = h
    cell_out = x

    probs = attention_scores(
        params.attention, cfg.attention_type, cell_out, keys, enc_mask,
        prev_align=carry.alignment, sigmoid_noise=sigmoid_noise, generator=generator,
        monotonic_mode=monotonic_mode or cfg.monotonic_mode, monotonic_bias=cfg.monotonic_bias,
    )
    ctx = attention_context(probs, memory)
    combined = torch.cat([cell_out, ctx], dim=-1)
    attn_vec = (
        torch.matmul(combined, params.attention_layer)
        if params.attention_layer is not None else combined
    )
    raw = torch.matmul(attn_vec, params.out_w) + params.out_b
    extras = {"probs": probs}
    if cfg.binf_mode == "logits":
        # raw are binf-space logits; a phone's score is its code match
        extras["binf_logits"] = raw
        logits = torch.matmul(raw, params.binf_codes.t())
    else:
        logits = raw
        if cfg.binf_mode == "head":
            extras["binf_logits"] = torch.matmul(attn_vec, params.binf_w) + params.binf_b
    return SpellerCarry(tuple(new_states), attn_vec, probs), logits, extras


def teacher_forced_decode(
    params: SpellerParams,
    cfg: SpellerConfig,
    decoder_inputs: torch.Tensor,  # [B, S] token ids, column 0 = <sos>
    memory: torch.Tensor,  # [B, Tenc, M]
    enc_mask: torch.Tensor,  # [B, Tenc]
    *,
    generator: Optional[torch.Generator] = None,
    sampling_probability: Optional[Union[float, torch.Tensor]] = None,
    prec: str = "highest",
):
    """Teacher-forced (optionally scheduled-sampling) pass → (logits
    [B, S, V], attention probs [B, S, Tenc], binf logits [B, S, F] or None).

    With a ``generator`` and an effective sampling probability ``sp``
    (``sampling_probability`` when given, else the config's; the override
    counts even when the config's is 0), each step's input token is, per
    row, with probability ``sp``, the token *sampled* from the softmax of
    the previous step's logits (never at step 0, where nothing was
    sampled yet). With a ``generator``, the ``*_monotonic`` variants add
    ``cfg.monotonic_noise`` Gaussian noise to their pre-sigmoid scores, and
    teacher forcing always runs their parallel recursion. The bits come
    from ``generator``, which lies on ``memory``'s device; they cannot
    match JAX's.

    The reference rematerialises each step in its VJP (``jax.checkpoint``);
    here autograd keeps each step's activations (the [B, Tenc, A]
    attention tanh is the largest), trading memory for host time."""
    _check_binf(cfg)
    b, s = decoder_inputs.shape
    dev = memory.device
    keys = precompute_keys(params.attention, memory)
    carry = init_speller_carry(cfg, b, memory.shape[1], dev)
    sp = sampling_probability if sampling_probability is not None else cfg.sampling_probability
    use_ss = generator is not None and (
        sampling_probability is not None or cfg.sampling_probability > 0.0
    )
    monotonic = cfg.attention_type.endswith("_monotonic")
    noise = cfg.monotonic_noise if monotonic and generator is not None else 0.0
    prev_sampled = torch.full((b,), -1, dtype=torch.long, device=dev)
    logits_all, probs_all, binf_all = [], [], []
    for step in range(s):
        token = decoder_inputs[:, step].long()
        if use_ss:
            take = (torch.rand((b,), generator=generator, device=dev) < sp) & (prev_sampled >= 0)
            token = torch.where(take, prev_sampled.clamp_min(0), token)
        emb = embed_tokens(params, cfg, token)
        carry, logits, extras = speller_step(
            params, cfg, carry, emb, keys, memory, enc_mask, prec=prec,
            generator=generator, sigmoid_noise=noise, monotonic_mode="parallel",
        )
        if use_ss:
            with torch.no_grad():
                probs = torch.softmax(logits.float(), dim=-1)
                prev_sampled = torch.multinomial(probs, 1, generator=generator)[:, 0]
        logits_all.append(logits)
        probs_all.append(extras["probs"])
        if "binf_logits" in extras:
            binf_all.append(extras["binf_logits"])
    binf = torch.stack(binf_all, dim=1) if binf_all else None
    return torch.stack(logits_all, dim=1), torch.stack(probs_all, dim=1), binf
