"""Full LAS model (port of ``phones_las_tpu/models/las.py``): configs, the
parameter container and its initialisation, ``featurize`` (front-end +
CMVN), ``encode`` (+ listener, with dropout in training) and the losses:
masked sequence cross-entropy with label smoothing, the binf sigmoid
head, the CTC head and the multitask grapheme head, combined by
``compute_loss``. A training forward augments the features after CMVN:
the frequency warp, then SpecAugment."""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Tuple, Union

import torch
import torch.nn.functional as Fn
from torch import nn

from phones_las_torch.frontend.cmvn import apply_cmvn
from phones_las_torch.frontend.features import FrontendConfig, num_frames
from phones_las_torch.frontend.freq_warp import apply_freq_warp
from phones_las_torch.frontend.fused_frontend import extract_features_fused
from phones_las_torch.frontend.specaugment import SpecAugmentConfig, apply_specaugment
from phones_las_torch.models.listener import ListenerConfig, ListenerParams, init_listener, listen
from phones_las_torch.models.speller import (
    SpellerConfig,
    SpellerParams,
    init_speller,
    teacher_forced_decode,
)
from phones_las_torch.ops.lstm import glorot_
from phones_las_torch.ops.masking import length_mask


@dataclasses.dataclass(frozen=True)
class LASConfig:
    frontend: FrontendConfig = dataclasses.field(default_factory=FrontendConfig)
    listener: ListenerConfig = dataclasses.field(default_factory=ListenerConfig)
    speller: SpellerConfig = dataclasses.field(default_factory=SpellerConfig)
    grapheme_speller: Optional[SpellerConfig] = None
    multitask_weight: float = 0.5
    binf_weight: float = 1.0
    specaugment: Optional[SpecAugmentConfig] = None
    freq_warp: float = 0.0
    ctc_weight: float = 0.0
    label_smoothing: float = 0.0
    input_is_pcm: bool = True
    cmvn: bool = True
    # 'highest' is the parity mode: utils.device.set_parity_mode()
    matmul_precision: str = "highest"


class LASParams(nn.Module):
    """Listener, speller(s), CMVN stats and the optional CTC head."""

    def __init__(self, cfg: LASConfig, device=None):
        super().__init__()
        self.listener = ListenerParams(cfg.listener, device)
        self.speller = SpellerParams(cfg.speller, device)
        self.grapheme_speller = (
            SpellerParams(cfg.grapheme_speller, device) if cfg.grapheme_speller is not None else None
        )
        d = cfg.listener.input_dim
        self.register_buffer("cmvn_mean", torch.zeros(d, device=device))
        self.register_buffer("cmvn_std", torch.ones(d, device=device))
        ctc = cfg.ctc_weight > 0.0
        m, v = cfg.listener.output_dim, cfg.speller.vocab_size
        z = lambda *shape: nn.Parameter(torch.zeros(shape, device=device), requires_grad=False)
        self.register_parameter("ctc_w", z(m, v) if ctc else None)
        self.register_parameter("ctc_b", z(v) if ctc else None)


def init_las(cfg: LASConfig, seed: int = 0, binf_codes=None, device=None) -> LASParams:
    """Random model from ``seed`` with the reference's initialisers
    (``init_listener``, ``init_speller``, glorot CTC head, zero-mean /
    unit-std CMVN). The numbers differ from JAX's for the same seed."""
    g = torch.Generator().manual_seed(seed)
    p = LASParams(cfg, device)
    p.listener = init_listener(cfg.listener, g, device)
    p.speller = init_speller(cfg.speller, g, binf_codes, device)
    if cfg.grapheme_speller is not None:
        p.grapheme_speller = init_speller(cfg.grapheme_speller, g, device=device)
    if p.ctc_w is not None:
        glorot_(p.ctc_w, g)
    return p


def trainable_filter(params: LASParams) -> Dict[str, bool]:
    """{leaf path: trainable} over ``utils.param_io.named_leaves``: every
    weight is trainable; CMVN stats and the static binf codes are data."""
    from phones_las_torch.utils.param_io import named_leaves

    return {
        key: not (key in (".cmvn_mean", ".cmvn_std") or key.endswith(".binf_codes"))
        for key, _ in named_leaves(params)
    }


def featurize(
    params: LASParams,
    cfg: LASConfig,
    audio: torch.Tensor,  # [B, S] PCM float (or [B, T, D] features)
    audio_lengths: torch.Tensor,  # samples (or frames)
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Front-end + CMVN → (features, frame lengths). PCM goes through the
    fused front-end (the CUDA kernel on a CUDA tensor)."""
    if cfg.input_is_pcm:
        feats = extract_features_fused(audio, cfg.frontend, sample_lengths=audio_lengths)
        flens = num_frames(audio_lengths, cfg.frontend)
    else:
        feats, flens = audio, audio_lengths
    if cfg.cmvn:
        feats = apply_cmvn(feats, params.cmvn_mean, params.cmvn_std)
    return feats, flens


def encode(
    params: LASParams,
    cfg: LASConfig,
    audio: torch.Tensor,
    audio_lengths: torch.Tensor,
    *,
    prec: str = "highest",
    train: bool = False,
    generator: Optional[torch.Generator] = None,
):
    """Front-end + listener → (memory [B, T', M], enc_lengths, enc_mask).

    With ``train`` and a ``generator``, the features after CMVN go through
    the frequency warp (``cfg.freq_warp`` > 0, log-mel only), then
    SpecAugment (``cfg.specaugment``), then the listener with dropout.
    The draws on the one generator come in that order: α, then the
    frequency widths and starts, then the time widths and starts, then the
    dropout masks (and, in ``compute_loss``, scheduled sampling)."""
    feats, flens = featurize(params, cfg, audio, audio_lengths)
    if train and generator is not None:
        blocks = 3 if cfg.frontend.add_deltas else 1
        if cfg.freq_warp:
            if cfg.frontend.feature_type != "logmel":
                raise ValueError(
                    "freq_warp warps the log-mel channel axis; it is not a "
                    f"spectral warp for feature_type={cfg.frontend.feature_type!r}"
                )
            feats = apply_freq_warp(feats, cfg.freq_warp, feats.shape[-1] // blocks, generator=generator)
        if cfg.specaugment is not None:
            feats = apply_specaugment(
                feats, flens, cfg.specaugment, feats.shape[-1] // blocks, generator=generator
            )
    memory, enc_lens = listen(
        params.listener, cfg.listener, feats, flens, prec=prec, train=train, generator=generator
    )
    enc_mask = length_mask(enc_lens, memory.shape[1], memory.dtype)
    return memory, enc_lens, enc_mask


def _denominator(count: torch.Tensor, global_count) -> torch.Tensor:
    """A mean's denominator, at least 1: this batch's count, or under a
    data-parallel mesh the count over the global batch, so that each rank
    divides its sum by the same number and the gradients add up."""
    if global_count is not None:
        count = global_count(count.detach())
    return torch.clamp_min(count, 1.0)


def masked_ce_loss(
    logits: torch.Tensor,  # [B, S, V]
    targets: torch.Tensor,  # [B, S]
    target_mask: torch.Tensor,  # [B, S]
    label_smoothing: float = 0.0,
    global_count: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
) -> torch.Tensor:
    """``tf.contrib.seq2seq.sequence_loss`` semantics: mean CE over valid
    target positions; ``label_smoothing`` ε mixes the one-hot target with
    the uniform distribution. ``global_count`` (``compute_loss``) turns
    this batch's count of valid positions into the global batch's."""
    logp = torch.log_softmax(logits, dim=-1)
    nll = -torch.gather(logp, -1, targets.long()[..., None])[..., 0]
    if label_smoothing > 0.0:
        nll = (1.0 - label_smoothing) * nll + label_smoothing * (-torch.mean(logp, dim=-1))
    return torch.sum(nll * target_mask) / _denominator(torch.sum(target_mask), global_count)


def binf_sigmoid_loss(
    binf_logits: torch.Tensor,  # [B, S, F]
    targets: torch.Tensor,  # [B, S] phone ids
    codes: torch.Tensor,  # [V, F] static phone→binf map
    target_mask: torch.Tensor,  # [B, S]
    global_count: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
) -> torch.Tensor:
    """Sigmoid CE of the binf head against each target phone's code."""
    y = codes[targets.long()]
    z = binf_logits
    per = torch.clamp_min(z, 0) - z * y + torch.log1p(torch.exp(-torch.abs(z)))
    per = torch.mean(per, dim=-1)
    return torch.sum(per * target_mask) / _denominator(torch.sum(target_mask), global_count)


def ctc_head_loss(
    params: LASParams,
    cfg: LASConfig,
    memory: torch.Tensor,  # [B, T', M]
    enc_mask: torch.Tensor,  # [B, T']
    targets: torch.Tensor,  # [B, S] phone ids ending in <eos>
    target_lengths: torch.Tensor,  # [B] counting the <eos>
    global_count: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
) -> torch.Tensor:
    """CTC loss of the encoder head against the targets without their
    <eos>. Blank = <pad> (id 0). Per-sequence losses are normalised by
    label length; rows whose transcript is empty (only <eos>) are weighted
    out. ``torch.nn.functional.ctc_loss`` replaces ``optax.ctc_loss``; a
    row with no valid alignment (infinite loss) counts 0, where optax's
    log-epsilon floor gives a large finite value."""
    logits = torch.matmul(memory, params.ctc_w) + params.ctc_b  # [B, T', V]
    valid = (target_lengths > 1).to(torch.float32)
    label_lens = torch.clamp_min(target_lengths.long() - 1, 1)
    in_lens = enc_mask.sum(dim=1).long()
    logp = torch.log_softmax(logits.float(), dim=-1).transpose(0, 1)  # [T', B, V]
    per_seq = Fn.ctc_loss(
        logp, targets.long(), in_lens, label_lens, blank=0, reduction="none", zero_infinity=True
    )
    per_seq = per_seq * valid / label_lens.to(torch.float32)
    return torch.sum(per_seq) / _denominator(torch.sum(valid), global_count)


def ctc_logp(params: LASParams, memory: torch.Tensor) -> torch.Tensor:
    """Log-softmax of the encoder CTC head, [B, T', V]: what one-pass
    joint CTC/attention beam decoding scores prefixes with."""
    return torch.log_softmax(torch.matmul(memory, params.ctc_w) + params.ctc_b, dim=-1)


def _shift_right(targets: torch.Tensor, bos_id: int) -> torch.Tensor:
    return torch.cat([torch.full_like(targets[:, :1], bos_id), targets[:, :-1]], dim=1)


def compute_loss(
    params: LASParams,
    cfg: LASConfig,
    batch: dict,
    *,
    train: bool = False,
    generator: Optional[torch.Generator] = None,
    encoded: Optional[Tuple] = None,
    sampling_probability: Optional[Union[float, torch.Tensor]] = None,
    prec: str = "highest",
    global_count: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
):
    """Full forward + losses → (loss, aux) as the reference's.

    ``batch`` keys: 'audio' [B, S] + 'audio_lengths' [B] (or features if
    ``input_is_pcm=False``); 'targets' [B, St] phone ids ending in <eos>;
    'target_lengths' [B] counting the <eos>; optionally
    'grapheme_targets'/'grapheme_lengths'. ``train`` turns on dropout,
    scheduled sampling and label smoothing, with every random draw taken
    from ``generator`` in that order. Pass ``encoded=(memory, enc_lens,
    enc_mask)`` to reuse an encoder pass.

    The reference's means run over the global batch (CE and binf over its
    valid target positions, CTC over its rows with a transcript). Under a
    data-parallel mesh each rank holds some rows: ``global_count`` maps a
    count over this rank's rows to the count over all of them (a sum over
    the data ranks), so the returned loss is this rank's share and the
    shares and their gradients sum to the global batch's. A mean of
    per-rank means would weigh rows wrongly whenever the ranks hold
    different counts."""
    gen = generator if train else None
    if encoded is not None:
        memory, enc_lens, enc_mask = encoded
    else:
        memory, enc_lens, enc_mask = encode(
            params, cfg, batch["audio"], batch["audio_lengths"], prec=prec, train=train, generator=gen
        )
    targets = batch["targets"].long()
    t_mask = length_mask(batch["target_lengths"], targets.shape[1], memory.dtype)
    smoothing = cfg.label_smoothing if train else 0.0
    logits, attn_probs, binf_logits = teacher_forced_decode(
        params.speller, cfg.speller, _shift_right(targets, cfg.speller.bos_id), memory, enc_mask,
        generator=gen, sampling_probability=sampling_probability, prec=prec,
    )
    phone_loss = masked_ce_loss(logits, targets, t_mask, label_smoothing=smoothing, global_count=global_count)
    aux = {"phone_loss": phone_loss, "logits": logits, "attention": attn_probs, "enc_lengths": enc_lens}
    loss = phone_loss

    if cfg.ctc_weight > 0.0:
        cl = ctc_head_loss(params, cfg, memory, enc_mask, targets, batch["target_lengths"], global_count)
        aux["ctc_loss"] = cl
        loss = (1.0 - cfg.ctc_weight) * loss + cfg.ctc_weight * cl

    if cfg.speller.binf_mode == "head" and binf_logits is not None:
        bl = binf_sigmoid_loss(binf_logits, targets, params.speller.binf_codes, t_mask, global_count)
        aux["binf_loss"] = bl
        loss = loss + cfg.binf_weight * bl

    if params.grapheme_speller is not None:
        g_targets = batch["grapheme_targets"].long()
        g_mask = length_mask(batch["grapheme_lengths"], g_targets.shape[1], memory.dtype)
        g_logits, _, _ = teacher_forced_decode(
            params.grapheme_speller, cfg.grapheme_speller,
            _shift_right(g_targets, cfg.grapheme_speller.bos_id), memory, enc_mask,
            generator=gen, sampling_probability=sampling_probability, prec=prec,
        )
        g_loss = masked_ce_loss(g_logits, g_targets, g_mask, label_smoothing=smoothing, global_count=global_count)
        aux["grapheme_loss"] = g_loss
        w = cfg.multitask_weight
        loss = w * loss + (1.0 - w) * g_loss

    aux["loss"] = loss
    return loss, aux
