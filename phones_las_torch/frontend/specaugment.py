"""SpecAugment (port of ``phones_las_tpu/frontend/specaugment.py``).

Frequency masks are drawn over the bins of one feature block and hit the
same bins in every Δ block; time masks are drawn within each utterance's
valid frames, each at most ``time_mask_ratio`` of it wide; masked cells
are set to 0 (the feature mean after CMVN).

Each draw is split from the mask arithmetic: the functions take either
a ``torch.Generator`` or the uniforms themselves, so a caller can feed
the port the very uniforms another implementation drew (JAX's random
streams cannot be reproduced in torch). With a generator the draws come
in this order: frequency widths, frequency starts, time widths, time
starts.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

# (u_w, u_s): the width and start uniforms of one mask family, each [B, M]
Uniforms = Tuple[torch.Tensor, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class SpecAugmentConfig:
    """Same fields and defaults as the reference's (training only)."""

    freq_masks: int = 2
    freq_mask_width: int = 10  # max bins per mask (of the 40 mel bins)
    time_masks: int = 2
    time_mask_width: int = 50  # max frames per mask
    time_mask_ratio: float = 0.2  # per-mask width also capped at ratio·frames


def draw_uniforms(batch: int, n_masks: int, generator: torch.Generator) -> Uniforms:
    """The two [B, M] uniform draws of one mask family: widths, then starts."""
    dev = generator.device
    u_w = torch.rand((batch, n_masks), generator=generator, device=dev)
    u_s = torch.rand((batch, n_masks), generator=generator, device=dev)
    return u_w, u_s


def _interval_masks(
    uniforms: Uniforms,
    widths_max,  # scalar or [B]
    span,  # scalar or [B]
    total: int,
) -> torch.Tensor:
    """→ keep mask [B, total]: AND of M zero intervals, one per column of
    the uniforms. Each interval has width w = ⌊u_w·(widths_max + 1)⌋
    (at most ``span``) and start ⌊u_s·(span − w + 1)⌋; cells at index ≥
    span are never masked."""
    u_w, u_s = uniforms
    b, m = u_w.shape
    dev = u_w.device
    as_col = lambda v: torch.as_tensor(v, dtype=torch.float32, device=dev).reshape(-1, 1).expand(b, m)
    widths_max, span = as_col(widths_max), as_col(span)
    w = torch.floor(u_w * (widths_max + 1.0))  # [B, M] in {0..widths_max}
    w = torch.minimum(w, span)  # a misconfigured width can't exceed the span
    start = torch.floor(u_s * (span - w + 1.0))  # uniform over {0..span-w}
    idx = torch.arange(total, dtype=torch.float32, device=dev)
    inside = (idx >= start[..., None]) & (idx < (start + w)[..., None])  # [B, M, total]
    return ~inside.any(dim=1)


def apply_specaugment(
    feats: torch.Tensor,  # [B, T, D], D = n_blocks × bins (fbank ‖ Δ ‖ ΔΔ)
    frame_lengths: torch.Tensor,  # [B] valid frames
    cfg: SpecAugmentConfig,
    bins_per_block: int,
    *,
    generator: Optional[torch.Generator] = None,
    freq_uniforms: Optional[Uniforms] = None,
    time_uniforms: Optional[Uniforms] = None,
) -> torch.Tensor:
    """Frequency and time masking, zero-filled. Each mask family takes its
    uniforms when given, else draws them from ``generator``."""
    b, t, d = feats.shape
    if d % bins_per_block:
        raise ValueError(f"feature dim {d} is not a multiple of {bins_per_block} bins")
    n_blocks = d // bins_per_block

    def uniforms(given, n_masks):
        if given is not None:
            return given
        if generator is None:
            raise ValueError("apply_specaugment needs a generator or the uniforms")
        return draw_uniforms(b, n_masks, generator)

    keep = torch.ones((b, t, n_blocks, bins_per_block), dtype=torch.bool, device=feats.device)
    if cfg.freq_masks > 0 and cfg.freq_mask_width > 0:
        keep_bins = _interval_masks(
            uniforms(freq_uniforms, cfg.freq_masks), float(cfg.freq_mask_width),
            float(bins_per_block), bins_per_block,
        )  # [B, bins]
        keep = keep & keep_bins[:, None, None, :]
    if cfg.time_masks > 0 and cfg.time_mask_width > 0:
        n = frame_lengths.to(torch.float32)
        w_max = torch.clamp_max(torch.floor(cfg.time_mask_ratio * n), float(cfg.time_mask_width))
        keep_frames = _interval_masks(uniforms(time_uniforms, cfg.time_masks), w_max, n, t)  # [B, T]
        keep = keep & keep_frames[:, :, None, None]
    return (feats.reshape(b, t, n_blocks, bins_per_block) * keep).reshape(b, t, d).to(feats.dtype)
