"""VTLP-style frequency-axis warping (port of
``phones_las_tpu/frontend/freq_warp.py``).

Each utterance's log-mel channels are resampled along the frequency axis
by a per-utterance warp factor α ~ U[1 − W, 1 + W]: a piecewise-linear
gather along the last axis, the same channel map for every Δ block. As in
the reference, it runs after CMVN and nothing checks ``max_warp`` (a W of
1 or more gives α ≤ 0). The draw of α is split from the warp: the
function takes a ``torch.Generator`` or α itself.
"""

from __future__ import annotations

from typing import Optional

import torch

# knee of the piecewise-linear map, as a fraction of the top channel
_KNEE = 0.85


def warp_positions(alpha: torch.Tensor, num_bins: int) -> torch.Tensor:
    """Source positions [B, num_bins] for per-row warp factors α [B]:
    p(0) = 0 and p(num_bins − 1) = num_bins − 1 (band edges fixed), and
    p(j) = j/α below the knee. α = 1 is the identity exactly."""
    alpha = torch.as_tensor(alpha, dtype=torch.float32)[:, None]  # [B, 1]
    top = float(num_bins - 1)
    j = torch.arange(num_bins, dtype=torch.float32, device=alpha.device)[None, :]  # [1, F]
    # knee in output space
    g = _KNEE * top * torch.clamp_max(alpha, 1.0)
    p_lo = j / alpha
    # upper segment: the line from (g, g/α) to (top, top)
    rest = torch.clamp_min(top - g, 1e-6)
    p_hi = g / alpha + (j - g) * (top - g / alpha) / rest
    return torch.where(j <= g, p_lo, p_hi)


def draw_alpha(batch: int, max_warp: float, generator: torch.Generator) -> torch.Tensor:
    """α [B] ~ U[1 − max_warp, 1 + max_warp), one draw from ``generator``."""
    u = torch.rand((batch,), generator=generator, device=generator.device)
    return u * (2.0 * max_warp) + (1.0 - max_warp)


def apply_freq_warp(
    feats: torch.Tensor,  # [B, T, D], D = n_blocks × bins (fbank ‖ Δ ‖ ΔΔ)
    max_warp: float,
    bins_per_block: int,
    *,
    generator: Optional[torch.Generator] = None,
    alpha: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Resample every Δ block's channel axis by a shared per-row warp;
    α is given, or drawn from ``generator``."""
    b, t, d = feats.shape
    if d % bins_per_block:
        raise ValueError(f"feature dim {d} is not a multiple of {bins_per_block} bins")
    n_blocks = d // bins_per_block
    if alpha is None:
        if generator is None:
            raise ValueError("apply_freq_warp needs a generator or alpha")
        alpha = draw_alpha(b, max_warp, generator)
    pos = warp_positions(alpha.to(feats.device), bins_per_block)  # [B, bins]
    lo = torch.clamp(torch.floor(pos), 0.0, bins_per_block - 1.0)
    w = (pos - lo)[:, None, None, :]  # [B, 1, 1, bins]
    lo = lo.long()
    hi = torch.clamp_max(lo + 1, bins_per_block - 1)
    x = feats.reshape(b, t, n_blocks, bins_per_block).float()
    take = lambda idx: torch.gather(x, -1, idx[:, None, None, :].expand(b, t, n_blocks, bins_per_block))
    out = take(lo) * (1.0 - w) + take(hi) * w
    return out.reshape(b, t, d).to(feats.dtype)
