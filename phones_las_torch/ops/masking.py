"""Length-mask helpers shared across the stack (port of
``phones_las_tpu/ops/masking.py``)."""

from __future__ import annotations

import torch


def length_mask(lengths: torch.Tensor, max_len: int, dtype=torch.float32) -> torch.Tensor:
    """[B] lengths → [B, max_len] mask (1 for valid positions)."""
    pos = torch.arange(max_len, device=lengths.device)
    return (pos[None, :] < lengths[:, None]).to(dtype)
