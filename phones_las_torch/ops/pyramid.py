"""Pyramid time reduction, the "p" in pBLSTM (port of
``phones_las_tpu/ops/pyramid.py``): adjacent frame pairs are
concatenated, an odd T is zero-padded first, and lengths become
``ceil(len / 2)`` so no real frame is dropped."""

from __future__ import annotations

from typing import Tuple

import torch


def pyramid_reduce(x: torch.Tensor, lengths: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """[B, T, U] → [B, ceil(T/2), 2U]; lengths → ceil(lengths/2)."""
    b, t, u = x.shape
    if t % 2:
        x = torch.nn.functional.pad(x, (0, 0, 0, 1))
        t += 1
    return x.reshape(b, t // 2, 2 * u), torch.div(lengths + 1, 2, rounding_mode="floor")
