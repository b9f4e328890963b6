"""Global cepstral mean/variance normalisation (port of
``phones_las_tpu/frontend/cmvn.py::apply_cmvn``)."""

from __future__ import annotations

import torch


def apply_cmvn(feats: torch.Tensor, mean: torch.Tensor, std: torch.Tensor) -> torch.Tensor:
    """(x - μ)/σ over the last axis; mean/std are [D] tensors."""
    mean = mean.to(device=feats.device, dtype=feats.dtype)
    std = std.to(device=feats.device, dtype=feats.dtype)
    return (feats - mean) / std
