"""Global cepstral mean/variance normalisation (port of
``phones_las_tpu/frontend/cmvn.py``): the running statistics of a corpus,
accumulated on the host in float64 and kept as JSON, and their
application on the device."""

from __future__ import annotations

import dataclasses
import json
from typing import Optional

import numpy as np
import torch


@dataclasses.dataclass
class CmvnStats:
    """Running global feature stats: count, Σx, Σx² per feature dim."""

    count: float
    sum: np.ndarray
    sumsq: np.ndarray

    @classmethod
    def zeros(cls, dim: int) -> "CmvnStats":
        return cls(0.0, np.zeros(dim, np.float64), np.zeros(dim, np.float64))

    def update(self, feats: np.ndarray, length: Optional[int] = None) -> None:
        """Accumulate [T, D] (optionally only the first ``length`` frames)."""
        f = np.asarray(feats, dtype=np.float64)
        if length is not None:
            f = f[:length]
        self.count += f.shape[0]
        self.sum += f.sum(axis=0)
        self.sumsq += (f * f).sum(axis=0)

    @property
    def mean(self) -> np.ndarray:
        return self.sum / max(self.count, 1.0)

    @property
    def std(self) -> np.ndarray:
        var = self.sumsq / max(self.count, 1.0) - self.mean**2
        return np.sqrt(np.maximum(var, 1e-10))

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump({"count": self.count, "sum": self.sum.tolist(), "sumsq": self.sumsq.tolist()}, f)

    @classmethod
    def load(cls, path: str) -> "CmvnStats":
        with open(path) as f:
            d = json.load(f)
        return cls(d["count"], np.asarray(d["sum"]), np.asarray(d["sumsq"]))


def apply_cmvn(feats: torch.Tensor, mean: torch.Tensor, std: torch.Tensor) -> torch.Tensor:
    """(x - μ)/σ over the last axis; mean/std are [D] tensors."""
    mean = mean.to(device=feats.device, dtype=feats.dtype)
    std = std.to(device=feats.device, dtype=feats.dtype)
    return (feats - mean) / std
