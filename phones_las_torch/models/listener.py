"""Listener: pyramidal BiLSTM encoder (port of
``phones_las_tpu/models/listener.py``), with dropout on each layer's
output in training.

From the second layer on, the time axis is halved before the layer by
concatenating adjacent frame pairs, so the encoder emits
``ceil(T / 2^(L-1))`` frames of ``2·units`` features. Each layer is one
input projection per direction plus the fused bidirectional recurrence.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
from torch import nn

from phones_las_torch.ops.lstm import LSTMParams, bilstm_layer, glorot_lstm_
from phones_las_torch.ops.pyramid import pyramid_reduce


@dataclasses.dataclass(frozen=True)
class ListenerConfig:
    input_dim: int = 120  # 40 log-mel × (1 + Δ + ΔΔ)
    num_layers: int = 2
    units: int = 256
    dropout: float = 0.0

    @property
    def output_dim(self) -> int:
        return 2 * self.units

    def time_reduction(self) -> int:
        """Overall T divisor: 2^(num_layers - 1)."""
        return 2 ** (self.num_layers - 1)


class ListenerParams(nn.Module):
    """``layers[l] = (forward LSTMParams, backward LSTMParams)``."""

    def __init__(self, cfg: ListenerConfig, device=None):
        super().__init__()
        layers = []
        in_dim = cfg.input_dim
        for _ in range(cfg.num_layers):
            layers.append(nn.ModuleList([
                LSTMParams(in_dim, cfg.units, device), LSTMParams(in_dim, cfg.units, device)
            ]))
            in_dim = 4 * cfg.units  # pyramid concat of this layer's bi-output
        self.layers = nn.ModuleList(layers)


def init_listener(cfg: ListenerConfig, generator: torch.Generator, device=None) -> ListenerParams:
    """Each direction of each layer by the TF fan-in rule
    (``glorot_lstm_``), layer by layer, forward then backward."""
    p = ListenerParams(cfg, device)
    for pair in p.layers:
        for lp in pair:
            glorot_lstm_(lp, generator)
    return p


def dropout(x: torch.Tensor, rate: float, generator: torch.Generator) -> torch.Tensor:
    """Keep each element with probability 1 − rate and scale it by
    1 / (1 − rate), as the reference's ``where(bernoulli(keep), x / keep, 0)``;
    the keep mask comes from ``generator`` (on ``x``'s device)."""
    keep = 1.0 - rate
    mask = torch.rand(x.shape, generator=generator, device=x.device) < keep
    return torch.where(mask, x / keep, torch.zeros_like(x))


def listen(
    params: ListenerParams,
    cfg: ListenerConfig,
    feats: torch.Tensor,  # [B, T, D]
    lengths: torch.Tensor,  # [B]
    *,
    prec: str = "highest",
    train: bool = False,
    generator: Optional[torch.Generator] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """→ (encoder outputs [B, ceil(T/2^(L-1)), 2U], reduced lengths). With
    ``train`` and ``cfg.dropout > 0``, each layer's output goes through
    ``dropout`` with masks from ``generator``."""
    x, lens = feats, lengths
    for l, (pf, pb) in enumerate(params.layers):
        if l > 0:
            x, lens = pyramid_reduce(x, lens)
        x, _ = bilstm_layer(pf, pb, x, lens, prec=prec)
        if train and cfg.dropout > 0.0:
            if generator is None:
                raise ValueError("train=True with dropout needs a generator")
            x = dropout(x, cfg.dropout, generator)
    return x, lens
