"""Full LAS model, inference side (port of ``phones_las_tpu/models/las.py``):
configs, the parameter container, ``featurize`` (front-end + CMVN) and
``encode`` (+ listener). Losses and training augmentation wait for the
training slice; their config fields are declared so every stored config
loads."""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
from torch import nn

from phones_las_torch.frontend.cmvn import apply_cmvn
from phones_las_torch.frontend.features import FrontendConfig, num_frames
from phones_las_torch.frontend.fused_frontend import extract_features_fused
from phones_las_torch.models.listener import ListenerConfig, ListenerParams, listen
from phones_las_torch.models.speller import SpellerConfig, SpellerParams
from phones_las_torch.ops.masking import length_mask


@dataclasses.dataclass(frozen=True)
class SpecAugmentConfig:
    """Same fields and defaults as the reference's (training only)."""

    freq_masks: int = 2
    freq_mask_width: int = 10
    time_masks: int = 2
    time_mask_width: int = 50
    time_mask_ratio: float = 0.2


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
):
    """Front-end + listener → (memory [B, T', M], enc_lengths, enc_mask)."""
    feats, flens = featurize(params, cfg, audio, audio_lengths)
    memory, enc_lens = listen(params.listener, cfg.listener, feats, flens, prec=prec)
    enc_mask = length_mask(enc_lens, memory.shape[1], memory.dtype)
    return memory, enc_lens, enc_mask
