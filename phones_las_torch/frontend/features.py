"""Audio feature front-end with python_speech_features semantics.

Port of ``phones_las_tpu/frontend/features.py``: 16 kHz input, 25 ms
window / 10 ms hop, pre-emphasis 0.97, NFFT 512, HTK mel scale on integer
FFT-bin edges, log floor at float64 eps, MFCC (ortho DCT-II, lifter,
energy c0), and edge-padded Δ/ΔΔ. The constant matrices come from numpy
functions copied from the reference so both packages use the same
numbers; everything else is plain PyTorch on the caller's device.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Optional, Tuple, Union

import numpy as np
import torch

_LOG_FLOOR = float(np.finfo(np.float64).eps)  # psf replaces 0 with float64 eps


@dataclasses.dataclass(frozen=True)
class FrontendConfig:
    """Static configuration of the feature front-end (same fields and
    defaults as the reference). ``precision`` is kept so every stored
    config loads; the port computes the front-end in float32 for both
    'highest' and 'high' (the 'high' bf16 split is a TPU-MXU device)."""

    sample_rate: int = 16000
    win_ms: float = 25.0
    hop_ms: float = 10.0
    preemphasis: float = 0.97
    nfft: int = 512
    feature_type: str = "logmel"  # 'logmel' | 'mfcc'
    num_mel: int = 40
    low_hz: float = 0.0
    high_hz: Optional[float] = None  # defaults to sample_rate / 2
    num_ceps: int = 13
    lifter: int = 22
    append_energy: bool = True
    window: str = "rect"  # psf default winfunc is all-ones
    add_deltas: bool = True
    delta_width: int = 2
    precision: str = "highest"

    @property
    def win_samples(self) -> int:
        return int(math.floor(self.win_ms * self.sample_rate / 1000.0 + 0.5))

    @property
    def hop_samples(self) -> int:
        return int(math.floor(self.hop_ms * self.sample_rate / 1000.0 + 0.5))

    @property
    def num_bins(self) -> int:
        return self.nfft // 2 + 1

    @property
    def base_dim(self) -> int:
        return self.num_ceps if self.feature_type == "mfcc" else self.num_mel


def feature_dim(cfg: FrontendConfig) -> int:
    """Final per-frame feature dimension (with delta stacking)."""
    return cfg.base_dim * (3 if cfg.add_deltas else 1)


def num_frames(n_samples: Union[int, torch.Tensor], cfg: FrontendConfig):
    """psf framing count: 1 + ceil((n - win)/hop) for n > win, else 1.
    Works on Python ints and on integer tensors of lengths."""
    win, hop = cfg.win_samples, cfg.hop_samples
    if isinstance(n_samples, (int, np.integer)):
        if n_samples <= win:
            return 1
        return 1 + int(math.ceil((n_samples - win) / hop))
    extra = torch.clamp(n_samples - win, min=0)
    return 1 + torch.div(extra + hop - 1, hop, rounding_mode="floor")


def frames_for_samples(n_samples: int, cfg: FrontendConfig) -> int:
    """Static frame count for a padded signal buffer of ``n_samples``."""
    return num_frames(int(n_samples), cfg)


def _window_vector(cfg: FrontendConfig) -> np.ndarray:
    n = cfg.win_samples
    if cfg.window == "rect":
        return np.ones(n, dtype=np.float64)
    if cfg.window == "hamming":
        return np.hamming(n)
    if cfg.window == "hann":
        return np.hanning(n)
    if cfg.window == "povey":
        return (0.5 - 0.5 * np.cos(2 * np.pi * np.arange(n) / (n - 1))) ** 0.85
    raise ValueError(f"unknown window {cfg.window!r}")


@functools.lru_cache(maxsize=None)
def _mel_filterbank_np(
    nfft: int, num_mel: int, sample_rate: int, low_hz: float, high_hz: float
) -> np.ndarray:
    """psf-exact mel filterbank, shape [num_bins, num_mel], on integer
    FFT-bin edges ``floor((NFFT+1) * mel2hz(melpoints) / rate)``."""

    def hz2mel(hz):
        return 2595.0 * np.log10(1.0 + np.asarray(hz, dtype=np.float64) / 700.0)

    def mel2hz(mel):
        return 700.0 * (10.0 ** (np.asarray(mel, dtype=np.float64) / 2595.0) - 1.0)

    low_mel, high_mel = hz2mel(low_hz), hz2mel(high_hz)
    melpoints = np.linspace(low_mel, high_mel, num_mel + 2)
    bins = np.floor((nfft + 1) * mel2hz(melpoints) / sample_rate).astype(np.int64)

    fbank = np.zeros((num_mel, nfft // 2 + 1), dtype=np.float64)
    for j in range(num_mel):
        for i in range(int(bins[j]), int(bins[j + 1])):
            fbank[j, i] = (i - bins[j]) / max(bins[j + 1] - bins[j], 1)
        for i in range(int(bins[j + 1]), int(bins[j + 2])):
            fbank[j, i] = (bins[j + 2] - i) / max(bins[j + 2] - bins[j + 1], 1)
    return fbank.T.copy()  # [num_bins, num_mel]


def mel_filterbank(cfg: FrontendConfig) -> np.ndarray:
    high = cfg.high_hz if cfg.high_hz is not None else cfg.sample_rate / 2.0
    return _mel_filterbank_np(cfg.nfft, cfg.num_mel, cfg.sample_rate, cfg.low_hz, float(high))


@functools.lru_cache(maxsize=None)
def _dft_matrices_np(win: int, nfft: int) -> Tuple[np.ndarray, np.ndarray]:
    k = np.arange(nfft // 2 + 1, dtype=np.float64)
    i = np.arange(win, dtype=np.float64)
    ang = 2.0 * np.pi * np.outer(i, k) / nfft  # [win, bins]
    return np.cos(ang), -np.sin(ang)


def dft_matrices(cfg: FrontendConfig) -> Tuple[np.ndarray, np.ndarray]:
    """Real/imag DFT bases with the window folded in, each [win, num_bins]."""
    cos_m, sin_m = _dft_matrices_np(cfg.win_samples, cfg.nfft)
    w = _window_vector(cfg)[:, None]
    return (cos_m * w), (sin_m * w)


@functools.lru_cache(maxsize=8)
def dft_basis(cfg: FrontendConfig, device: torch.device) -> torch.Tensor:
    """[win, 2·num_bins] float32: cos | sin bases, window folded in
    (cached per config and device; callers must not write to it)."""
    cos_m, sin_m = dft_matrices(cfg)
    return torch.as_tensor(
        np.concatenate([cos_m, sin_m], axis=1), dtype=torch.float32, device=device
    )


@functools.lru_cache(maxsize=8)
def mel_matrix(cfg: FrontendConfig, device: torch.device) -> torch.Tensor:
    """[num_bins, num_mel] float32 mel filterbank (cached like ``dft_basis``)."""
    return torch.as_tensor(mel_filterbank(cfg), dtype=torch.float32, device=device)


@functools.lru_cache(maxsize=None)
def _dct_lifter_np(num_mel: int, num_ceps: int, lifter: int) -> Tuple[np.ndarray, np.ndarray]:
    """Ortho DCT-II matrix [num_mel, num_ceps] and lifter vector [num_ceps]."""
    n = np.arange(num_mel, dtype=np.float64)
    k = np.arange(num_ceps, dtype=np.float64)
    dct = np.cos(np.pi * np.outer(n + 0.5, k) / num_mel)  # [num_mel, num_ceps]
    dct *= np.sqrt(2.0 / num_mel)
    dct[:, 0] *= 1.0 / np.sqrt(2.0)
    if lifter > 0:
        lift = 1.0 + (lifter / 2.0) * np.sin(np.pi * k / lifter)
    else:
        lift = np.ones_like(k)
    return dct, lift


def preemphasize(x: torch.Tensor, coef: float) -> torch.Tensor:
    """psf sigproc.preemphasis over the last axis: y[0]=x[0]."""
    if coef == 0.0:
        return x
    return torch.cat([x[..., :1], x[..., 1:] - coef * x[..., :-1]], dim=-1)


def mask_past_length(x: torch.Tensor, sample_lengths: torch.Tensor) -> torch.Tensor:
    """Zero [..., S] past each row's true length (pre-emphasis leaks
    ``-coef·x[len-1]`` into the first padding sample)."""
    pos = torch.arange(x.shape[-1], device=x.device)
    return torch.where(pos < sample_lengths[..., None], x, torch.zeros((), dtype=x.dtype, device=x.device))


def frame_signal(x: torch.Tensor, cfg: FrontendConfig, n_frames: int) -> torch.Tensor:
    """Frame [..., S] → [..., n_frames, win] with zero pad past the buffer."""
    win, hop = cfg.win_samples, cfg.hop_samples
    needed = (n_frames - 1) * hop + win
    if needed > x.shape[-1]:
        x = torch.nn.functional.pad(x, (0, needed - x.shape[-1]))
    return x[..., :needed].unfold(-1, win, hop)


def power_spectrum(frames: torch.Tensor, cfg: FrontendConfig) -> torch.Tensor:
    """[..., T, win] → [..., T, num_bins]: (re² + im²) / NFFT."""
    proj = torch.matmul(frames, dft_basis(cfg, frames.device))
    re, im = torch.split(proj, cfg.num_bins, dim=-1)
    return (re * re + im * im) / cfg.nfft


def log_mel(pspec: torch.Tensor, cfg: FrontendConfig) -> torch.Tensor:
    """[..., T, num_bins] power → log(max(power @ mel, eps64))."""
    mel = torch.matmul(pspec, mel_matrix(cfg, pspec.device))
    return torch.log(torch.clamp_min(mel, _LOG_FLOOR))


def _deltas(feat: torch.Tensor, n: int) -> torch.Tensor:
    """psf delta: edge-padded, denominator 2*Σd²; over axis -2 (time)."""
    denom = 2.0 * sum(d * d for d in range(1, n + 1))
    t = feat.shape[-2]
    idx = torch.clamp(torch.arange(-n, t + n, device=feat.device), 0, t - 1)
    padded = feat[..., idx, :]
    out = torch.zeros_like(feat)
    for d in range(1, n + 1):
        fwd = padded[..., n + d : n + d + t, :]
        bwd = padded[..., n - d : n - d + t, :]
        out = out + d * (fwd - bwd)
    return out / denom


def _clamp_to_length(feat: torch.Tensor, frame_lengths: torch.Tensor) -> torch.Tensor:
    """Replace frames past each utterance's true length with its last true
    frame, so edge-padded deltas match per-utterance extraction."""
    t = feat.shape[-2]
    pos = torch.arange(t, device=feat.device)
    last = torch.clamp(frame_lengths - 1, min=0)[..., None]  # [..., 1]
    idx = torch.minimum(pos, last)  # [..., T]
    idx = idx[..., None].expand(*idx.shape, feat.shape[-1])
    return torch.gather(feat, -2, idx)


def postprocess(
    logmel: torch.Tensor,  # [..., T, num_mel]
    energy: Optional[torch.Tensor],  # [..., T] raw power sum (MFCC c0 only)
    cfg: FrontendConfig,
    frame_lengths: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Shared post-spectrum tail: MFCC DCT/lifter/energy-c0,
    per-utterance tail clamping, Δ/ΔΔ stacking."""
    if cfg.feature_type == "logmel":
        base = logmel
    elif cfg.feature_type == "mfcc":
        dct, lift = _dct_lifter_np(cfg.num_mel, cfg.num_ceps, cfg.lifter)
        dev = logmel.device
        ceps = torch.matmul(logmel, torch.as_tensor(dct, dtype=torch.float32, device=dev))
        ceps = ceps * torch.as_tensor(lift, dtype=torch.float32, device=dev)
        if cfg.append_energy:
            if energy is None:
                raise ValueError("MFCC c0 needs the frame energy")
            log_e = torch.log(torch.clamp_min(energy, _LOG_FLOOR))
            ceps = torch.cat([log_e[..., None], ceps[..., 1:]], dim=-1)
        base = ceps
    else:
        raise ValueError(f"unknown feature_type {cfg.feature_type!r}")

    if frame_lengths is not None:
        base = _clamp_to_length(base, frame_lengths)
    if not cfg.add_deltas:
        return base
    d1 = _deltas(base, cfg.delta_width)
    if frame_lengths is not None:
        # re-clamp between delta passes so ΔΔ near a true end sees psf's
        # edge-padded Δ, not Δ of the clamped tail
        d1 = _clamp_to_length(d1, frame_lengths)
    d2 = _deltas(d1, cfg.delta_width)
    return torch.cat([base, d1, d2], dim=-1)


def extract_features(
    signal: torch.Tensor,
    cfg: FrontendConfig,
    *,
    n_frames: Optional[int] = None,
    sample_lengths: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Plain front-end: PCM [..., S] → features [..., T, feature_dim].

    With ``sample_lengths`` the two padded-batch corrections apply: the
    pre-emphasised signal is re-zeroed past each length, and frames past
    ``num_frames(len)`` are clamped before Δ and again before ΔΔ."""
    if n_frames is None:
        n_frames = frames_for_samples(signal.shape[-1], cfg)
    x = preemphasize(signal.to(torch.float32), cfg.preemphasis)
    frame_lengths = None
    if sample_lengths is not None:
        x = mask_past_length(x, sample_lengths)
        frame_lengths = num_frames(sample_lengths, cfg)
    pspec = power_spectrum(frame_signal(x, cfg, n_frames), cfg)
    logmel = log_mel(pspec, cfg)
    needs_energy = cfg.feature_type == "mfcc" and cfg.append_energy
    energy = torch.sum(pspec, dim=-1) if needs_energy else None
    return postprocess(logmel, energy, cfg, frame_lengths)
