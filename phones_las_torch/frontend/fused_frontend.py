"""Fused log-mel front-end: the CUDA kernel ``csrc/frontend.cu`` and its
plain PyTorch version.

Replaces the Pallas kernel ``phones_las_tpu/frontend/pallas_frontend.py::
fused_logmel``. One CUDA block takes one utterance and a tile of 16
frames: it stages the tile's sample window in shared memory, forms the
frames there (the [B, T, win] framed tensor never reaches device memory),
multiplies them by the windowed real-DFT basis read through L2, and
writes the power, the frame energy and ``log(max(power @ mel, eps64))``.

Bound on the H100 at the main path's shape (B = 64 × 10 s, T = 999):
the DFT product is 2·B·T·400·514 ≈ 26 GFLOP of float32, about 0.4 ms at
the card's 67 TFLOP/s outside the tensor cores, against 41 MB of signal
and 11 MB of output (≈ 16 µs at 3.35 TB/s): operations bound it. The
design keeps the frames out of device memory and gives each thread one
frequency bin for all 16 frames of its tile, so each basis element read
from L2 feeds 16 fused multiply-adds per re/im pair.

Pre-emphasis and length masking stay outside the kernel, and so do Δ,
DCT and CMVN, as in the reference.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from phones_las_torch.frontend import features as F
from phones_las_torch.utils.device import check_kernel_device


def fused_logmel_plain(
    signal: torch.Tensor, cfg: F.FrontendConfig, n_frames: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the kernel: → (logmel [B, T, n_mel], energy [B, T])."""
    pspec = F.power_spectrum(F.frame_signal(signal, cfg, n_frames), cfg)
    return F.log_mel(pspec, cfg), torch.sum(pspec, dim=-1)


def fused_logmel(
    signal: torch.Tensor,  # [B, S] float32, already pre-emphasised and masked
    cfg: F.FrontendConfig,
    n_frames: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """→ (logmel [B, n_frames, n_mel], energy [B, n_frames]).

    A CPU tensor runs the plain version; a CUDA tensor launches the
    kernel (built at first use) or raises. The kernel computes in float32
    for both ``precision='highest'`` and ``'high'``."""
    if signal.ndim != 2 or signal.dtype != torch.float32:
        raise ValueError(f"fused_logmel expects [B, S] float32, got {tuple(signal.shape)} {signal.dtype}")
    if not check_kernel_device(signal):
        return fused_logmel_plain(signal, cfg, n_frames)

    from phones_las_torch.csrc import _build

    lib = _build.library()
    x = signal.contiguous()
    b, s = x.shape
    basis = F.dft_basis(cfg, x.device)
    mel = F.mel_matrix(cfg, x.device)
    logmel = torch.empty((b, n_frames, cfg.num_mel), dtype=torch.float32, device=x.device)
    energy = torch.empty((b, n_frames), dtype=torch.float32, device=x.device)
    err = lib.plt_fused_logmel(
        x.data_ptr(), b, s, basis.data_ptr(), mel.data_ptr(),
        logmel.data_ptr(), energy.data_ptr(), n_frames, cfg.win_samples,
        cfg.hop_samples, cfg.num_bins, cfg.num_mel, cfg.nfft,
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    _build.check(err, "plt_fused_logmel")
    fused_logmel.launches += 1
    return logmel, energy


fused_logmel.launches = 0


def extract_features_fused(
    signal: torch.Tensor,
    cfg: F.FrontendConfig,
    *,
    n_frames: Optional[int] = None,
    sample_lengths: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Drop-in fused replacement for ``features.extract_features`` on
    batched [B, S] input (same padded-batch semantics)."""
    if signal.ndim != 2:
        raise ValueError("the fused front-end expects [B, S]")
    if n_frames is None:
        n_frames = F.frames_for_samples(signal.shape[-1], cfg)
    x = F.preemphasize(signal.to(torch.float32), cfg.preemphasis)
    frame_lengths = None
    if sample_lengths is not None:
        x = F.mask_past_length(x, sample_lengths)
        frame_lengths = F.num_frames(sample_lengths, cfg)
    logmel, energy = fused_logmel(x, cfg, n_frames)
    return F.postprocess(logmel, energy, cfg, frame_lengths)
