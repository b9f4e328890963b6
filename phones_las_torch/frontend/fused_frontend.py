"""Fused log-mel front-end: the CUDA kernel ``csrc/frontend.cu`` and its
plain PyTorch version.

Replaces the Pallas kernel ``phones_las_tpu/frontend/pallas_frontend.py::
fused_logmel``. One CUDA block takes one utterance and a tile of 64
frames (fewer for an nfft of 1024 and more, ``frame_tile``): it stages the tile's sample window in shared memory, forms the
frames there (the [B, T, win] framed tensor never reaches device memory),
multiplies them by the windowed real-DFT basis, and writes the frame
energy and ``log(max(power @ mel, eps64))``.

Bound on the H100 at the main path's shape (B = 64 × 10 s, T = 999):
the DFT product is 2·B·T·400·514 ≈ 26 GFLOP of float32, about 0.4 ms at
the card's 67 TFLOP/s outside the tensor cores, against 41 MB of signal
and 11 MB of output (≈ 16 µs at 3.35 TB/s): operations bound it. So the
product is register tiled (8 frames × 8 bins, re and im, a thread: 16
shared-memory loads for 256 fused multiply-adds), the basis is streamed
through three shared-memory stages in chunks of 16 window rows and read
from L2 once per 64 frames, and the mel product runs only where a
channel's filter is not zero. Each sum runs over the window in ascending
order, as a plain matrix product does.

What of this is layout lives here, where the CPU tests reach it:
``kernel_basis`` (the basis regrouped for 16-byte loads), ``mel_ranges``
and ``frame_tile``; ``tests/test_torch_frontend_layout.py`` emulates the
kernel's tiling on them.

Pre-emphasis and length masking stay outside the kernel, and so do Δ,
DCT and CMVN, as in the reference.
"""

from __future__ import annotations

import functools
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


CLOCK_NAMES = ("staging", "dft_product", "last_bin", "energy_mel")
BASIS_CHUNK = 16  # window rows of a basis chunk in the kernel (KC of csrc/frontend.cu)
BASIS_PANEL = 256  # bins of a basis panel (PANEL)
BASIS_STAGES = 3  # shared-memory stages of basis chunks (NST)
FRAME_TILES = (64, 32, 16, 8)  # frames of a block the kernel is built for (FM)
SMEM_MAX = 232448  # bytes of shared memory a block may take on the H100


def logmel_smem_bytes(cfg: F.FrontendConfig, fm: int) -> int:
    """Shared memory of one block at a tile of ``fm`` frames (``layout`` of
    csrc/frontend.cu): the tile's sample window, the basis stages, the
    power tile and the last bin's basis."""
    winp = -(-cfg.win_samples // BASIS_CHUNK) * BASIS_CHUNK
    nbs = -(-cfg.num_bins // 4) * 4
    samples = -(-((fm - 1) * cfg.hop_samples + winp) // 4) * 4
    return 4 * (samples + BASIS_STAGES * BASIS_CHUNK * 2 * BASIS_PANEL + fm * nbs + 2 * winp)


def frame_tile(cfg: F.FrontendConfig) -> int:
    """The largest tile of ``FRAME_TILES`` whose block fits in shared memory:
    64 frames up to an nfft of 512 at 16 kHz, 32 at 1024, 16 at 2048.
    Raises where not even 8 frames fit."""
    for fm in FRAME_TILES:
        if logmel_smem_bytes(cfg, fm) <= SMEM_MAX:
            return fm
    raise ValueError(
        f"the front-end kernel has no frame tile for win={cfg.win_samples} hop={cfg.hop_samples} "
        f"nfft={cfg.nfft}: {logmel_smem_bytes(cfg, FRAME_TILES[-1])} bytes of shared memory at "
        f"{FRAME_TILES[-1]} frames, {SMEM_MAX} allowed"
    )


@functools.lru_cache(maxsize=8)
def kernel_basis(cfg: F.FrontendConfig, device: torch.device) -> Tuple[torch.Tensor, torch.Tensor]:
    """The DFT basis as the kernel reads it (cached per config and device;
    callers must not write to it) → (main, tail):

    * ``main [winp, 2, nfft/2]``: bins 0 … nfft/2 − 1, per window row the
      cos row and then the sin row (so a thread loads four neighbouring
      bins with one 16-byte load), the window zero padded to winp, a
      multiple of ``BASIS_CHUNK`` rows;
    * ``tail [win, 2]``: the last bin, nfft/2, as (cos, sin).

    Raises for an nfft that is no multiple of 8 (bins in groups of four)."""
    if cfg.nfft % 8 or cfg.nfft < 8:
        raise ValueError(f"the front-end kernel takes nfft a multiple of 8, got {cfg.nfft}")
    basis = F.dft_basis(cfg, device)  # [win, 2·nbins]: cos | sin
    win, nb = cfg.win_samples, cfg.num_bins
    cs = basis.reshape(win, 2, nb)
    main = torch.nn.functional.pad(cs[:, :, :nb - 1], (0, 0, 0, 0, 0, -win % BASIS_CHUNK)).contiguous()
    tail = cs[:, :, nb - 1].contiguous()
    return main, tail


@functools.lru_cache(maxsize=8)
def mel_ranges(cfg: F.FrontendConfig, device: torch.device) -> torch.Tensor:
    """``[2, num_mel]`` int32 (cached like ``kernel_basis``): for each mel
    channel the first bin of its filter and one past its last. The filters
    are narrow triangles (a dozen of the 257 bins each), and the kernel's
    mel product runs over these bins only; outside them the matrix is zero."""
    nz = torch.as_tensor(F.mel_filterbank(cfg) != 0)  # [num_bins, num_mel]
    nb = nz.shape[0]
    first = nz.int().argmax(dim=0)
    last = nb - nz.flip(0).int().argmax(dim=0)
    empty = ~nz.any(dim=0)
    first[empty], last[empty] = 0, 0
    return torch.stack([first, last]).to(device=device, dtype=torch.int32).contiguous()


def fused_logmel(
    signal: torch.Tensor,  # [B, S] float32, already pre-emphasised and masked
    cfg: F.FrontendConfig,
    n_frames: int,
    clocks: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """→ (logmel [B, n_frames, n_mel], energy [B, n_frames]).

    A CPU tensor runs the plain version; a CUDA tensor launches the
    kernel (built at first use) at the tile ``frame_tile(cfg)`` or raises
    (an nfft that is no multiple of 8, a window too long for shared memory
    at any tile). The kernel computes in float32
    for both ``precision='highest'`` and ``'high'``. For measurements,
    ``clocks`` (an int64 CUDA tensor of ``len(CLOCK_NAMES)``) receives the
    SM cycles one block spent in each part."""
    if signal.ndim != 2 or signal.dtype != torch.float32:
        raise ValueError(f"fused_logmel expects [B, S] float32, got {tuple(signal.shape)} {signal.dtype}")
    if not check_kernel_device(signal):
        return fused_logmel_plain(signal, cfg, n_frames)

    from phones_las_torch.csrc import _build

    fm = frame_tile(cfg)
    lib = _build.library()
    x = signal.contiguous()
    b, s = x.shape
    basis, tail = kernel_basis(cfg, x.device)
    mel = F.mel_matrix(cfg, x.device)
    ranges = mel_ranges(cfg, x.device)
    logmel = torch.empty((b, n_frames, cfg.num_mel), dtype=torch.float32, device=x.device)
    energy = torch.empty((b, n_frames), dtype=torch.float32, device=x.device)
    err = lib.plt_fused_logmel(
        x.data_ptr(), b, s, basis.data_ptr(), tail.data_ptr(), mel.data_ptr(), ranges.data_ptr(),
        logmel.data_ptr(), energy.data_ptr(), n_frames, cfg.win_samples,
        cfg.hop_samples, cfg.nfft, cfg.num_mel, fm,
        None if clocks is None else clocks.data_ptr(),
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
