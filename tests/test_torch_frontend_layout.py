"""What the front-end kernel leaves to Python, on the CPU: the basis
regrouped for the kernel (``kernel_basis``), the bins of each mel filter
(``mel_ranges``), the frame tile chosen from the shape (``frame_tile``),
and the kernel's tiling (tiles of that many frames read from one staged
sample window, the window walked in chunks of 16 rows, panels
of 256 bins, the last bin on its own, the mel product over each filter's
bins only) emulated in plain PyTorch on those layouts, against
``fused_logmel_plain`` and the Pallas ``fused_logmel`` in interpret mode."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from phones_las_tpu.frontend.features import FrontendConfig as JaxFrontendConfig
from phones_las_tpu.frontend.pallas_frontend import fused_logmel as jax_fused_logmel

from phones_las_torch.frontend import features as F
from phones_las_torch.frontend import fused_frontend as FF
from tests.torch_threads import one_thread

one_thread()

# float32 sums over 400-sample frames in another order: the bound of
# tests/test_torch_frontend.py; the energy (~1e9 for this PCM) relatively
TOL = 1e-4

PANEL = FF.BASIS_PANEL


def _signal(b, s, seed=0):
    """Pre-emphasised PCM at the scale of 16-bit speech: noise over a low
    hum, so that the lowest mel channels hold signal too (in pre-emphasised
    white noise they hold 1e-5 of a frame's power, and a float32 DFT of any
    order leaves them only three digits). The last frames run past the
    buffer and read zeros."""
    rs = np.random.RandomState(seed)
    n = np.arange(s) / 16000.0
    hum = 6000 * np.sin(2 * np.pi * 45 * n) + 4000 * np.sin(2 * np.pi * 110 * n + 1.0)
    x = (rs.randn(b, s) * 2000 + hum).astype(np.float32)
    return np.asarray(F.preemphasize(torch.from_numpy(x), 0.97))


def tiled_logmel_emulated(x, cfg, n_frames):
    """The kernel's arithmetic in plain PyTorch → (logmel, energy)."""
    cpu = torch.device("cpu")
    main, tail = FF.kernel_basis(cfg, cpu)
    lo, hi = FF.mel_ranges(cfg, cpu).tolist()
    mel = F.mel_matrix(cfg, cpu)
    win, hop, nb, nm = cfg.win_samples, cfg.hop_samples, cfg.num_bins, cfg.num_mel
    winp, _, nbm = main.shape
    kc = FF.BASIS_CHUNK
    FRAME_TILE = FF.frame_tile(cfg)
    b, s = x.shape
    logmel = torch.empty((b, n_frames, nm))
    energy = torch.empty((b, n_frames))
    for t0 in range(0, n_frames, FRAME_TILE):
        # the tile's sample window, zero past the buffer
        chunk = torch.zeros((b, (FRAME_TILE - 1) * hop + winp))
        have = max(0, min(chunk.shape[1], s - t0 * hop))
        chunk[:, :have] = x[:, t0 * hop:t0 * hop + have]
        frames = chunk.unfold(-1, winp, hop)  # [b, tile, winp]: rows past win meet zero basis rows
        power = torch.zeros((b, FRAME_TILE, nb))
        for p0 in range(0, nbm, PANEL):
            p1 = min(nbm, p0 + PANEL)
            re = torch.zeros((b, FRAME_TILE, p1 - p0))
            im = torch.zeros_like(re)
            for k0 in range(0, winp, kc):
                re += frames[..., k0:k0 + kc] @ main[k0:k0 + kc, 0, p0:p1]
                im += frames[..., k0:k0 + kc] @ main[k0:k0 + kc, 1, p0:p1]
            power[..., p0:p1] = (re * re + im * im) / cfg.nfft
        re, im = frames[..., :win] @ tail[:, 0], frames[..., :win] @ tail[:, 1]
        power[..., nbm] = (re * re + im * im) / cfg.nfft
        n = min(FRAME_TILE, n_frames - t0)
        energy[:, t0:t0 + n] = power[:, :n].sum(-1)
        for m in range(nm):
            acc = power[:, :n, lo[m]:hi[m]] @ mel[lo[m]:hi[m], m]
            logmel[:, t0:t0 + n, m] = torch.log(torch.clamp_min(acc, F._LOG_FLOOR))
    return logmel, energy


@pytest.mark.parametrize(
    "kw,s",
    [
        ({}, 12000),  # 74 frames: one full tile of 64 and a ragged one
        ({"window": "hamming"}, 8000),
        ({"nfft": 1024, "win_ms": 40.0}, 9000),  # two panels of 256 bins, win 640, tiles of 32 frames
        ({"nfft": 2048, "win_ms": 40.0}, 5000),  # four panels, tiles of 16 frames
        ({"nfft": 256, "win_ms": 10.0, "hop_ms": 5.0, "num_mel": 23}, 6000),  # half a panel
        ({"hop_ms": 10.0625}, 8000),  # hop 161: a frame's sample pairs not 8-byte aligned in the window
        ({"win_ms": 25.0625, "window": "povey"}, 8000),  # win 401: odd, padded to 416 rows
    ],
)
def test_tiled_emulation_matches_plain_and_pallas(kw, s):
    jcfg, cfg = JaxFrontendConfig(**kw), F.FrontendConfig(**kw)
    x = _signal(3, s, seed=len(kw))
    t = F.frames_for_samples(s, cfg)
    lm, en = tiled_logmel_emulated(torch.from_numpy(x), cfg, t)
    plm, pen = FF.fused_logmel_plain(torch.from_numpy(x), cfg, t)
    rlm, ren = jax_fused_logmel(jnp.asarray(x), jcfg, t, interpret=True)
    assert lm.shape == (3, t, cfg.num_mel) and en.shape == (3, t)
    np.testing.assert_allclose(lm.numpy(), plm.numpy(), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(en.numpy(), pen.numpy(), rtol=TOL)
    np.testing.assert_allclose(lm.numpy(), np.asarray(rlm), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(en.numpy(), np.asarray(ren), rtol=TOL)


@pytest.mark.parametrize("kw", [{}, {"window": "povey"}, {"nfft": 1024}, {"nfft": 256, "win_ms": 10.0}])
def test_kernel_basis_layout(kw):
    cfg = F.FrontendConfig(**kw)
    dev = torch.device("cpu")
    basis = F.dft_basis(cfg, dev)  # [win, cos | sin]
    main, tail = FF.kernel_basis(cfg, dev)
    win, nb = cfg.win_samples, cfg.num_bins
    nbm = cfg.nfft // 2
    winp = -(-win // FF.BASIS_CHUNK) * FF.BASIS_CHUNK
    assert main.shape == (winp, 2, nbm) and main.is_contiguous() and main.dtype == torch.float32
    assert tail.shape == (win, 2) and tail.is_contiguous()
    assert torch.equal(main[:win, 0], basis[:, :nbm]) and torch.equal(main[:win, 1], basis[:, nb:nb + nbm])
    if winp > win:
        assert float(main[win:].abs().max()) == 0.0
    assert torch.equal(tail[:, 0], basis[:, nbm]) and torch.equal(tail[:, 1], basis[:, nb + nbm])
    # cached: the kernel reads the same tensors at every call
    assert FF.kernel_basis(cfg, dev)[0] is main


def test_kernel_basis_refuses_an_nfft_without_groups_of_four_bins():
    with pytest.raises(ValueError, match="multiple of 8"):
        FF.kernel_basis(F.FrontendConfig(nfft=500), torch.device("cpu"))


@pytest.mark.parametrize("kw", [{}, {"num_mel": 23, "nfft": 256}, {"num_mel": 80, "low_hz": 300.0, "high_hz": 3400.0}])
def test_mel_ranges_cover_each_filter(kw):
    cfg = F.FrontendConfig(**kw)
    mel = F.mel_matrix(cfg, torch.device("cpu"))
    lo, hi = FF.mel_ranges(cfg, torch.device("cpu"))
    assert lo.dtype == torch.int32 and lo.shape == (cfg.num_mel,)
    for m in range(cfg.num_mel):
        inside = torch.zeros(cfg.num_bins, dtype=torch.bool)
        inside[int(lo[m]):int(hi[m])] = True
        assert float(mel[~inside, m].abs().sum()) == 0.0  # nothing is left out
        if int(hi[m]) > int(lo[m]):
            assert mel[int(lo[m]), m] != 0 and mel[int(hi[m]) - 1, m] != 0  # and the range is tight


@pytest.mark.parametrize(
    "kw,tile",
    [
        ({}, 64),  # the flagship: 25 ms window, nfft 512
        ({"nfft": 256, "win_ms": 10.0, "hop_ms": 5.0}, 64),
        ({"nfft": 1024}, 32),  # the power tile of 64 frames no longer fits beside the stages
        ({"nfft": 1024, "win_ms": 64.0}, 32),
        ({"nfft": 2048, "win_ms": 128.0}, 16),
        ({"nfft": 4096, "win_ms": 256.0}, 8),
    ],
)
def test_frame_tile_is_the_largest_that_fits(kw, tile):
    cfg = F.FrontendConfig(**kw)
    assert FF.frame_tile(cfg) == tile
    assert FF.logmel_smem_bytes(cfg, tile) <= FF.SMEM_MAX
    larger = [fm for fm in FF.FRAME_TILES if fm > tile]
    assert all(FF.logmel_smem_bytes(cfg, fm) > FF.SMEM_MAX for fm in larger)


def test_logmel_smem_bytes_at_the_flagship():
    # 64 frames: (63·160 + 400) samples, 3 stages of 16 × 2 × 256, 64 × 260 powers, 400 × 2 of the last bin
    assert FF.logmel_smem_bytes(F.FrontendConfig(), 64) == 4 * (10480 + 3 * 8192 + 64 * 260 + 800)


def test_frame_tile_refuses_a_window_no_tile_holds():
    with pytest.raises(ValueError, match="no frame tile"):
        FF.frame_tile(F.FrontendConfig(nfft=8192, win_ms=256.0))
