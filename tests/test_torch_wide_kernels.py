"""The kernels past their former limits, on the CPU: the decoder kernel's tiled
layout (every encoder length; spellers up to U = A = AL = 2048, M = 4096),
the listener kernels up to ``MAX_UNITS`` (the VJP's ring past U = 1024, the
bf16 ring) and the plain versions against JAX at those widths.

A CUDA kernel does not run here, so what can go wrong in its index
arithmetic is emulated: the tiled layout's staging against the streamed
layout's summation order, the bf16 ring's fragment order against the
tensor cores' B fragments."""

import math
import os
import re

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from phones_las_tpu.decode import greedy_decode as jax_greedy_decode
from phones_las_tpu.ops.lstm import _recurrence_xla

from phones_las_torch.decode import fused_greedy as FG
from phones_las_torch.decode.greedy import greedy_decode
from phones_las_torch.models.speller import SpellerConfig
from phones_las_torch.ops import lstm as L
from tests.test_torch_greedy import _memory, _models
from tests.torch_threads import one_thread

one_thread()

CSRC = os.path.join(os.path.dirname(L.__file__), "..", "csrc")
# against JAX: the bounds of tests/test_torch_widths.py
JAX_TOL = {"highest": 1e-5, "bf16": 2e-2}
JAX_RES_TOL = {"highest": 1e-5, "bf16": 3e-2}
VJP_TOL = {"highest": 1e-5, "bf16": 3e-2}  # max |d| over max |want|


def _cu_constant(source, name):
    src = open(os.path.join(CSRC, source)).read()
    return int(re.search(rf"constexpr (?:int|size_t) {name} = (\d+);", src).group(1))


def _speller(u, m, a=None, al=None, v=34, e=128, n_cells=2):
    return SpellerConfig(vocab_size=v, embedding_dim=e, num_layers=n_cells, units=u, memory_dim=m,
                         attention_units=a or u, attention_layer_size=al or u)


CHECKPOINT = _speller(256, 512, v=26)  # the committed checkpoint's speller
W1024 = _speller(1024, 2048, al=256)  # LAS-4-1024 through the reference's flags
W2048 = _speller(2048, 4096)  # encoder, decoder and attention units 2048


# ---- the decoder kernel: every encoder length, the wide spellers


@pytest.mark.parametrize("name,cfg", [("checkpoint", CHECKPOINT), ("W1024", W1024), ("W2048", W2048)])
def test_decoder_plans_every_encoder_length(name, cfg):
    """``kernel_widths`` plans, and never raises, for B >= 1 and T_enc up to
    100,000 (past 17,020, the streamed layout's limit at the checkpoint's
    speller, fault C9) at the checkpoint's, W1024's and W2048's speller
    widths (fault C11): held, then streamed, then tiled, each plan at the
    mirror's bytes within a block's; the tiled layout's bytes do not move
    with T, and W2048 takes it at every T."""
    for b in (1, 8, 64):
        for t in (1, 219, 438, 5868, 5869, 17020, 17021, 17100, 40000, 100000):
            kw, plan = FG.kernel_widths(b, cfg, t)
            assert plan.groups == -(-b // 8) and plan.cluster == 8
            smem = FG.decoder_smem_bytes(b, t, kw, plan.cluster, plan.streamed, plan.tiled)
            assert smem <= FG.SMEM_MAX
            # a layout is taken only where the ones before it do not fit
            if plan.streamed:
                assert FG.decoder_smem_bytes(b, t, kw, plan.cluster) > FG.SMEM_MAX
            if plan.tiled:
                assert FG.decoder_smem_bytes(b, t, kw, plan.cluster, True) > FG.SMEM_MAX
                assert smem == FG.decoder_smem_bytes(b, 1, kw, plan.cluster, True, True)
            assert plan.tiled == (name == "W2048" or t > {"checkpoint": 17020, "W1024": 5868}[name])


def test_tiled_layout_bytes_are_the_kernels():
    """The tiled layout's bytes region by region as ``csrc/greedy.cu::
    dec_layout`` declares them (its constants read from the .cu), at
    W2048's speller and at the checkpoint's at T_enc = 40,000."""
    threads, dr, ktile, ttile = (_cu_constant("greedy.cu", n) for n in ("THREADS", "DR", "KTILE", "TTILE"))
    assert (FG.THREADS, FG.GROUP_ROWS, FG.KTILE, FG.TTILE) == (threads, dr, ktile, ttile)
    assert FG.SMEM_MAX == _cu_constant("greedy.cu", "SMEM_MAX")
    for cfg, t, want in ((W2048, 438, 181408), (CHECKPOINT, 40000, 104464)):
        c, u, a, al, m, n = 8, cfg.units, cfg.attention_units, cfg.attention_layer_size, cfg.memory_dim, 2
        vc = -(-(-(-cfg.vocab_size // c)) // 4) * 4
        regions = [
            dr * min(max(cfg.embedding_dim + al + u, 2 * u, u + m), ktile),  # stage: a tile of a row
            n * dr * (u // c),  # the cells' c
            -(-dr // c) * a,  # q of the rows the block attends for
            max(threads * 4 * dr, dr * max(4 * u // c, a // c, al // c), threads * 4, m, threads // 32 * dr * vc),
            vc, n * 4 * (u // c),  # out_b, biases
            ttile, -(-a // 4) * 4, dr * vc,  # a tile of weights, v, logits
            2 * 8 * dr, 4 * dr, 64,
        ]
        assert FG.decoder_smem_bytes(8, t, cfg, c, tiled=True) == 4 * sum(regions) == want


THREADS, DR, NWARPS = FG.THREADS, FG.GROUP_ROWS, FG.THREADS // 32


def _dense_order(k, ncols):
    """``dense``'s items (column group, k part) → the float4s of k each
    sums, in order."""
    ncg, k4n = ncols // 4, k // 4
    ks_n = max(1, min(THREADS // ncg, k4n))
    kper = -(-k4n // ks_n)
    return {(c, ks): list(range(ks * kper, min(k4n, ks * kper + kper))) for c in range(ncg) for ks in range(ks_n)}


def _dense_tiled_order(k, ncols, kt):
    """``dense_tiled``'s items at a stage row of ``kt`` floats: each tile
    staged as the kernel stages it, each item's float4s read back from the
    stage where the item reads them (asserted to be the k it sums)."""
    ncg, k4n = ncols // 4, k // 4
    ks_n = max(1, min(THREADS // ncg, k4n))
    kper = -(-k4n // ks_n)
    s4 = max(1, min(kper, kt // 4 // ks_n))
    assert 4 * ks_n * s4 <= kt  # the stage's row
    order = {(c, ks): [] for c in range(ncg) for ks in range(ks_n)}
    for j in range(-(-kper // s4)):
        stage = {}
        for i in range(ks_n * s4):  # one row's tile (every row is staged alike)
            ks, q = divmod(i, s4)
            k4 = ks * kper + j * s4 + q
            stage[i] = k4 if j * s4 + q < kper and k4 < k4n else None
        for (c, ks), seq in order.items():
            kb = ks * kper + j * s4
            for k4 in range(kb, min(k4n, (ks + 1) * kper, kb + s4)):
                assert stage[ks * s4 + k4 - kb] == k4
                seq.append(k4)
    return order


def _context_orders(tl, m, ttile):
    """The context's items (4 columns of M, part of T) → the positions each
    sums, in order: streamed (all weights in shared memory) and tiled
    (weights staged ``ttile`` at a time, read back where the item reads
    them)."""
    mq = m // 4
    ts_n = max(1, THREADS // mq)
    tper = -(-tl // ts_n)
    streamed = {ts: list(range(ts * tper, min(tl, ts * tper + tper))) for ts in range(ts_n)}
    st = max(1, min(tper, ttile // ts_n))
    assert ts_n * st <= ttile
    tiled = {ts: [] for ts in range(ts_n)}
    for j in range(max(1, -(-tper // st))):
        stage = {}
        for i in range(ts_n * st):
            ts, q = divmod(i, st)
            t = ts * tper + j * st + q
            stage[i] = t if j * st + q < tper and t < tl else None
        for ts, seq in tiled.items():
            tb = ts * tper + j * st
            for t in range(tb, min(tl, (ts + 1) * tper, tb + st)):
                assert stage[ts * st + t - tb] == t
                seq.append(t)
    return streamed, tiled


def _logit_orders(al, kt):
    """The logits' k parts (a warp each) → the float4s of k each sums:
    streamed and tiled, as ``_dense_tiled_order``."""
    kq = al // 4
    kper = -(-kq // NWARPS)
    streamed = {w: list(range(w * kper, min(kq, w * kper + kper))) for w in range(NWARPS)}
    s4 = max(1, min(kper, kt // 4 // NWARPS))
    tiled = {w: [] for w in range(NWARPS)}
    for j in range(-(-kper // s4)):
        stage = {}
        for i in range(NWARPS * s4):
            ks, q = divmod(i, s4)
            k4 = ks * kper + j * s4 + q
            stage[i] = k4 if j * s4 + q < kper and k4 < kq else None
        for w, seq in tiled.items():
            kb = w * kper + j * s4
            for k4 in range(kb, min(kq, (w + 1) * kper, kb + s4)):
                assert stage[w * s4 + k4 - kb] == k4
                seq.append(k4)
    return streamed, tiled


@pytest.mark.parametrize("cfg", [CHECKPOINT, W1024, W2048, _speller(36, 200, 60, 256, e=32)])
def test_tiled_layout_keeps_the_streamed_order(cfg):
    """Every sum the tiled layout takes (each dense stage's k parts, the
    context's parts of T, the logits' parts of k) adds the same terms in
    the same order as the streamed layout's, the staged tiles holding what
    each item reads: so its tokens are the streamed layout's, bit for bit
    (the card checks that too)."""
    c = FG.decoder_plan(8, cfg, 438).cluster
    kw = FG.KTILE
    e, u, a, al, m = cfg.embedding_dim, cfg.units, cfg.attention_units, cfg.attention_layer_size, cfg.memory_dim
    kt = min(max(e + al + u, 2 * u, u + m), kw)
    for k, ncols in ((e + al + u, 4 * u // c), (2 * u, 4 * u // c), (u, a // c), (u + m, al // c)):
        assert _dense_tiled_order(k, ncols, kt) == _dense_order(k, ncols)
    for tl in (0, 1, 7, 438, 5000, 17100, 40000):
        streamed, tiled = _context_orders(tl, m, FG.TTILE)
        assert tiled == streamed
    streamed, tiled = _logit_orders(al, kt)
    assert tiled == streamed


def test_greedy_past_the_streamed_layout_matches_jax():
    """A narrow speller at an encoder length past what its held and
    streamed layouts hold (T_enc = 30,000: the tiled layout's case): the
    port's greedy decode (the plain path here) and the kernel's plain
    version give JAX ``greedy_decode``'s tokens."""
    jcfg, jp, tcfg, tp = _models(2)
    b, t, steps = 2, 30000, 6
    kw, plan = FG.kernel_widths(b, tcfg.speller, t)
    assert plan.tiled and FG.decoder_smem_bytes(b, t, kw, plan.cluster, True) > FG.SMEM_MAX
    mem, mask = _memory(b, t, seed=5)
    ref, _, _ = jax_greedy_decode(jp.speller, jcfg.speller, jnp.asarray(mem), jnp.asarray(mask), max_steps=steps)
    with torch.no_grad():
        tok, _, _ = greedy_decode(tp.speller, tcfg.speller, torch.from_numpy(mem), torch.from_numpy(mask), steps)
        ftok, _ = FG.greedy_decode_fused_plain(tp.speller, tcfg.speller, torch.from_numpy(mem),
                                               torch.from_numpy(mask), steps)
    np.testing.assert_array_equal(tok.numpy(), np.asarray(ref))
    np.testing.assert_array_equal(ftok.numpy(), np.asarray(ref))


# ---- the listener kernels up to MAX_UNITS


def test_max_units_is_the_widest_with_every_plan(monkeypatch):
    """``MAX_UNITS`` (the .cu's too) is the widest multiple of 8 at which
    every route has a plan: float32 and bf16, the forward (and residual)
    and the VJP's loop, one and two directions, at the serving and the
    training batch; at the next multiple of 8 the VJP's loop has none (its
    U-wide partial dh: four rows of whᵀ pass a 32 KB ring slot in float32,
    a warp's n-tiles pass 32 in bf16)."""
    assert L.MAX_UNITS == _cu_constant("lstm.cu", "MAX_UNITS") >= 2048
    monkeypatch.setattr(L, "MAX_UNITS", L.MAX_UNITS + 64)

    def routes(u):
        for prec in ("highest", "bf16"):
            for nd, b in ((1, 32), (2, 64), (2, 8)):
                L.forward_plan(b, u, nd, prec)
                L.backward_plan(b, u, nd, prec)

    for u in (1032, 1280, 1536, 2040, L.MAX_UNITS - 64):
        routes(u)
    routes(L.MAX_UNITS - 64)  # the range is walked whole by test_plans_take_every_width_to_1024
    with pytest.raises(ValueError, match="VJP"):
        routes(L.MAX_UNITS - 64 + 8)  # = the module's MAX_UNITS + 8


def _h100_active(c, *_):
    return 7 if c > 8 else 15


# every forward and VJP plan of the float32 routes up to U = 1024 and of the
# bf16 routes up to 384 (B = 8, 32, 64; one and two directions; with and
# without the H100's occupancy), as the planners before the bf16 ring and the
# widths past 1024 gave them: their digest
PLANS_BEFORE = (2112, "c5c17d513283035f82856cb21f769b19a406f7632a06ed1423816c19fdff0013")


def test_plans_below_the_new_routes_are_unchanged():
    """The float32 plans at U <= 1024 and the bf16 plans at U <= 384 do not
    move: the ring past 1024, the bf16 ring and clusters of 16 in several
    waves change no plan there."""
    import hashlib
    import json

    rows = []
    for prec, top in (("highest", 1024), ("bf16", 384)):
        for u in range(8, top + 1, 8):
            for b in (8, 32, 64):
                for nd in (1, 2):
                    for active in (None, _h100_active):
                        f = L.forward_plan(b, u, nd, prec, active)
                        g = L.backward_plan(b, u, nd, prec, None if active is None else (lambda p: _h100_active(
                            p.cluster)))
                        rows.append((prec, u, b, nd, active is None, tuple(f), tuple(g)))
    assert (len(rows), hashlib.sha256(json.dumps(rows).encode()).hexdigest()) == PLANS_BEFORE


@pytest.mark.parametrize("prec", ["highest", "bf16"])
def test_vjp_ring_plans_past_1024(prec):
    """The VJP's loop from U = 1032 to 2048: the ring, at the mirror's bytes;
    float32 with a thread owning ``ring_cw4`` = ceil(U / 1024) groups of 4
    units (at most 256 threads for all U, at most 96 sums a thread), bf16
    with a warp's n-tiles within a built instance; clusters of 16 where
    nothing smaller fits."""
    for u in range(1032, L.MAX_UNITS + 1, 8):
        for b, active in ((32, None), (8, _h100_active), (32, _h100_active)):
            p = L.backward_plan(b, u, 2, prec, None if active is None else (lambda q: active(q.cluster)))
            assert p.ring and not p.resident and p.units % (8 * p.cluster) == 0
            assert p.smem == L.backward_smem_bytes(p.units, p.cluster, p.bt, p.ksplit, False, prec == "bf16", True)
            assert p.smem <= L.RING_SMEM_MAX
            kc = L.ring_slots(p.units, p.cluster, p.bt, p.ksplit, bwd=True, bf16=prec == "bf16")[0]
            if prec == "highest":
                cw4 = L.ring_cw4(p.units)
                assert cw4 == 2 and p.units // (4 * cw4) * p.ksplit <= L.FWD_THREADS and p.bt * cw4 <= 24
                assert kc >= 4
            else:
                assert L.bf16_ring_ntw(-(-p.units // 16) * 2, -(-p.bt // 16), True) and kc >= 1
    assert L.backward_plan(32, 2048, 2, prec).cluster == 16  # no cluster of 8 holds U = 2048's ring


def test_ring_fragments_are_the_mma_layout():
    """``ring_fragments`` read back as the bf16 ring's producer and
    consumer address it (chunk after chunk of ``kc`` k steps of one piece;
    a lane's four values at ((step·NTp + tile)·32 + lane)·4): lane 4·g + t
    holds column g's k = 2t, 2t + 1, 2t + 8, 2t + 9 of its tile and k step,
    the B fragment of ``mma.m16n8k16``."""
    c, n, k, ks, kc = 2, 32, 48, 2, 2
    w = torch.arange(c * n * k, dtype=torch.float32).reshape(c, n, k)  # exact in the order's arithmetic
    flat = L.ring_fragments(w, ks, kc)
    assert flat.shape == (c, n * k)
    k16, ntp = k // 16, n // 8 // ks
    for blk in range(c):
        off = 0
        for i in range(-(-k16 // kc) * ks):
            kg, piece = divmod(i, ks)
            kcs = min(kc, k16 - kg * kc)
            for step in range(kcs):
                for ntl in range(ntp):
                    for lane in range(32):
                        g, t = divmod(lane, 4)
                        at = off + ((step * ntp + ntl) * 32 + lane) * 4
                        col, k0 = (piece * ntp + ntl) * 8 + g, (kg * kc + step) * 16
                        want = w[blk, col, [k0 + 2 * t, k0 + 2 * t + 1, k0 + 2 * t + 8, k0 + 2 * t + 9]]
                        assert torch.equal(flat[blk, at:at + 4], want)
            off += kcs * ntp * 128
        assert off == n * k


@pytest.mark.parametrize("u", [1280, 2048])
@pytest.mark.parametrize("prec", ["highest", "bf16"])
def test_plain_recurrence_and_vjp_match_jax_at_wide_units(prec, u):
    """The plain versions the kernels are held to on the card, at U = 1280
    and 2048 (T = 4, B = 2): the forward with its residuals against JAX's
    ``_recurrence_xla``, the VJP against ``jax.grad`` of it."""
    t, b = 4, 2
    rs = np.random.RandomState(u)
    xp = rs.randn(t, b, 4 * u).astype(np.float32)
    wh = (rs.randn(u, 4 * u) / np.sqrt(u)).astype(np.float32)
    mask = (np.arange(t)[:, None] < np.array([t, 2])[None, :]).astype(np.float32)
    dout = rs.randn(t, b, u).astype(np.float32)
    dh, dc = rs.randn(b, u).astype(np.float32), rs.randn(b, u).astype(np.float32)
    txp, tmask, twh = torch.from_numpy(xp), torch.from_numpy(mask), torch.from_numpy(wh)
    ((out, hprev, cprev, h, c),) = L.recurrence_residual_plain([txp], tmask, [twh], 1.0, [False], prec)
    xout, (xh, xc) = _recurrence_xla(jnp.asarray(xp), jnp.asarray(mask), jnp.asarray(wh), 1.0, False, prec)
    for g, x in ((out, xout), (h, xh), (c, xc)):
        np.testing.assert_allclose(g.numpy(), np.asarray(x, np.float32), rtol=JAX_TOL[prec], atol=JAX_TOL[prec])
    ((dxp, dwh),) = L.recurrence_bwd_plain([txp], tmask, [twh], [hprev], [cprev], [torch.from_numpy(dout)],
                                           [torch.from_numpy(dh)], [torch.from_numpy(dc)], 1.0, [False], prec)

    def loss(xp_, wh_):
        o, (hh, cc) = _recurrence_xla(xp_, jnp.asarray(mask), wh_, 1.0, False, prec)
        return jnp.sum(o * dout) + jnp.sum(hh * dh) + jnp.sum(cc * dc)

    jdxp, jdwh = jax.grad(loss, argnums=(0, 1))(jnp.asarray(xp), jnp.asarray(wh))
    rel = lambda g, w: float(np.abs(g - np.asarray(w, np.float32)).max()) / float(np.abs(np.asarray(w)).max())
    assert rel(dxp.numpy(), jdxp) <= VJP_TOL[prec]
    assert rel(dwh.numpy(), jdwh) <= VJP_TOL[prec]
    assert math.isfinite(float(dwh.abs().max()))
