"""The kernels past their former limits, on the CPU: the decoder kernel's
plans at every encoder length and at spellers up to U = A = AL = 2048,
M = 4096 (the held layout where a block holds it, the grid layout past it),
the listener kernels up to ``MAX_UNITS`` (the VJP's grid layout past U =
1024) and the plain versions against JAX at those widths.

A CUDA kernel does not run here, so what can go wrong in its index
arithmetic is checked against the .cu: the held layout's shared memory
region by region, the bf16 grid kernels' fragment order against the tensor
cores' B fragments."""

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
    100,000 (faults C9 and C11) at the checkpoint's, W1024's and W2048's
    speller widths: the held layout (C = 8, at the mirror's bytes within a
    block's) fits up to the longest sequence it holds, 8436 positions at the
    checkpoint's speller and none at W1024's or W2048's; the plan takes it
    there where the step model says it is the faster, else, and past it at
    no cluster size, the grid layout in one launch within a block's bytes."""
    for b in (1, 8, 64):
        for t in (1, 219, 438, 5868, 5869, 8436, 8437, 17020, 17021, 17100, 40000, 100000):
            kw, plan = FG.kernel_widths(b, cfg, t)
            assert kw == FG.kernel_widths(1, cfg, 1, "grid")[0] and plan.groups == -(-b // 8)
            fits = name == "checkpoint" and t <= 8436
            if fits:
                held = FG.kernel_widths(b, cfg, t, "held")[1]
                assert held == FG.DecoderPlan(8, 8, -(-b // 8)) and FG.decoder_smem_bytes(b, t, kw, 8) <= FG.SMEM_MAX
            else:
                assert all(FG.decoder_smem_bytes(b, t, kw, c) > FG.SMEM_MAX for c in FG.DECODER_CLUSTERS)
                with pytest.raises(ValueError, match="no held layout"):
                    FG.kernel_widths(b, cfg, t, "held")
            if plan.layout == 0:
                assert fits and FG.step_us(b, t, kw, plan) <= FG.step_us(b, t, kw, FG.decoder_plan(b, kw, t, "grid"))
            else:
                assert plan == FG.DecoderPlan(1, 8, -(-b // 8), grid=FG.grid_cuts(b, kw))
                assert FG.decoder_smem_bytes(b, t, kw, 1, grid=plan.grid) <= FG.SMEM_MAX
                if fits:
                    assert FG.step_us(b, t, kw, plan) < FG.step_us(b, t, kw, held)


def _cu_layout_regions(function, names):
    """The sizes a .cu layout function adds region by region (``off +=
    ...``), evaluated with ``names`` (its arguments and locals, C's integer
    division as Python's)."""
    src = open(os.path.join(CSRC, "greedy.cu")).read()
    body = re.search(rf"{function}\(.*?\n}}\n", src, re.S).group(0)
    env = {"pad4": lambda n: -(-n // 4) * 4, "smax": max, **names}
    exprs = [re.sub(r"\((?:size_t|int)\)", "", x).replace("L.", "").replace(" / ", " // ")
             for x in re.findall(r"off \+= ([^;]+);", body)]
    return [eval(x, {}, env) for x in exprs]


@pytest.mark.parametrize("b,t,cfg,c", [
    (64, 250, CHECKPOINT, 8), (32, 438, _speller(512, 512, al=256), 8), (8, 125, _speller(36, 200, 60, 256, e=32), 1),
    (32, 438, _speller(256, 512, v=120, n_cells=1), 8), (8, 8436, CHECKPOINT, 8), (8, 438, _speller(256, 512, v=480), 4),
])
def test_held_layout_bytes_are_the_kernels(b, t, cfg, c):
    """The held layout's bytes (``decoder_smem_bytes``) region by region as
    ``csrc/greedy.cu::dec_layout`` adds them, its constants read from the
    .cu, at the main path's shape, the LAS paper's speller, W100's, a
    preset's one-cell phone speller, the checkpoint's longest held sequence
    and a vocabulary of 480 at a cluster of 4."""
    threads, dr = (_cu_constant("greedy.cu", n) for n in ("THREADS", "DR"))
    assert (FG.THREADS, FG.GROUP_ROWS, FG.SMEM_MAX) == (threads, dr, _cu_constant("greedy.cu", "SMEM_MAX"))
    e, u, a, al, m = cfg.embedding_dim, cfg.units, cfg.attention_units, cfg.attention_layer_size, cfg.memory_dim
    vc = -(-(-(-cfg.vocab_size // c)) // 4) * 4
    regions = _cu_layout_regions("DecLayout dec_layout", {
        "DR": dr, "THREADS": threads, "NWARPS": threads // 32, "T": t, "A": a, "M": m, "AL": al, "U": u, "C": c,
        "n_cells": cfg.num_layers, "Kmax": max(e + al + u, 2 * u, u + m), "Vc": vc, "ldo": al + 4,
        "widest": max(4 * u // c, a // c, al // c)})
    assert len(regions) == 17
    assert FG.decoder_smem_bytes(b, t, cfg, c) == 4 * sum(regions)


def test_greedy_past_the_streamed_layout_matches_jax():
    """A narrow speller at an encoder length past what its held layout
    holds at any cluster size (T_enc = 30,000, where the plan takes the
    grid layout): the port's greedy decode (the plain path here) and the
    kernel's plain version give JAX ``greedy_decode``'s tokens."""
    jcfg, jp, tcfg, tp = _models(2)
    b, t, steps = 2, 30000, 6
    kw, plan = FG.kernel_widths(b, tcfg.speller, t)
    assert plan.layout == 1 and all(FG.decoder_smem_bytes(b, t, kw, c) > FG.SMEM_MAX for c in FG.DECODER_CLUSTERS)
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
    """``MAX_UNITS`` (the .cu's too) is 2048, the widest U that every route
    has a plan for and the card is held to: float32 and bf16, the forward
    (and residual) and the VJP's loop, one and two directions, at the
    serving and the training batch. The grid layouts' plans go further
    (every multiple of 8 to 4·``MAX_UNITS`` has one, at one launch a pass of
    rows), so the bound is what chip_smoke.py checks on the card (13a at
    2048, W2048 in 13d), not what fits; past it the wrappers refuse."""
    assert L.MAX_UNITS == _cu_constant("lstm.cu", "MAX_UNITS") == 2048

    def routes(u):
        for prec in ("highest", "bf16"):
            for nd, b in ((1, 32), (2, 64), (2, 8)):
                L.forward_plan(b, u, nd, prec)
                L.backward_plan(b, u, nd, prec)

    for u in (1032, 1280, 1536, 2040, L.MAX_UNITS):
        routes(u)
    with pytest.raises(ValueError, match="2048"):
        routes(L.MAX_UNITS + 8)
    monkeypatch.setattr(L, "MAX_UNITS", 4 * L.MAX_UNITS)
    for u in range(2056, 4 * 2048 + 1, 8 * 37):
        routes(u)
    routes(4 * 2048)


def _h100_active(c, *_):
    return 7 if c > 8 else 15


# every VJP plan of the template up to U = 512 (float32, GRID_UNITS_BWD) and
# 384 (bf16), and every forward plan of those routes that the template keeps
# with its slice of wh held (float32 up to 256, bf16 up to 384; the others,
# once its streamed slice, take the grid layout), at B = 8, 32, 64, one and
# two directions, with and without the H100's occupancy, as the planners
# before the forward's second grid layout gave them (a plan as its first six
# fields, the cut; a forward plan with no ring): their digest
PLANS_BEFORE = (1344, "0da8b7dac9933cd53573fb40fd48548c4d9cfdbe16077b7216af14e6b6d5d804")


def test_plans_below_the_new_routes_are_unchanged():
    """The VJP's plans at U <= 512 (float32) and 384 (bf16), and the
    forward plans the template keeps with its slice of wh held (float32 U
    <= 256, bf16 U <= 384), do not move: the grid layouts change no plan
    there; a forward plan below those widths is the template's, held, or
    the grid layout's."""
    import hashlib
    import json

    rows = []
    for prec, top in (("highest", L.GRID_UNITS_BWD), ("bf16", 384)):
        for u in range(8, top + 1, 8):
            for b in (8, 32, 64):
                for nd in (1, 2):
                    for active in (None, _h100_active):
                        f = L.forward_plan(b, u, nd, prec, active)
                        g = L.backward_plan(b, u, nd, prec, None if active is None else (lambda p: _h100_active(
                            p.cluster)))
                        assert f.grid is not None or f.resident
                        assert g.grid is None
                        rows.append((prec, u, b, nd, active is None, None if f.grid else tuple(f[:6]) + (False,),
                                     tuple(g[:6])))
    assert (len(rows), hashlib.sha256(json.dumps(rows).encode()).hexdigest()) == PLANS_BEFORE


# what the H100 holds at once of the VJP's grid launch, in blocks (PERF.md)
H100_GRID_HELD = {1: 132, 2: 132, 4: 120, 8: 120}


@pytest.mark.parametrize("prec", ["highest", "bf16"])
def test_vjp_grid_plans_past_1024(prec):
    """The VJP's loop from U = 1032 to 2048: the grid layout, at the
    mirror's bytes, its blocks what the card holds in its clusters, its
    kernel U a whole number of its clusters' units; the tile of whᵀ mostly
    streams (float32 at 2048: held in part)."""
    bf16 = prec == "bf16"
    active = lambda q: H100_GRID_HELD[q.grid.cl] if q.grid is not None else _h100_active(q.cluster)
    for u in range(1032, L.MAX_UNITS + 1, 8):
        for b, act in ((32, None), (8, active), (32, active)):
            p = L.backward_plan(b, u, 2, prec, act)
            g = p.grid
            assert g is not None and p.units >= u and p.units % (g.cl * g.us) == 0
            assert p.smem == L.grid_bwd_smem_bytes(g.us, g.cl, g.rows, g.kc, g.kp, g.nres, g.ns, bf16)
            assert p.smem <= L.GRID_SMEM_MAX and g.blocks <= L.GRID_SMS
            if act is not None:
                assert g.blocks <= H100_GRID_HELD[g.cl]
    g = L.backward_plan(32, 2048, 2, prec, active).grid
    assert g.blocks == 128 and g.passes == 1 and 0 < g.nres < g.kp // g.kc


def test_ring_fragments_are_the_mma_layout():
    """``ring_fragments`` read back as a consumer of bf16 chunks addresses
    it (chunk after chunk of ``kc`` k steps of one piece; a lane's four
    values at ((step·NTp + tile)·32 + lane)·4): lane 4·g + t
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
