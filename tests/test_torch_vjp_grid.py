"""The VJP's serial loop in the grid layout (``csrc/lstm.cu``'s
``lstm_bwd_grid_kernel`` and ``lstm_bwd_grid_bf16_kernel``) on the CPU:
what it leaves to Python. ``backward_plan``'s routes by U, batch and mode;
the grid plan's cut, clusters, shared memory and passes over the whole range
of widths and batches, held to the kernel's constants and regions; the
regroup of whᵀ into the blocks' tiles; and the cut's summation order (k
pieces, k chunks dealt to parts, the parts added in order, the cluster's
partials added in rank order) emulated in plain PyTorch from the kernel's
own operand layout, against the plain VJP and the JAX reference."""

import os
import re

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from phones_las_tpu.ops.lstm import _recurrence_pallas_bwd, _recurrence_pallas_residual

from phones_las_torch.ops import lstm as L
from tests.torch_threads import one_thread

one_thread()

# the emulation against the plain VJP: the same float32 products summed in
# another order (k pieces, chunks, parts, ranks), max |d| over max |plain|
# (readings: at most 1.8e-7); in bf16 a sum that lands on the other side of
# a bf16 rounding of dgates moves the rest of the chain by that rounding
# (readings: 0 to 6.1e-5); against JAX: the bounds of
# tests/test_torch_lstm_train.py
EMU_TOL = {"highest": 1e-6, "bf16": 1e-4}
JAX_TOL = {"highest": 1e-5, "bf16": 3e-2}
BATCHES = (1, 8, 32, 64, 256, 4096)
# the H100's answer to plt_lstm_bwd_grid_info (PERF.md, PR 19): blocks it
# holds at once of a cooperative launch in clusters of 2 (132) or of 4 and 8
# (120)
H100_HELD = {1: 132, 2: 132, 4: 120, 8: 120}


def _h100_held(g: L.GridPlan) -> int:
    return H100_HELD[g.cl]


def _cu_constant(name: str) -> int:
    """A constant of csrc/lstm.cu: a literal, or SMEM_MAX less a literal."""
    src = open(os.path.join(os.path.dirname(L.__file__), "..", "csrc", "lstm.cu")).read()
    m = re.search(rf"constexpr (?:int|size_t) {name} = (?:(SMEM_MAX) - )?(\d+);", src)
    return (_cu_constant("SMEM_MAX") - int(m.group(2))) if m.group(1) else int(m.group(2))


# ---- the routes


@pytest.mark.parametrize("prec", ["highest", "bf16"])
@pytest.mark.parametrize("b,nd", [(64, 2), (32, 2), (32, 1), (8, 2), (3, 1)])
def test_backward_plan_routes(b, nd, prec):
    """float32 up to ``GRID_UNITS_BWD`` and bf16 up to ``RING_UNITS_BF16``
    the cluster template (float32 U ≤ 256 and bf16 U ≤ 384 with their
    slices of whᵀ held); past them, to ``MAX_UNITS``, the grid layout, at one
    block an SM or fewer; with the card's answer, in clusters only as far as
    the card holds them."""
    limit = L.GRID_UNITS_BWD if prec == "highest" else L.RING_UNITS_BF16
    for u in (8, 96, 160, 256, 264, 320, 384, 392, 448, 512, 520, 1024, 1032, 1280, 2048):
        for held in (None, lambda p: _h100_held(p.grid) if p.grid is not None else 64):
            p = L.backward_plan(b, u, nd, prec, held)
            assert (p.grid is None) == (u <= limit), (u, p)
            if p.grid is None:
                assert p.cluster in L.CLUSTER_SIZES and p.units % (8 * p.cluster) == 0
                if u <= (L.RESIDENT_UNITS if prec == "highest" else L.RING_UNITS_BF16) and u % 64 == 0:
                    assert p.resident
                continue
            g = p.grid
            assert g.blocks <= L.GRID_SMS and g.blocks == nd * p.units // g.us and p.units >= u
            assert (p.cluster, p.bt, p.ksplit) == (g.cl, g.rows, g.ks)
            assert p.smem == L.grid_bwd_smem_bytes(g.us, g.cl, g.rows, g.kc, g.kp, g.nres, g.ns, prec == "bf16")
            if held is not None and g.cl > 1:
                assert g.blocks <= H100_HELD[g.cl]


def test_backward_plan_layouts():
    """``layout`` forces a route for comparisons ("template" where it fits,
    "grid" at any U); anything else, the rings' name included, is refused,
    as is a U past ``MAX_UNITS``."""
    assert L.backward_plan(32, 256, 2, layout="grid").grid is not None
    assert L.backward_plan(32, 1024, 2, layout="template").grid is None
    assert L.backward_plan(32, 1024, 2, "bf16", layout="template").grid is None
    for bad in ("ring", "held", "clusters", True):
        with pytest.raises(ValueError):
            L.backward_plan(32, 1024, 2, layout=bad)
    with pytest.raises(ValueError):
        L.backward_plan(32, L.MAX_UNITS + 8, 2)


# ---- the grid plan


@pytest.mark.parametrize("prec", ["highest", "bf16"])
@pytest.mark.parametrize("b", BATCHES)
def test_grid_bwd_plan_fits_every_width(b, prec):
    """At every multiple of 8 from 264 to ``MAX_UNITS`` the VJP's grid plan
    fits a block's shared memory and is a cut its kernels take (as
    csrc/lstm.cu's ``bad_grid`` with ``bwd``): units a block a multiple of
    8, whole clusters of 1, 2, 4 or 8 in a direction, every k piece padded to
    whole chunks of every part, the rows of a built instance, two ring slots
    a part; passes of rows past what one launch holds."""
    bf16 = prec == "bf16"
    for u in range(264, L.MAX_UNITS + 1, 8):
        g = L.grid_bwd_plan(b, u, 2, prec, held=_h100_held)
        units = g.us * g.blocks // 2
        nc = g.cl * g.us
        assert units >= u and units % (g.cl * g.us) == 0 and g.us % 8 == 0
        assert g.cl in L.GRID_CLUSTERS and g.blocks <= H100_HELD[g.cl]
        assert g.ks in L.GRID_KS and g.ns % g.ks == 0 and 2 * g.ks <= g.ns <= L.GRID_SLOTS_MAX
        assert g.kc % (16 if bf16 else 4) == 0 and g.kp >= 4 * units // g.cl and g.kp % (g.kc * g.ks) == 0
        assert 0 <= g.nres <= g.kp // g.kc
        if bf16:
            assert g.rows == 16 * g.tile and L.grid_bf16_ntw(nc // 8, g.ks, g.tile)
        else:
            assert g.tile in L.GRID_TILES[False] and g.rows == L.FWD_THREADS // g.ks // (nc // 4) * g.tile
        assert g.passes == -(-b // g.rows)
        assert L.grid_bwd_smem_bytes(g.us, g.cl, g.rows, g.kc, g.kp, g.nres, g.ns, bf16) <= L.GRID_SMEM_MAX


def test_grid_bwd_plan_takes_what_the_card_holds():
    """A cut in clusters only where the card holds its blocks: refused
    clusters (0) leave the single blocks; clusters of 4 and 8 that the card
    holds 120 of are cut again over 120 blocks; without the card's answer
    every cut is taken; at U = 1024 B = 32 on the H100 clusters of 2."""
    refused = lambda g: 0 if g.cl > 1 else 132
    for u, prec in ((1024, "highest"), (1024, "bf16"), (448, "bf16"), (2048, "bf16")):
        assert L.grid_bwd_plan(32, u, 2, prec, held=refused).cl == 1
        g = L.grid_bwd_plan(32, u, 2, prec, held=_h100_held)
        assert g.blocks <= H100_HELD[g.cl]
        for cl in (4, 8):
            c = L.grid_bwd_plan(32, u, 2, prec, held=_h100_held, clusters=(cl,))
            assert c.cl == cl and c.blocks <= 120 and c.us * c.blocks // 2 >= u
    assert L.grid_bwd_plan(32, 1024, 2, "highest", held=_h100_held).cl == 2
    assert L.grid_bwd_units(1024, 2, 4, 120) == (24, 1056)
    assert L.grid_bwd_units(1024, 2, 2) == (16, 1024) and L.grid_bwd_units(448, 2, 8) == (8, 448)


@pytest.mark.parametrize("bf16", [False, True])
def test_grid_bwd_smem_regions(bf16):
    """``grid_bwd_smem_bytes`` region by region, as csrc/lstm.cu's
    ``grid_layout(..., bwd)``: the resident chunks of the tile, the ring's
    slots (a chunk of dgates, and of whᵀ where it streams), the product
    [rows, cl·us], the cluster's partials (cl > 1), two factor tiles and the
    kept dh, dc; the workspace: the barrier's counter, then two dgates
    buffers of every chunk of every piece of each direction."""
    assert (_cu_constant("GRID_WS_HEAD"), _cu_constant("GRID_SLOTS_MAX")) == (L.GRID_WS_HEAD, L.GRID_SLOTS_MAX)
    assert _cu_constant("GRID_SMEM_MAX") == L.GRID_SMEM_MAX and _cu_constant("GRID_BWD_CLOCKS") == L.GRID_BWD_CLOCKS
    us, cl, rows, kc, kp, ns = 16, 2, 32, 64, 2048, 6
    hchunk, wchunk = L.grid_chunk_bytes(cl * us, rows, kc, bf16)
    assert (hchunk, wchunk) == ((kc // 16 * rows // 16 * 512, kc // 16 * cl * us // 8 * 256) if bf16
                                else (rows * (kc + 4) * 4, kc * cl * us * 4))
    fixed = rows * cl * us * 4 + 2 * cl * rows * us * 4 + 2 * ((rows * 7 * us + rows + 3) // 4 * 16) + 2 * rows * us * 4
    nch = kp // kc
    assert L.grid_bwd_smem_bytes(us, cl, rows, kc, kp, nch, ns, bf16) == nch * wchunk + ns * hchunk + fixed
    assert L.grid_bwd_smem_bytes(us, cl, rows, kc, kp, 3, ns, bf16) == 3 * wchunk + ns * (hchunk + wchunk) + fixed
    assert L.grid_bwd_smem_bytes(us, 1, rows, kc, kp, 3, ns, bf16) == (
        3 * wchunk // 2 + ns * (hchunk + wchunk // 2) + fixed - 5 * rows * us * 4)
    g = L.GridPlan(128, us, rows, 2 if bf16 else 4, 2, kc, kp, nch, ns, 1, cl)
    assert L.grid_bwd_ws_bytes(g, 2, bf16) == L.GRID_WS_HEAD + 2 * 2 * cl * nch * hchunk


# ---- the regroup of whᵀ


@pytest.mark.parametrize("prec", ["highest", "bf16"])
@pytest.mark.parametrize("u,nd,b", [(264, 1, 3), (448, 2, 32), (1024, 2, 32), (2048, 2, 8)])
def test_grid_wht_round_trip(u, nd, b, prec):
    """``grid_wht`` (block g·cl + r: the gate columns of the unit run r in
    its k order 4·j + gate, the output units of group g; bf16 in the tensor
    cores' B fragment order) round-trips to wh exactly at every cluster
    size, and its float32 element (k = 4·j + gate, n) is wh's [g·cl·us + n,
    gate·U + r·U/cl + j]."""
    for cl in L.GRID_CLUSTERS:
        g = L.grid_bwd_plan(b, u, nd, prec, clusters=(cl,))
        units = g.us * g.blocks // nd
        wh = torch.from_numpy(np.random.RandomState(u + cl).randn(units, 4 * units).astype(np.float32))
        wg = L.grid_wht(wh, g, prec)
        want = wh if prec == "highest" else wh.to(torch.bfloat16)
        assert wg.is_contiguous() and wg.dtype == want.dtype
        assert torch.equal(L.ungrid_wht(wg, units, g), want)
        if prec == "highest":
            ug, piece = cl * g.us, units // cl
            assert wg.shape == (units // g.us, g.kp, ug)
            blk = units // g.us - 1
            grp, r = divmod(blk, cl)
            j, gate, n = piece - 1, 2, ug - 1
            assert torch.equal(wg[blk, 4 * j + gate, n], wh[grp * ug + n, gate * units + r * piece + j])
            assert not wg[:, 4 * piece:].any()


# ---- the summation order, emulated


def _factors(xp, wh, hprev, cprev, forget_bias, prec):
    """What kernel 1 (the gates GEMM's epilogue) gives every step: the four
    gate factors Fi, Ff, Fg, Fo [T, B, 4U] and A, sf [T, B, U]."""
    gates = xp + torch.matmul(L._dot_operand(hprev.float(), prec), L._dot_operand(wh, prec))
    gi, gf, gg, go = torch.chunk(gates, 4, dim=-1)
    cp = cprev.float()
    si, sf, sg, so = torch.sigmoid(gi), torch.sigmoid(gf + forget_bias), torch.tanh(gg), torch.sigmoid(go)
    tch = torch.tanh(sf * cp + si * sg)
    fac = torch.cat([sg * si * (1 - si), cp * sf * (1 - sf), si * (1 - sg * sg), tch * so * (1 - so)], -1)
    return fac, so * (1 - tch * tch), sf


def grid_vjp_emulated(xp, mask, wh, hprev, cprev, dout, dh, dc, forget_bias, reverse, prec, plan: L.GridPlan):
    """One direction of the VJP with the grid loop's cut in plain PyTorch →
    (dxp, dwh): each step's dgates of piece r in its k order (4·j + gate),
    padded to ``plan.kp``, multiplied by each block's tile from
    ``grid_wht``, its chunks of ``kc`` k dealt to the parts (chunk i to part
    i mod ks), each part's chunks summed in k order, the parts added in part
    order; a unit's dh the kept (1 - m)·dh plus the cluster's partials in
    rank order; dWh as the plain version's product."""
    t, b, four_u = xp.shape
    u = four_u // 4
    cl, us = plan.cl, plan.us
    ug, nblk, piece = cl * us, u // us, u // cl
    w = L.ungrid_wht(L.grid_wht(wh, plan, prec), u, plan).float()
    w = w.reshape(u // ug, ug, 4, cl, piece).permute(0, 3, 4, 2, 1).reshape(nblk, 4 * piece, ug)
    w = torch.nn.functional.pad(w, (0, 0, 0, plan.kp - 4 * piece))  # [blocks, kp, ug]
    fac, a_fac, sf = _factors(xp, wh, hprev, cprev, forget_bias, prec)
    nch = plan.kp // plan.kc
    dxp = torch.zeros(t, b, four_u)
    keep, dc = dh.float(), dc.float()
    acc = None  # the last step's partial of every block: [blocks, b, ug]
    for tt in (range(t) if reverse else range(t - 1, -1, -1)):
        cur = keep
        if acc is not None:
            parts = acc.reshape(u // ug, cl, b, ug)
            for r in range(cl):  # in rank order
                cur = cur + parts[:, r].permute(1, 0, 2).reshape(b, u)
        m = mask[tt][:, None]
        dh_tot = m * (dout[tt] + cur)
        dc_new = m * dc + dh_tot * a_fac[tt]
        fi, ff, fg, fo = torch.chunk(fac[tt], 4, dim=-1)
        dg = torch.cat([dc_new * fi, dc_new * ff, dc_new * fg, dh_tot * fo], -1)
        keep = (1.0 - m) * cur
        dc = (1.0 - m) * dc + dc_new * sf[tt]
        dxp[tt] = dg
        dgk = L._dot_operand(dg, prec).reshape(b, 4, cl, piece).permute(2, 0, 3, 1).reshape(cl, b, 4 * piece)
        dgk = torch.nn.functional.pad(dgk, (0, plan.kp - 4 * piece))[torch.arange(nblk) % cl]  # [blocks, b, kp]
        total = None
        for p in range(plan.ks):
            s = torch.zeros(nblk, b, ug)
            for i in range(p, nch, plan.ks):
                for k in range(i * plan.kc, (i + 1) * plan.kc):
                    s = s + dgk[:, :, k, None] * w[:, None, k, :]
            total = s if total is None else total + s
        acc = total
    dwh = torch.matmul(L._dot_operand(hprev.float(), prec).reshape(-1, u).t(),
                       L._dot_operand(dxp, prec).reshape(-1, four_u))
    return dxp, dwh


def _rel(got, want) -> float:
    return float((got.double() - want.double()).abs().max()) / max(float(want.double().abs().max()), 1e-30)


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("prec", ["highest", "bf16"])
@pytest.mark.parametrize("u,sms,cl", [(32, 4, 1), (48, 3, 1), (64, 8, 2), (96, 12, 2), (64, 8, 4)])
def test_grid_vjp_emulation_matches_plain_and_jax(u, sms, cl, prec, reverse):
    """The VJP's grid cut on a card of ``sms`` SMs (several blocks and
    groups, C = 1, 2 and 4, k chunks over several parts, a padded k
    piece), emulated from the kernel's operand layout, against the plain
    VJP within ``EMU_TOL`` and against JAX's Pallas kernel in interpret
    mode."""
    rs = np.random.RandomState(u + sms + cl)
    t, b = 7, 5
    xp = rs.randn(t, b, 4 * u).astype(np.float32)
    wh = (rs.randn(u, 4 * u) / np.sqrt(u)).astype(np.float32)
    lengths = np.array([t, 1, 4, t, 2])
    mask = (np.arange(t)[:, None] < lengths[None, :]).astype(np.float32)
    dout = rs.randn(t, b, u).astype(np.float32)
    dh, dc = rs.randn(b, u).astype(np.float32), rs.randn(b, u).astype(np.float32)
    plan = L.grid_bwd_plan(b, u, 1, prec, sms=sms, clusters=(cl,))
    assert plan.blocks > 1 and plan.cl == cl and L.grid_bwd_units(u, 1, cl, sms)[1] == u
    tx, tm, tw = torch.from_numpy(xp), torch.from_numpy(mask), torch.from_numpy(wh)
    (_, hprev, cprev, _, _), = L.recurrence_residual_plain([tx], tm, [tw], 1.0, [reverse], prec)
    cots = (torch.from_numpy(dout), torch.from_numpy(dh), torch.from_numpy(dc))
    small = plan._replace(kc=8 if prec == "highest" else 16, ks=2, kp=L.round_up(4 * u // cl, 32) + 32)
    (want,) = L.recurrence_bwd_plain([tx], tm, [tw], [hprev], [cprev], *([c] for c in cots), 1.0, [reverse], prec)
    for g in (plan, small):
        got = grid_vjp_emulated(tx, tm, tw, hprev, cprev, *cots, 1.0, reverse, prec, g)
        for x, y in zip(got, want):
            assert _rel(x, y) <= EMU_TOL[prec], (g, _rel(x, y))
        assert float((got[0] * (1.0 - tm)[:, :, None]).abs().max()) == 0.0  # masked steps pass no gradient
    ref = _recurrence_pallas_bwd(jnp.asarray(xp), jnp.asarray(mask), jnp.asarray(wh),
                                 jnp.asarray(hprev.float().numpy()).astype(jnp.bfloat16 if prec == "bf16" else jnp.float32),
                                 jnp.asarray(cprev.float().numpy()).astype(jnp.bfloat16 if prec == "bf16" else jnp.float32),
                                 jnp.asarray(dout), jnp.asarray(dh), jnp.asarray(dc), reverse=reverse, interpret=True,
                                 prec=prec)
    for x, r in zip(got, ref):
        assert _rel(x, torch.from_numpy(np.asarray(r, np.float32))) <= JAX_TOL[prec]


def test_wrappers_count_vjp_grid_launches():
    """The VJP's wrapper counts its loop's launches through the grid layout
    (a launch a pass of rows, of them in bf16), which ``chip_smoke.py``
    reads."""
    assert L.recurrence_bwd.grid_launches == 0 and L.recurrence_bwd.bf16_grid_launches == 0
    plan = L.backward_plan(130, 1024, 2, "bf16", lambda p: _h100_held(p.grid) if p.grid is not None else 64)
    assert plan.grid is not None and plan.grid.passes > 1

    class Fn:
        launches = bf16_launches = grid_launches = bf16_grid_launches = 0

    L._count(Fn, "bf16", plan)
    assert (Fn.launches, Fn.bf16_launches, Fn.grid_launches, Fn.bf16_grid_launches) == (1, 1, plan.grid.passes,
                                                                                          plan.grid.passes)
    L._count(Fn, "highest", plan)
    assert (Fn.launches, Fn.bf16_launches, Fn.grid_launches, Fn.bf16_grid_launches) == (
        2, 1, 2 * plan.grid.passes, plan.grid.passes)
