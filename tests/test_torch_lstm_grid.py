"""The listener's grid layout (``csrc/lstm.cu``'s ``lstm_grid_kernel`` and
``lstm_grid_bf16_kernel``) on the CPU: what it leaves to Python. The
forward plan's routes by U, batch and mode; the grid plan's cut, shared
memory and passes over the whole range of widths and batches, held to the
kernel's constants and regions; the regroup of ``wh`` by blocks and the
h buffers' order (float32 k-major; bf16 wgmma's canonical K-major layout
with the 128-byte swizzle, held to the swizzle's definition on byte
addresses); and the layout's summation order (its k chunks dealt to
parts, bf16 in the wgmma's k steps of 16, the parts added in order)
emulated in plain PyTorch from the kernel's own operand layouts, against
the plain recurrence and the JAX reference."""

import os
import re

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from phones_las_tpu.ops.lstm import _recurrence_pallas_residual, _recurrence_xla

from phones_las_torch.ops import lstm as L
from phones_las_torch.ops import padding as P
from tests.torch_threads import one_thread

one_thread()

# the emulation against the plain loop: the same float32 products summed in
# another order (k chunks, parts); against JAX: the bounds of
# tests/test_torch_lstm.py
EMU_TOL = 1e-6
JAX_TOL = {"highest": 1e-5, "bf16": 2e-2}
JAX_RES_TOL = {"highest": 1e-5, "bf16": 3e-2}
BATCHES = (1, 8, 32, 64, 256, 4096)


def _cu_source() -> str:
    return open(os.path.join(os.path.dirname(L.__file__), "..", "csrc", "lstm.cu")).read()


def _cu_constant(name: str) -> int:
    """A constant of csrc/lstm.cu: a literal, or SMEM_MAX less a literal."""
    m = re.search(rf"constexpr (?:int|size_t) {name} = (?:(SMEM_MAX) - )?(\d+);", _cu_source())
    return (_cu_constant("SMEM_MAX") - int(m.group(2))) if m.group(1) else int(m.group(2))


# ---- the routes


@pytest.mark.parametrize("prec", ["highest", "bf16"])
@pytest.mark.parametrize("b,nd", [(64, 2), (32, 2), (32, 1), (8, 2), (3, 1)])
def test_forward_plan_routes(b, nd, prec):
    """Up to the resident widths (float32 ``RESIDENT_UNITS`` = 256, bf16
    ``RING_UNITS_BF16`` = 384) the template, its slice of wh held by a
    cluster, where a cut of U holds it (bf16 264 = 33 · 8 has none: the
    grid layout); past them, to ``MAX_UNITS``, the grid layout, at one block
    an SM or fewer; ``layout="grid"`` forces the grid layout, and nothing
    else is a route."""
    limit = L.RESIDENT_UNITS if prec == "highest" else L.RING_UNITS_BF16
    for u in (8, 96, 160, 256, 264, 320, 384, 392, 448, 512, 1024, 1032, 1280, 2048):
        p = L.forward_plan(b, u, nd, prec)
        assert (p.grid is None) == (u <= limit and (u, prec) != (264, "bf16"))
        if p.grid is None:
            assert p.units % (8 * p.cluster) == 0
            continue
        g = p.grid
        assert g.blocks <= L.GRID_SMS and g.blocks == nd * p.units // g.us and p.units - u < g.us
        assert (p.cluster, p.bt, p.ksplit) == (1, g.rows, g.ks)
        assert p.resident == (g.nres == g.kp // g.kc) and g.passes == -(-b // g.rows)
    assert L.forward_plan(b, 256, nd, prec, layout="grid").grid is not None
    assert L.forward_plan(b, 1024, nd, prec, layout="grid", sms=64).grid.blocks <= 64
    for bad in ("ring", "held", "template"):
        with pytest.raises(ValueError):
            L.forward_plan(b, 1024, nd, prec, layout=bad)


def test_grid_units_cut_the_card():
    """The fewest units a block (a multiple of 8) whose blocks the card
    holds, the kernel U rounded up to them: LAS-4-1024's layers are 128
    blocks of 16 units; U = 2048 128 of 32; one direction of 1024 128 of 8."""
    assert L.grid_units(1024, 2) == (16, 1024)
    assert L.grid_units(1024, 1) == (8, 1024)
    assert L.grid_units(2048, 2) == (32, 2048)
    assert L.grid_units(512, 2) == (8, 512)
    assert L.grid_units(1032, 2) == (16, 1040)
    assert L.grid_units(1280, 2) == (24, 1296)
    for u in range(8, L.MAX_UNITS + 1, 8):
        for nd in (1, 2):
            us, units = L.grid_units(u, nd)
            assert us % 8 == 0 and units % us == 0 and 0 <= units - u < us
            assert nd * units // us <= L.GRID_SMS
            assert us == 8 or nd * -(-u // (us - 8)) > L.GRID_SMS  # no smaller run fits the card


# ---- the plan's bytes and passes


def _declared_grid_bytes(g: L.GridPlan, bf16: bool) -> int:
    """A block's shared memory as ``fwd_grid_layout`` of csrc/lstm.cu
    declares it, region by region: the resident chunks of wh, the ring's
    slots (h, and wh where some streams), the product (rows padded by 4
    floats), the xp tile and mask (rounded to 16 bytes), c, h and the step's
    out; bf16 on wgmma also the 1024 bytes that align the region to the
    swizzle's atoms."""
    nc, nch, w = 4 * g.us, g.kp // g.kc, 2 if bf16 else 4
    wgmma = bf16 and not g.mma
    hchunk, wchunk = g.rows * g.kc * w, g.kc * (-(-nc // 64) * 64 if wgmma else nc) * w  # wgmma: whole M tiles
    slot = hchunk + (wchunk if g.nres < nch else 0)
    regions = [g.nres * wchunk, g.ns * slot, g.rows * (nc + 4) * 4, (g.rows * nc + g.rows + 3) // 4 * 16,
               g.rows * g.us * 4, g.rows * g.us * 4, g.rows * g.us * 4, 1024 if wgmma else 0]
    return sum(regions)


@pytest.mark.parametrize("b", BATCHES)
@pytest.mark.parametrize("prec", ["highest", "bf16"])
def test_grid_plans_fit_every_width(prec, b):
    """Every multiple of 8 from 264 to 2048, both directions and one, has a
    grid plan whose shared memory is the kernel's regions and fits 232,448
    bytes less the static barriers; its cut is one the kernels take (float32:
    k parts of 1, 2, 4 or 8 with two ring slots a part or more, chunks of 32,
    64 or 128 k rows, 4 or 8 rows a thread over a part's row tiles of 8
    columns a thread; bf16 on wgmma: chunks of 128, one part with an even
    number of M tiles of 64 gate columns (zero rows past them) or two (a
    warpgroup each), a built instance of rows and M tiles a warpgroup; bf16
    on mma.sync: k parts of 1, 2, 4 or 8, 16-row tiles, chunks of a multiple
    of 16 k rows, a built instance of a warp's n-tiles; two ring slots a
    part or more, at most 16; chunks cutting the padded k range evenly among
    the parts); the workspace is the readiness counters and two h buffers;
    a batch past the rows one launch holds runs in passes of them."""
    bf16 = prec == "bf16"
    assert (L.SMEM_MAX, L.GRID_SLOTS_MAX) == tuple(_cu_constant(n) for n in ("SMEM_MAX", "GRID_SLOTS_MAX"))
    assert L.GRID_SMEM_MAX == _cu_constant("GRID_SMEM_MAX") == 232448 - 1024
    for u in range(264, L.MAX_UNITS + 1, 8):
        for nd in (1, 2):
            p = L.forward_plan(b, u, nd, prec, layout="grid")
            g = p.grid
            assert p.smem == _declared_grid_bytes(g, bf16) <= L.GRID_SMEM_MAX
            assert g.ns <= L.GRID_SLOTS_MAX
            assert g.kp >= p.units and g.kp % (g.kc * g.ks) == 0 and 0 <= g.nres <= g.kp // g.kc
            assert g.ns % g.ks == 0 and g.ns >= 2 * g.ks
            assert g.cl == 1
            if bf16 and g.mma:
                assert g.ks in (1, 2, 4, 8) and g.kc % 16 == 0 and g.tile in (1, 2, 4) and g.rows == 16 * g.tile
                assert L.grid_bf16_ntw(g.us // 2, g.ks, g.tile) in (2, 4, 8)
            elif bf16:
                mt = -(-g.us // 16)  # M tiles of 64 gate columns
                assert g.kc == 128 and g.ks in (1, 2) and (g.ks > 1 or mt % 2 == 0)
                assert g.tile == (mt // 2 if g.ks == 1 else mt) and g.tile in (1, 2, 4)
                assert g.rows in (16, 32, 64, 128) and g.tile * g.rows <= 128
            else:
                assert g.ks in (1, 2, 4, 8) and g.kc in (32, 64, 128)
                assert g.tile in (4, 8) and g.rows == L.FWD_THREADS // g.ks // (g.us // 2) * g.tile
            assert g.passes == -(-b // g.rows) and (g.passes == 1) == (b <= g.rows)
            nch = g.kp // g.kc
            assert L.grid_ws_bytes(g, nd, bf16) == -(-4 * nd * nch // 128) * 128 + 2 * nd * nch * (
                g.rows * g.kc * (2 if bf16 else 4))
    assert L.forward_plan(4096, 1024, 2, prec).grid.passes > 1


def test_grid_plan_keeps_wh_where_it_fits():
    """LAS-4-1024's layers: in bf16 the whole of each block's slice of wh
    fits in shared memory (16.8 MB over 128 SMs: a layout of each route
    holds it), though the plan may stream part of it where fewer, larger
    chunks of h read faster (the wgmma route at B = 64); in float32 (33.5
    MB) all or part of it streams each step beside h."""
    for b in (8, 32, 64):
        plans = L.grid_candidates(b, 1024, 2, "bf16")
        for mma in (False, True):
            assert any(p.resident_share == 1.0 for p in plans if p.mma == mma)
        assert 0.0 < L.grid_plan(b, 1024, 2, "bf16").resident_share <= 1.0
        assert L.grid_plan(b, 1024, 2, "highest").resident_share < 1.0
    assert L.grid_plan(64, 512, 2, "highest").resident_share == 1.0


# ---- the regroup of wh


def _swizzled(offset: torch.Tensor) -> torch.Tensor:
    """The 128-byte swizzle on byte offsets from a 1024-byte boundary, as
    the hardware applies it to shared addresses: bits 4–6 XOR bits 7–9."""
    return offset ^ (((offset >> 7) & 7) << 4)


@pytest.mark.parametrize("prec", ["highest", "bf16"])
@pytest.mark.parametrize("u,nd,b", [(264, 1, 3), (512, 2, 64), (1024, 2, 32), (1296, 2, 32), (2048, 2, 8)])
def test_grid_wh_round_trip(u, nd, b, prec):
    """``grid_wh`` (a block's [unit][gate] columns, k padded to the plan's
    range; bf16 on wgmma the A operand, K-major chunks of 64 k, zero rows up
    to whole M tiles of 64, with the 128-byte swizzle; bf16 on mma.sync the
    B fragments of m16n8k16) round-trips to wh exactly; block s's column 4j + g is
    wh's column g·U + s·us + j, and in bf16 it lies where the swizzle of
    its byte address puts it."""
    for g in _both_routes(b, u, nd, prec):
        units = g.us * g.blocks // nd
        wh = torch.from_numpy(np.random.RandomState(u).randn(units, 4 * units).astype(np.float32))
        wg = L.grid_wh(wh, g, prec)
        want = wh if prec == "highest" else wh.to(torch.bfloat16)
        assert wg.is_contiguous() and wg.dtype == want.dtype
        assert torch.equal(L.ungrid_wh(wg, units, g), want)
        s, j, gate = units // g.us - 1, g.us - 1, 2
        col = wh[:, gate * units + s * g.us + j]
        k = torch.arange(units)
        if prec == "highest":
            assert wg.shape == (units // g.us, g.kp, 4 * g.us)
            assert torch.equal(wg[s, :units, 4 * j + gate], col)
            assert not wg[:, units:].any()
        elif g.mma:  # B fragments: k step, n-tile, lane 4·(col mod 8) + (k mod 8) / 2, (k mod 16) / 8, k mod 2
            m, kk = 4 * j + gate, k % 16
            at = (((k // 16) * g.us // 2 + m // 8) * 32 + (m % 8) * 4 + (kk % 8) // 2) * 4 + 2 * (kk // 8) + k % 2
            assert wg.shape == (units // g.us, g.kp * 4 * g.us) and torch.equal(wg[s][at], col.to(torch.bfloat16))
        else:
            ncp = -(-4 * g.us // 64) * 64  # the A operand's rows: the block's gate columns, zero rows to M tiles
            assert wg.shape == (units // g.us, g.kp * ncp)
            m = 4 * j + gate  # the row of the A operand: the block's gate column
            byte = (k // 64) * (ncp * 128) + _swizzled(m * 128 + (k % 64) * 2)
            assert torch.equal(wg[s][byte // 2], col.to(torch.bfloat16))


def _both_routes(b, u, nd, prec):
    """The plan, and in bf16 the cheapest plan of each route (wgmma and
    mma.sync) at the shape."""
    if prec != "bf16":
        return [L.grid_plan(b, u, nd, prec)]
    plans = L.grid_candidates(b, u, nd, prec)
    return [min((p for p in plans if p.mma == mma), key=lambda p: p.passes * L._grid_step_cycles(p, True))
            for mma in (False, True)]


@pytest.mark.parametrize("prec", ["highest", "bf16"])
@pytest.mark.parametrize("u,b", [(264, 3), (448, 64), (1024, 32), (1296, 100)])
def test_grid_h_round_trip(u, b, prec):
    """``grid_h`` (a pass's h as the kernels' ``put_h`` stores it in an h
    buffer: float32 chunks k-major, [kc][rows]; bf16 on wgmma the B operand,
    K-major chunks of 64 with the 128-byte swizzle; bf16 on mma.sync the A
    fragments of m16n8k16) round-trips to h (bf16: rounded), the k padding
    zero, and each (row, k) lies where the kernels put it (wgmma: where the
    swizzle of its byte address puts it)."""
    for g in _both_routes(b, u, 2, prec):
        units = g.us * g.blocks // 2
        h = torch.from_numpy(np.random.RandomState(u + b).randn(g.rows, units).astype(np.float32))
        hg = L.grid_h(h, g, prec)
        want = h if prec == "highest" else h.to(torch.bfloat16)
        assert hg.is_contiguous() and hg.dtype == want.dtype and hg.numel() == g.rows * g.kp
        assert torch.equal(L.ungrid_h(hg, units, g), want)
        row, k = g.rows - 1, torch.arange(units)
        if prec == "highest":
            at = k * g.rows + row  # chunk after chunk of [kc][rows]: k-major over the whole range
        elif g.mma:  # A fragments: k step, row tile, lane 4·(row mod 8) + (k mod 8) / 2, register, k mod 2
            r, kk = row % 16, k % 16
            at = ((((k // 16) * (g.rows // 16) + row // 16) * 32 + (r % 8) * 4 + (kk % 8) // 2) * 4 + r // 8
                  + 2 * (kk // 8)) * 2 + k % 2
        else:
            at = ((k // 64) * (g.rows * 128) + _swizzled(row * 128 + (k % 64) * 2)) // 2
        assert torch.equal(hg[at], want[row])
        assert not L.ungrid_h(hg, g.kp, g)[:, units:].any()


# ---- the summation order, emulated


def grid_recurrence_emulated(xp, mask, wh, forget_bias, reverse, prec, plan: L.GridPlan):
    """One direction of the grid layout in plain PyTorch → (out, hprev,
    cprev, h, c): each block's product from ``grid_wh``'s slice and each
    step's h read back from the h buffer as ``grid_h`` lays it out (bf16
    rounded there), its k chunks of ``kc`` rows dealt to the parts (chunk i
    to part i mod ks), each part's chunks summed in k order (float32 one k
    at a time, as the FMAs; bf16 a k step of 16 at a time, as wgmma), the
    parts added in part order, then xp; the cell update as the kernel's
    (float32 state, residuals in wh's type)."""
    t, b, four_u = xp.shape
    u = four_u // 4
    us, nblk = plan.us, u // plan.us
    bf16 = prec == "bf16"
    w = L.ungrid_wh(L.grid_wh(wh, plan, prec), u, plan).float()
    w = torch.nn.functional.pad(w.reshape(u, 4, nblk, us).permute(2, 0, 3, 1).reshape(nblk, u, 4 * us),
                                (0, 0, 0, plan.kp - u))  # [blocks, kp, [unit][gate]]
    nch = plan.kp // plan.kc
    step_k = 16 if bf16 else 1
    h = torch.zeros(b, u)
    c = torch.zeros(b, u)
    out = torch.zeros(t, b, u)
    rdt = torch.bfloat16 if bf16 else torch.float32
    hprev, cprev = torch.zeros(t, b, u, dtype=rdt), torch.zeros(t, b, u, dtype=rdt)
    rows = plan._replace(rows=L.round_up(b, 16))  # a pass of whole 16-row tiles, zero rows past the batch
    for tt in (range(t - 1, -1, -1) if reverse else range(t)):
        hprev[tt], cprev[tt] = h.to(rdt), c.to(rdt)
        hp = torch.nn.functional.pad(h, (0, 0, 0, rows.rows - b))
        hk = L.ungrid_h(L.grid_h(hp, rows, prec), plan.kp, rows).float()[:b]
        parts = []
        for p in range(plan.ks):
            acc = torch.zeros(nblk, b, 4 * us)
            for i in range(p, nch, plan.ks):
                for k in range(i * plan.kc, (i + 1) * plan.kc, step_k):
                    acc = acc + hk[None, :, k:k + step_k] @ w[:, k:k + step_k, :]
            parts.append(acc)
        s = parts[0]
        for acc in parts[1:]:
            s = s + acc
        s = s.reshape(nblk, b, us, 4).permute(1, 3, 0, 2).reshape(b, 4 * u)  # back to wh's gate-major columns
        h_new, c_new = L._cell_math(xp[tt] + s, c, forget_bias)
        m = mask[tt][:, None]
        h, c = m * h_new + (1.0 - m) * h, m * c_new + (1.0 - m) * c
        out[tt] = m * h_new
    return out, hprev, cprev, h, c


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("prec", ["highest", "bf16"])
@pytest.mark.parametrize("u,sms", [(48, 2), (64, 4), (96, 16)])
def test_grid_emulation_matches_plain_and_jax(u, sms, prec, reverse):
    """The grid layout's cut on a card of ``sms`` SMs (several blocks, k
    chunks over several parts, a padded k range), emulated from the
    kernel's operand layouts, against the plain recurrence within
    ``EMU_TOL`` (bf16: the residuals within the rounding of bf16) and
    against JAX's XLA scan and its Pallas kernel in interpret mode."""
    rs = np.random.RandomState(u + sms)
    t, b = 7, 5
    xp = rs.randn(t, b, 4 * u).astype(np.float32)
    wh = (rs.randn(u, 4 * u) / np.sqrt(u)).astype(np.float32)
    lengths = np.array([t, 1, 4, t, 2])
    mask = (np.arange(t)[:, None] < lengths[None, :]).astype(np.float32)
    plan = L.grid_plan(b, u, 1, prec, sms=sms)
    units = plan.us * plan.blocks  # the kernel's U: u, or zero padded to the blocks' runs
    assert plan.blocks > 1 and 0 <= units - u < plan.us
    txp, tmask, twh = torch.from_numpy(xp), torch.from_numpy(mask), torch.from_numpy(wh)
    emulated = lambda g: [x[..., :u] for x in grid_recurrence_emulated(
        P.pad_gates(txp, u, units), tmask, P.pad_lstm_wh(twh, units), 1.0, reverse, prec, g)]
    kc = 128 if prec == "bf16" and not plan.mma else 32
    small = plan._replace(kc=kc, ks=2, kp=L.round_up(units, 2 * kc))  # several chunks a part
    for g in (plan, small):
        got = emulated(g)
        (plain,) = L.recurrence_residual_plain([txp], tmask, [twh], 1.0, [reverse], prec)
        for i, (x, y) in enumerate(zip(got, plain)):
            tol = 1e-2 if prec == "bf16" and i in (1, 2) else EMU_TOL
            np.testing.assert_allclose(x.float().numpy(), y.float().numpy(), rtol=0, atol=tol)
    ref = _recurrence_pallas_residual(jnp.asarray(xp), jnp.asarray(mask), jnp.asarray(wh), reverse=reverse,
                                      interpret=True, prec=prec)
    xla_out, (xla_h, xla_c) = _recurrence_xla(jnp.asarray(xp), jnp.asarray(mask), jnp.asarray(wh), 1.0, reverse, prec)
    for i, (x, r) in enumerate(zip(got, ref)):
        tol = JAX_RES_TOL[prec] if i in (1, 2) else JAX_TOL[prec]
        np.testing.assert_allclose(x.float().numpy(), np.asarray(r, np.float32), rtol=tol, atol=tol)
    for x, r in zip((got[0], got[3], got[4]), (xla_out, xla_h, xla_c)):
        np.testing.assert_allclose(x.numpy(), np.asarray(r, np.float32), rtol=JAX_TOL[prec], atol=JAX_TOL[prec])


def test_wrappers_count_grid_launches():
    """The three forward wrappers and the VJP's carry the grid layouts'
    counters, which ``chip_smoke.py`` reads (a launch a pass of rows, of
    them in bf16, and the forward's of those on wgmma); no wrapper counts a
    ring, which no kernel has now."""
    for fn in (L.recurrence, L.recurrence_residual, L.bidir_recurrence, L.recurrence_bwd):
        assert fn.grid_launches == 0 and fn.bf16_grid_launches == 0 and not hasattr(fn, "ring_launches")
        assert not hasattr(fn, "bf16_ring_launches")
        assert getattr(fn, "wgmma_grid_launches", 0) == 0
    assert not hasattr(L.recurrence_bwd, "wgmma_grid_launches")
    g = L.grid_plan(200, 448, 2, "bf16")
    plan = L.forward_plan(200, 448, 2, "bf16")
    assert plan.grid == g and g.passes > 1 and g.mma

    class Fn:
        launches = bf16_launches = grid_launches = bf16_grid_launches = wgmma_grid_launches = 0

    L._count(Fn, "bf16", plan)
    assert (Fn.launches, Fn.bf16_launches, Fn.grid_launches, Fn.bf16_grid_launches) == (1, 1, g.passes, g.passes)
    assert Fn.wgmma_grid_launches == 0
    wg = L.forward_plan(130, 1024, 2, "bf16")
    assert not wg.grid.mma and wg.grid.passes > 1
    L._count(Fn, "bf16", wg)
    L._count(Fn, "highest", L.forward_plan(130, 1024, 2, "highest"))
    assert Fn.wgmma_grid_launches == wg.grid.passes and Fn.bf16_grid_launches == g.passes + wg.grid.passes
