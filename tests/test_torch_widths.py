"""The reference's width flags on the port's kernels, on the CPU.

The listener kernels take every U that is a multiple of 8 up to
``MAX_UNITS`` = 2048 (the forward past 256 in float32 and 384 in bf16 on
the grid layout; the VJP's loop past 256 in float32 streaming each block's
slice of wh from L2, float32 past 512 and bf16 past 384 on its own grid
layout),
the decoder kernel the LAS-4-1024 speller (U = A = 1024, M = 2048) in its
streamed layout, and the wrappers pad any other width with zeros. Here:
the plans over that whole range; the streamed cluster decomposition
emulated in plain PyTorch (as ``tests/test_torch_cluster_layout.py`` and
``tests/test_torch_lstm_bwd_layout.py`` emulate the resident one) against
the plain versions, JAX's XLA scan, the Pallas kernels in interpret mode
and ``jax.grad``; the padding against the unpadded plain versions and JAX;
and a W1024 model (one listener layer, short inputs) against JAX's encoder,
greedy decoder and loss from the same weights."""

import dataclasses
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from phones_las_tpu.cli.common import resolve_preset as jax_resolve_preset
from phones_las_tpu.decode import greedy_decode as jax_greedy_decode
from phones_las_tpu.models.las import compute_loss as jax_compute_loss
from phones_las_tpu.models.las import encode as jax_encode
from phones_las_tpu.models.las import init_las as jax_init_las
from phones_las_tpu.ops.lstm import _recurrence_pallas_bwd, _recurrence_pallas_residual, _recurrence_xla

from phones_las_torch.cli.common import resolve_preset
from phones_las_torch.data.timit import _GRAPHEMES
from phones_las_torch.data.vocab import Vocab
from phones_las_torch.decode import greedy_decode
from phones_las_torch.decode import fused_greedy as FG
from phones_las_torch.models import las as LAS
from phones_las_torch.models.speller import SpellerConfig
from phones_las_torch.ops import lstm as L
from phones_las_torch.ops import padding as P
from phones_las_torch.utils.param_io import params_from_numpy
from tests.test_torch_cluster_layout import cluster_recurrence_emulated
from tests.test_torch_lstm_bwd_layout import cluster_bwd_emulated
from tests.test_torch_lstm_grid import grid_recurrence_emulated
from tests.torch_threads import one_thread

one_thread()

# the emulation against the plain loop: float32 sums of up to 1024 terms cut
# into other slices (bf16: one bf16 step of a rounded h, as the resident
# emulation's bound); against JAX and the Pallas kernels: the bounds of
# tests/test_torch_lstm.py and tests/test_torch_lstm_bwd_layout.py
EMU_TOL = {"highest": 1e-5, "bf16": 1e-2}
JAX_TOL = {"highest": 1e-5, "bf16": 2e-2}
JAX_RES_TOL = {"highest": 1e-5, "bf16": 3e-2}
VJP_TOL = {"highest": 1e-5, "bf16": 3e-2}  # max |d| over max |want|
# padded-then-sliced against unpadded: the same sums plus exact zeros, which
# the CPU's BLAS blocks by another k (a few float32 roundings: max |d| over
# max |want|)
PAD_TOL = 1e-6
LOSS_RTOL = 1e-5

T, B = 6, 3
W1024 = {"encoder_units": 1024, "decoder_units": 1024, "attention_units": 1024}
W100 = {"encoder_units": 100, "decoder_units": 36, "attention_units": 60, "embedding_dim": 30}


# ---- the plans over the whole range


@pytest.mark.parametrize("prec", ["highest", "bf16"])
@pytest.mark.parametrize("which", ["forward", "backward"])
def test_plans_take_every_width_to_1024(which, prec):
    """Every U that is a multiple of 8 from 8 to ``MAX_UNITS`` (2048) has a
    plan in both modes, at the serving and the training batch: its bytes
    are the layout's mirror and fit a block, its kernel U is U or (a prime
    number of 8-unit slices past what one block holds, or a cut of a grid
    layout that U does not divide) a wider multiple of 8·C (the grid
    layouts': of a block's units, of a cluster's); the forward takes the
    grid layout past float32 ``RESIDENT_UNITS`` and bf16 ``RING_UNITS_BF16``
    and below them where no cluster cut holds its slices, the VJP's loop its
    grid layout past float32 ``GRID_UNITS_BWD`` and bf16
    ``RING_UNITS_BF16``, nothing else does; past ``MAX_UNITS``, and for a U
    that is no multiple of 8, the plans raise."""
    fwd = which == "forward"
    plan_fn = L.forward_plan if fwd else L.backward_plan
    bf16 = prec == "bf16"
    streamed = 0
    for u in range(8, L.MAX_UNITS + 1, 8):
        for b in (32, 64):
            p = plan_fn(b, u, 2, prec)
            g = p.grid
            if fwd and g is not None:
                assert p.smem == L.grid_smem_bytes(g.us, g.rows, g.kc, g.kp, g.nres, g.ns, bf16, g.mma) <= L.GRID_SMEM_MAX
                assert p.units >= u and p.units % g.us == 0 and (p.units == u or u % g.us)
            elif g is not None:
                assert p.smem == L.grid_bwd_smem_bytes(g.us, g.cl, g.rows, g.kc, g.kp, g.nres, g.ns, bf16)
                assert p.smem <= L.GRID_SMEM_MAX and p.units % (g.cl * g.us) == 0
                assert p.units >= u and (p.units == u or u % (g.cl * g.us))
            elif fwd:
                assert p.smem == L.forward_smem_bytes(p.units, p.cluster, p.bt, p.ksplit, bf16) and p.resident
            else:
                assert p.smem == L.backward_smem_bytes(p.units, p.cluster, p.bt, p.ksplit, p.resident, bf16)
            assert p.smem <= L.SMEM_MAX
            if g is None:
                assert p.units >= u and p.units % (8 * p.cluster) == 0
                assert p.units == u or u % (8 * p.cluster)  # padded only where the plan's cut does not divide U
            if fwd:
                held = any(u % (8 * c) == 0 and L.forward_smem_bytes(u, c, bt, L._ksplit(u, c, bt, bf16), bf16)
                           <= L.SMEM_MAX for c in L.CLUSTER_SIZES for bt in L.ROW_TILES)
                if u > (L.RESIDENT_UNITS if prec == "highest" else L.RING_UNITS_BF16):
                    assert g is not None
                else:  # the template where a cut holds its slices, else the grid layout (or a padded cut)
                    assert (g is None and p.resident) if held else (g is not None or p.units > u)
            else:
                assert (g is not None) == (u > (L.GRID_UNITS_BWD if prec == "highest" else L.RING_UNITS_BF16))
            streamed += not p.resident
    assert streamed > 0
    # the flagship widths keep their plans; at U = 1024 both kernels run on
    # their grid layouts, and the VJP's template at 512 streams, cut 8 ways
    assert plan_fn(32, 256, 2, prec).resident and plan_fn(32, 256, 2, prec).cluster == 8
    wide = plan_fn(64, 1024, 2, prec)
    assert wide.grid is not None and wide.units == 1024
    if not fwd and prec == "highest":
        mid = plan_fn(64, 512, 2, prec)
        assert (mid.grid, mid.cluster, mid.resident, mid.units) == (None, 8, False, 512)
    for u in (L.MAX_UNITS + 8, 2 * L.MAX_UNITS, 100, 0):
        with pytest.raises(ValueError):
            plan_fn(8, u, 1, prec)


@pytest.mark.parametrize("u,want", [(264, ("highest", 104)), (320, ("highest", 200)), (512, ("highest", 248)),
                                    (360, ("bf16", 264)), (1016, ("bf16", 368))])
def test_forward_plan_streams_or_pads(u, want):
    """No route streams the forward's slice of wh now: float32 past U = 256
    the plan takes the grid layout and ``layout="template"`` (once the
    template's streamed slice, for comparisons) is refused; and below the
    resident widths, where no cut of U holds its slices in a cluster
    (float32 104 = 13 · 8, 200 = 25 · 8 and 248 = 31 · 8 past what a block
    of one holds; bf16 264 and 368: ``want``), the forward takes the grid
    layout too (the template's streamed slice read 2–3× slower on the H100,
    PERF.md), at U itself or the next multiple of its blocks' units, its wh
    held whole, in one launch of the batch."""
    assert L.forward_plan(64, u, 2, "highest").grid is not None
    with pytest.raises(ValueError):
        L.forward_plan(64, u, 2, "highest", layout="template")
    prec, w = want
    p = L.forward_plan(64, w, 2, prec)
    g = p.grid
    assert g is not None and p.cluster == 1 and p.resident and g.passes == 1
    assert p.units % g.us == 0 and 0 <= p.units - w < g.us and g.blocks == 2 * p.units // g.us
    assert all(w % (8 * c) or L.forward_smem_bytes(w, c, bt, L._ksplit(w, c, bt, prec == "bf16"), prec == "bf16")
               > L.SMEM_MAX for c in L.CLUSTER_SIZES for bt in L.ROW_TILES)


# what cudaOccupancyMaxActiveClusters gives every plan of the listener
# kernels on the H100 (NVIDIA H100 80GB HBM3, whatever the shared memory, as
# measured: PERF.md): 15 clusters of 8 blocks or fewer, 7 of 16
def _h100_active(c, *_):
    return 7 if c > 8 else 15


# what the H100 holds at once of the VJP's grid launch, in blocks
# (plt_lstm_bwd_grid_info, PERF.md): 132 in clusters of 1 or 2, 120 in
# clusters of 4 or 8
H100_GRID_HELD = {1: 132, 2: 132, 4: 120, 8: 120}


def _h100_bwd_active(plan):
    if plan.grid is not None:
        return H100_GRID_HELD[plan.grid.cl]
    return _h100_active(plan.cluster)


# the float32 plans of the VJP's loop at the W1024 and LAS-paper widths on
# the H100's occupancy: at U = 512 the template's (C, Bt, k parts); past it
# the grid layout's (cl, rows, k parts)
STREAMED_PLANS = {
    (1024, 64, 2): ("grid", 2, 64, 2),
    (1024, 32, 2): ("grid", 2, 32, 4),
    (1024, 32, 1): ("grid", 2, 32, 8),
    (1024, 8, 2): ("grid", 8, 8, 2),
    (512, 64, 2): ("template", 8, 16, 1),
    (512, 32, 2): ("template", 8, 8, 2),
    (512, 8, 2): ("template", 8, 8, 2),
}


@pytest.mark.parametrize("u,b,nd", sorted(STREAMED_PLANS))
@pytest.mark.parametrize("which", ["backward"])
def test_vjp_plans_run_in_one_launch(which, u, b, nd):
    """The VJP's loop in float32 at U = 512 and 1024 on the H100's
    occupancy: at 512 the template's plan, its clusters in one wave; at 1024
    the grid layout's, one launch a pass of rows whose blocks the card holds
    in its clusters (at B = 8 clusters of 8, over 120 blocks of 24 units: U
    padded to 1152), at the layout's bytes, the pass's rows the row tiles of
    a part's threads; the grid layout asked for at 512 (``layout="grid"``)
    fits the card too."""
    p = L.backward_plan(b, u, nd, "highest", _h100_bwd_active)
    want = STREAMED_PLANS[(u, b, nd)]
    assert ("grid" if p.grid is not None else "template", p.cluster, p.bt, p.ksplit) == want
    if p.grid is None:
        assert not p.resident and p.units == u and -(-b // p.bt) * nd <= _h100_active(p.cluster)
    q = p if p.grid is not None else L.backward_plan(b, u, nd, "highest", _h100_bwd_active, layout="grid")
    g = q.grid
    assert g.blocks <= H100_GRID_HELD[g.cl] and g.passes == -(-b // g.rows)
    assert q.units == u or (q.units > u and u % (g.cl * g.us))  # padded only where its clusters do not cut U
    assert g.rows == L.FWD_THREADS // g.ks // (g.cl * g.us // 4) * g.tile
    assert q.smem == L.grid_bwd_smem_bytes(g.us, g.cl, g.rows, g.kc, g.kp, g.nres, g.ns, False) <= L.GRID_SMEM_MAX


def _declared_grid_bwd_bytes(g, bf16=False):
    """A block's shared memory as ``grid_layout(..., bwd)`` of csrc/lstm.cu
    declares it, region by region: resident chunks of the tile of whᵀ, the
    ring's slots, the product, the cluster's partials, two factor tiles, dc
    and the kept dh."""
    nc, f = g.cl * g.us, 4
    if bf16:
        hchunk, wchunk = g.kc // 16 * g.rows // 16 * 512, g.kc // 16 * nc // 8 * 256
    else:
        hchunk, wchunk = g.rows * (g.kc + 4) * f, g.kc * nc * f
    slot = hchunk + (wchunk if g.nres < g.kp // g.kc else 0)
    tile = (g.rows * 7 * g.us + g.rows + 3) // 4 * 4 * f
    regions = [g.nres * wchunk, g.ns * slot, g.rows * nc * f, 2 * g.cl * g.rows * g.us * f if g.cl > 1 else 0,
               2 * tile, g.rows * g.us * f, g.rows * g.us * f]
    return sum(regions)


def _cu_constant(name):
    import re

    src = open(os.path.join(os.path.dirname(L.__file__), "..", "csrc", "lstm.cu")).read()
    return int(re.search(rf"constexpr (?:int|size_t) {name} = (\d+);", src).group(1))


@pytest.mark.parametrize("u", [264, 320, 512, 1024, 100, 1280, 2048])
@pytest.mark.parametrize("which", ["backward"])
def test_vjp_bytes_are_the_kernels_layout(which, u):
    """Every plan of the VJP's loop at the width cases (both modes, the
    serving, training and small batches, one and two directions, with and
    without the card's occupancy) at the bytes of the layout the kernel
    declares; the constants the mirror reads are the .cu's. The grid layout
    is taken past ``GRID_UNITS_BWD`` (bf16: ``RING_UNITS_BF16``), or at any U
    where it is asked for (the forward's grid layout:
    tests/test_torch_lstm_grid.py)."""
    assert (L.SMEM_MAX, L.GRID_SLOTS_MAX, L.FWD_THREADS) == tuple(
        _cu_constant(n) for n in ("SMEM_MAX", "GRID_SLOTS_MAX", "FWD_THREADS"))
    u = P.round_up(u, 8)  # as the wrappers ask the planners
    for prec in ("highest", "bf16"):
        bf16 = prec == "bf16"
        for b, nd in ((64, 2), (32, 2), (32, 1), (8, 2), (3, 1)):
            for active, layout in ((None, None), (_h100_bwd_active, None), (_h100_bwd_active, "grid")):
                p = L.backward_plan(b, u, nd, prec, active, layout=layout)
                limit = 0 if layout else L.GRID_UNITS_BWD if prec == "highest" else L.RING_UNITS_BF16
                assert (p.grid is not None) == (u > limit)
                if p.grid is None:
                    assert p.smem == L.backward_smem_bytes(p.units, p.cluster, p.bt, p.ksplit, p.resident, bf16)
                    continue
                g = p.grid
                assert p.smem == _declared_grid_bwd_bytes(g, bf16) <= L.SMEM_MAX - 1024
                assert p.units >= u and g.blocks * g.us == nd * p.units
                if active is not None and g.cl > 1:
                    assert g.blocks <= H100_GRID_HELD[g.cl]


# every plan at U <= 256, and bf16 up to RING_UNITS_BF16, as the listener
# kernels took them before the rings (the forward's at U = 104 and 248, once
# the template's streamed slice, the grid layout's since); bf16 past it (U =
# 512, 1024) the grid layouts (the forward's: C = 1, Bt its rows, k split
# its parts; the VJP's: C its clusters): (B, U, nd, prec) -> forward, VJP
# (C, Bt, k split, resident, bytes, kernel U), on the H100's occupancy
UNCHANGED_PLANS = [
    (64, 256, 2, "highest", (8, 16, 4, True, 227520, 256), (8, 16, 1, True, 221312, 256)),
    (32, 256, 2, "highest", (8, 8, 8, True, 195680, 256), (8, 8, 4, True, 200768, 256)),
    (32, 256, 1, "highest", (8, 8, 8, True, 195680, 256), (8, 8, 4, True, 200768, 256)),
    (8, 256, 2, "highest", (8, 8, 8, True, 195680, 256), (8, 8, 4, True, 200768, 256)),
    (256, 128, 2, "highest", (8, 16, 8, True, 97472, 128), (8, 16, 4, True, 102528, 128)),
    (64, 160, 2, "highest", (4, 16, 3, True, 192192, 160), (4, 16, 3, True, 204928, 160)),
    (64, 96, 2, "highest", (4, 16, 5, True, 103104, 96), (4, 16, 5, True, 110720, 96)),
    (16, 96, 2, "highest", (4, 8, 10, True, 85344, 96), (4, 8, 10, True, 89152, 96)),
    (64, 104, 2, "highest", (1, 64, 4, True, 105728, 104), (1, 16, 4, False, 173184, 104)),
    (32, 248, 1, "highest", (1, 32, 8, True, 110208, 248), (1, 8, 4, False, 206400, 248)),
    (20, 40, 2, "highest", (1, 8, 6, True, 78176, 40), (1, 8, 16, True, 74304, 40)),
    (64, 256, 2, "bf16", (8, 16, 1, True, 123584, 256), (8, 16, 1, True, 156032, 256)),
    (32, 256, 2, "bf16", (8, 8, 1, True, 104032, 256), (8, 8, 1, True, 115008, 256)),
    (32, 256, 1, "bf16", (8, 8, 1, True, 104032, 256), (8, 8, 1, True, 115008, 256)),
    (8, 256, 2, "bf16", (8, 8, 1, True, 104032, 256), (8, 8, 1, True, 115008, 256)),
    (256, 128, 2, "bf16", (8, 16, 1, True, 45760, 128), (8, 16, 1, True, 61824, 128)),
    (64, 160, 2, "bf16", (4, 16, 1, True, 113344, 160), (4, 16, 1, True, 130944, 160)),
    (64, 96, 2, "bf16", (4, 16, 1, True, 56000, 96), (4, 16, 1, True, 66432, 96)),
    (16, 96, 2, "bf16", (4, 8, 1, True, 41312, 96), (4, 8, 1, True, 44864, 96)),
    (64, 104, 2, "bf16", (1, 8, 1, True, 170848, 104), (1, 8, 1, True, 172096, 104)),
    (32, 248, 1, "bf16", (1, 32, 2, True, 77440, 248), (1, 8, 1, False, 183104, 248)),
    (20, 40, 2, "bf16", (1, 8, 1, True, 45920, 40), (1, 8, 1, True, 46144, 40)),
    (64, 512, 2, "bf16", (1, 64, 2, True, 122112, 512), None),
    (32, 512, 2, "bf16", None, (2, 32, 4, True, 153856, 512)),
    (64, 1024, 2, "bf16", (1, 64, 2, False, 227584, 1024), None),
    (32, 1024, 2, "bf16", None, (2, 32, 4, False, 225536, 1024)),
    (32, 512, 1, "bf16", (1, 32, 2, True, 93824, 512), None),
]


@pytest.mark.parametrize("b,u,nd,prec,want_fwd,want_bwd", UNCHANGED_PLANS)
def test_plans_the_ring_leaves_alone(b, u, nd, prec, want_fwd, want_bwd):
    """The resident route, every plan at U <= 256 and bf16 up to
    ``RING_UNITS_BF16`` keep the plans they had (the template's) but where
    the template streamed its slice of wh (float32 U = 104, 248, bf16 248:
    the grid layout now); bf16 past it the forward and the VJP take their
    grid layouts', as the card measured them faster."""
    bf16 = prec == "bf16"
    grid_below = (u, prec) in ((104, "highest"), (248, "highest"), (248, "bf16"))  # the former streamed slice
    if want_fwd is not None:
        p = L.forward_plan(b, u, nd, prec, _h100_active)
        assert tuple(p[:6]) == want_fwd and (p.grid is not None) == ((bf16 and u > L.RING_UNITS_BF16) or grid_below)
    if want_bwd is not None:
        p = L.backward_plan(b, u, nd, prec, _h100_bwd_active)
        assert tuple(p[:6]) == want_bwd and (p.grid is not None) == (bf16 and u > L.RING_UNITS_BF16)


def test_decoder_plan_takes_the_wide_spellers():
    """The LAS paper's speller (2 × 512, attention 512, listener 256 a
    direction) fits the held layout at 226,016 bytes, at C = 8, but the plan
    takes the grid layout there (faster by the step model, and on an NVIDIA
    H100: 118.6 against 159.7 µs a step); the LAS-4-1024 speller (U = A =
    1024, M = 2048) fits it at no cluster size (the attention layer at 256
    or 1024, V up to 120, one or two cells, every encoder length to 2000),
    and the plan takes the grid layout there, in one launch of the batch,
    its cut ``grid_cuts``'."""
    las = SpellerConfig(vocab_size=34, embedding_dim=128, num_layers=2, units=512, memory_dim=512,
                        attention_units=512, attention_layer_size=256)
    assert FG.decoder_plan(32, las, 438, "held") == FG.DecoderPlan(8, 8, 4)
    assert FG.decoder_plan(32, las, 438).name == "grid"
    assert FG.decoder_smem_bytes(32, 438, las, 8) == 226016
    for v in (34, 120):
        for al in (256, 1024):
            for n_cells in (1, 2):
                for t in (219, 438, 2000):
                    w = SpellerConfig(vocab_size=v, embedding_dim=128, num_layers=n_cells, units=1024,
                                      memory_dim=2048, attention_units=1024, attention_layer_size=al)
                    plan = FG.decoder_plan(32, w, t)
                    assert plan == FG.DecoderPlan(1, 8, 4, grid=FG.grid_cuts(32, w)) and plan.layout == 1
                    assert FG.decoder_smem_bytes(32, t, w, 1, grid=plan.grid) <= FG.SMEM_MAX
                    for c in FG.DECODER_CLUSTERS:  # the held layout does not fit
                        assert FG.decoder_smem_bytes(32, t, w, c) > FG.SMEM_MAX


def test_kernel_widths_pad_to_what_a_plan_takes():
    """W100's speller (E = 30, U = 36, A = 60, the preset's AL = 256, M =
    200) runs its embedding at 32 in the held layout; widths that only a
    cut of one block takes where the held layout does not fit it are
    rounded, for the held layout, to the granularity of the largest cut
    whose held layout fits (U = A = 274: 276 does not fit at C = 1, 288
    does at C = 8), and the plan takes that or the grid layout at the
    granular widths, whichever the step model says is faster; where none fits, the plan runs them in the grid layout, which
    pads its own column blocks, at the granular widths."""
    w100 = FG.DecoderWidths(34, 30, 36, 60, 256, 200, 1, 2, 2)
    kw, plan = FG.kernel_widths(8, w100, 125)
    assert kw == w100._replace(embedding_dim=32) and plan == FG.DecoderPlan(1, 8, 1) and plan.layout == 0
    mid = FG.DecoderWidths(34, 30, 274, 274, 250, 548, 1, 2, 2)
    kw, plan = FG.kernel_widths(8, mid, 438, "held")
    assert FG.decoder_smem_bytes(8, 438, mid._replace(embedding_dim=32, units=276, attention_units=276,
                                                      attention_layer_size=256), 1) > FG.SMEM_MAX
    assert (kw.embedding_dim, kw.units, kw.attention_units, kw.attention_layer_size, kw.memory_dim) == (
        32, 288, 288, 256, 548)
    assert plan == FG.DecoderPlan(8, 8, 1) and FG.decoder_plan(8, kw, 438, "held") == plan
    granular = mid._replace(embedding_dim=32, units=276, attention_units=276, attention_layer_size=256)
    grid = FG.decoder_plan(8, granular, 438, "grid")
    held_faster = FG.step_us(8, 438, kw, plan) <= FG.step_us(8, 438, granular, grid)
    assert FG.kernel_widths(8, mid, 438) == ((kw, plan) if held_faster else (granular, grid))
    odd = FG.DecoderWidths(34, 30, 1018, 1022, 250, 2046, 1, 2, 2)  # the held layout fits no cut of them
    kw, plan = FG.kernel_widths(8, odd, 438)
    assert plan.layout == 1 and (kw.units, kw.attention_units, kw.attention_layer_size) == (1020, 1024, 256)
    assert (kw.embedding_dim, kw.memory_dim) == (32, 2048) and plan.grid == FG.grid_cuts(8, kw)


# ---- the streamed cluster decomposition, emulated


def _lstm_case(u, seed):
    rs = np.random.RandomState(seed)
    xp = rs.randn(T, B, 4 * u).astype(np.float32)
    wh = (rs.randn(u, 4 * u) / np.sqrt(u)).astype(np.float32)
    lens = np.array([T, 1, 4])
    mask = (np.arange(T)[:, None] < lens[None, :]).astype(np.float32)
    return xp, mask, wh


def _emulate_forward(xp, mask, wh, reverse, prec, plan):
    """The kernel's forward at its plan: the padding of ``_launch_forward``,
    the cluster decomposition of ``plan`` (a block's slice of wh is the
    same regrouped slice whether it is held or streamed) or the grid
    layout's (``plan.grid``), the slicing."""
    u, up = wh.shape[0], plan.units
    xpp, whp = P.pad_gates(xp, u, up), P.pad_lstm_wh(wh, up)
    if plan.grid is not None:
        got = grid_recurrence_emulated(xpp, mask, whp, 1.0, reverse, prec, plan.grid)
    else:
        got = cluster_recurrence_emulated(xpp, mask, whp, 1.0, reverse, prec, plan.cluster, plan.bt, save_res=True)
    return [x[..., :u] for x in got]


@pytest.mark.parametrize("u", [264, 1024, 360])
@pytest.mark.parametrize("prec", ["highest", "bf16"])
def test_streamed_forward_matches_plain_xla_and_pallas(prec, u):
    xp, mask, wh = _lstm_case(u, 13)
    plan = L.forward_plan(B, u, 1, prec)
    if u > (L.RESIDENT_UNITS if prec == "highest" else L.RING_UNITS_BF16) or u == 264:
        # past the resident widths, or where U's cuts fit only streaming wh (33 slices of 8): the grid layout
        assert plan.grid is not None
    else:
        assert plan.grid is None and plan.resident and plan.units > u  # bf16 at 360: padded and held
    reverse = u == 1024
    txp, tmask, twh = torch.from_numpy(xp), torch.from_numpy(mask), torch.from_numpy(wh)
    got = _emulate_forward(txp, tmask, twh, reverse, prec, plan)
    (plain,) = L.recurrence_residual_plain([txp], tmask, [twh], 1.0, [reverse], prec)
    ref = _recurrence_pallas_residual(jnp.asarray(xp), jnp.asarray(mask), jnp.asarray(wh), reverse=reverse,
                                      interpret=True, prec=prec)
    xla_out, (xla_h, xla_c) = _recurrence_xla(jnp.asarray(xp), jnp.asarray(mask), jnp.asarray(wh), 1.0, reverse, prec)
    for i, (g, p, r) in enumerate(zip(got, plain, ref)):
        res = i in (1, 2)
        tol = JAX_RES_TOL[prec] if res else JAX_TOL[prec]
        np.testing.assert_allclose(g.float().numpy(), p.float().numpy(), rtol=0,
                                   atol=JAX_RES_TOL[prec] if res and prec == "bf16" else EMU_TOL[prec])
        np.testing.assert_allclose(g.float().numpy(), np.asarray(r, np.float32), rtol=tol, atol=tol)
    for g, x in zip((got[0], got[3], got[4]), (xla_out, xla_h, xla_c)):
        np.testing.assert_allclose(g.numpy(), np.asarray(x, np.float32), rtol=JAX_TOL[prec], atol=JAX_TOL[prec])


@pytest.mark.parametrize("u", [264, 1024])
@pytest.mark.parametrize("prec", ["highest", "bf16"])
def test_streamed_vjp_matches_plain_pallas_and_jax_grad(prec, u):
    xp, mask, wh = _lstm_case(u, 14)
    reverse = u == 264
    rs = np.random.RandomState(u)
    dout = rs.randn(T, B, u).astype(np.float32)
    dh, dc = rs.randn(B, u).astype(np.float32), rs.randn(B, u).astype(np.float32)
    _, hprev, cprev, _, _ = _recurrence_pallas_residual(jnp.asarray(xp), jnp.asarray(mask), jnp.asarray(wh),
                                                        reverse=reverse, interpret=True, prec=prec)
    plan = L.backward_plan(B, u, 1, prec, layout="template")
    assert not plan.resident and plan.units == u
    rdt = torch.bfloat16 if prec == "bf16" else torch.float32
    t = lambda x: torch.from_numpy(np.asarray(x, np.float32).copy())
    args = (t(xp), t(mask), t(wh), t(hprev).to(rdt), t(cprev).to(rdt), t(dout), t(dh), t(dc))
    dxp, dwh = cluster_bwd_emulated(*args, 1.0, reverse, prec, plan.cluster, plan.bt)
    ((pdxp, pdwh),) = L.recurrence_bwd_plain(*[[a] if i != 1 else a for i, a in enumerate(args)], 1.0, [reverse],
                                             prec)
    ref_dxp, ref_dwh = _recurrence_pallas_bwd(
        jnp.asarray(xp), jnp.asarray(mask), jnp.asarray(wh), hprev, cprev, jnp.asarray(dout),
        jnp.asarray(dh), jnp.asarray(dc), reverse=reverse, interpret=True, prec=prec,
    )

    def loss(xp_, wh_):
        out, (h, c) = _recurrence_xla(xp_, jnp.asarray(mask), wh_, 1.0, reverse, prec)
        return jnp.sum(out * dout) + jnp.sum(h * dh) + jnp.sum(c * dc)

    jdxp, jdwh = jax.grad(loss, argnums=(0, 1))(jnp.asarray(xp), jnp.asarray(wh))
    rel = lambda g, w: float(np.abs(g - np.asarray(w, np.float32)).max()) / float(np.abs(np.asarray(w)).max())
    for got, plain, ref, jg in ((dxp, pdxp, ref_dxp, jdxp), (dwh, pdwh, ref_dwh, jdwh)):
        assert rel(got.numpy(), plain.numpy()) <= VJP_TOL[prec]
        assert rel(got.numpy(), ref) <= VJP_TOL[prec]
        assert rel(got.numpy(), jg) <= VJP_TOL[prec]


# ---- padding


@pytest.mark.parametrize("u,up", [(100, 104), (100, 128), (36, 64)])
@pytest.mark.parametrize("prec", ["highest", "bf16"])
def test_lstm_padding_is_exact(prec, u, up):
    """The forward and the VJP of a padded layer, sliced back, against the
    unpadded plain versions (the padded units stay zero and add zeros);
    U = 100 also against JAX's scan and ``jax.grad``."""
    xp, mask, wh = _lstm_case(u, 15)
    txp, tmask, twh = torch.from_numpy(xp), torch.from_numpy(mask), torch.from_numpy(wh)
    (want,) = L.recurrence_residual_plain([txp], tmask, [twh], 1.0, [False], prec)
    (padded,) = L.recurrence_residual_plain([P.pad_gates(txp, u, up)], tmask, [P.pad_lstm_wh(twh, up)], 1.0,
                                            [False], prec)
    rel = lambda g, w: float((g.float() - w.float()).abs().max()) / float(w.float().abs().max())
    for g, w in zip(padded, want):
        assert float(g[..., u:].float().abs().max()) == 0.0  # the padded units stay zero
        assert rel(g[..., :u], w) <= PAD_TOL
    rs = np.random.RandomState(16)
    dout, dh, dc = (torch.from_numpy(rs.randn(*s).astype(np.float32)) for s in ((T, B, u), (B, u), (B, u)))
    ((wdxp, wdwh),) = L.recurrence_bwd_plain([txp], tmask, [twh], [want[1]], [want[2]], [dout], [dh], [dc], 1.0,
                                             [False], prec)
    pu = lambda x: P.pad_units(x, u, up)
    ((pdxp, pdwh),) = L.recurrence_bwd_plain([P.pad_gates(txp, u, up)], tmask, [P.pad_lstm_wh(twh, up)],
                                             [pu(want[1])], [pu(want[2])], [pu(dout)], [pu(dh)], [pu(dc)], 1.0,
                                             [False], prec)
    assert rel(P.slice_gates(pdxp, u, up), wdxp) <= PAD_TOL
    assert rel(P.slice_gates(pdwh[:u], u, up), wdwh) <= PAD_TOL
    if u == 100:
        out, (h, c) = _recurrence_xla(jnp.asarray(xp), jnp.asarray(mask), jnp.asarray(wh), 1.0, False, prec)
        for g, x in zip((padded[0], padded[3], padded[4]), (out, h, c)):
            np.testing.assert_allclose(g[..., :u].numpy(), np.asarray(x, np.float32), rtol=JAX_TOL[prec],
                                       atol=JAX_TOL[prec])

        def loss(xp_, wh_):
            o, (h_, c_) = _recurrence_xla(xp_, jnp.asarray(mask), wh_, 1.0, False, prec)
            return jnp.sum(o * dout.numpy()) + jnp.sum(h_ * dh.numpy()) + jnp.sum(c_ * dc.numpy())

        jdxp, jdwh = jax.grad(loss, argnums=(0, 1))(jnp.asarray(xp), jnp.asarray(wh))
        for g, jg in ((P.slice_gates(pdxp, u, up), jdxp), (P.slice_gates(pdwh[:u], u, up), jdwh)):
            jg = np.asarray(jg, np.float32)
            assert float(np.abs(g.numpy() - jg).max()) <= VJP_TOL[prec] * float(np.abs(jg).max())


def test_pad_blocks_round_trip():
    x = torch.arange(2 * 12, dtype=torch.float32).reshape(2, 12)
    y = P.pad_blocks(x, 1, [5, 7], [8, 7])
    assert y.shape == (2, 15) and torch.equal(y[:, 5:8], torch.zeros(2, 3))
    assert torch.equal(P.slice_blocks(y, 1, [5, 7], [8, 7]), x)
    assert P.pad_blocks(x, 1, [12], [12]) is x
    with pytest.raises(ValueError):
        P.pad_blocks(x, 1, [5, 6], [8, 7])


# ---- the W100 and W1024 models against JAX


def _resolve(tmp_path, overrides):
    d = str(tmp_path / "data")
    os.makedirs(d, exist_ok=True)
    Vocab(_GRAPHEMES + ["-", "."]).save(os.path.join(d, "vocab.txt"))  # the preset's 34 tokens
    ov = {"dropout": 0.0, **overrides}
    jpreset = jax_resolve_preset("librispeech_char_las", d, ov)[0]
    preset = resolve_preset("librispeech_char_las", d, ov)[0]
    assert dataclasses.asdict(preset.model) == dataclasses.asdict(jpreset.model)
    return jpreset.model, preset.model


def _flat(tree):
    return {jax.tree_util.keystr(p): np.asarray(x) for p, x in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _batch(seed, samples=(8000, 5600), targets=(7, 4), vocab=34):
    rs = np.random.RandomState(seed)
    audio = (rs.randn(len(samples), max(samples)) * 2000).astype(np.float32)
    for i, n in enumerate(samples):
        audio[i, n:] = 0.0
    tg = np.zeros((len(samples), max(targets)), np.int32)
    for i, n in enumerate(targets):
        tg[i, : n - 1] = rs.randint(4, vocab, n - 1)
        tg[i, n - 1] = 2
    return {"audio": audio, "audio_lengths": np.asarray(samples, np.int32), "targets": tg,
            "target_lengths": np.asarray(targets, np.int32)}


STEPS = 6


@pytest.mark.parametrize("widths", ["W1024", "W100"])
def test_wide_and_odd_models_match_jax(widths, tmp_path):
    """The reference's flags at LAS-4-1024's widths (one listener layer
    here, short inputs) and at W100's: the port's encoder and greedy
    decoders (the loop, the kernel's plain version on the kernel's padded
    widths) at JAX's tokens, and the loss within 1e-5, from JAX's init
    carried across by ``params_from_numpy``."""
    overrides = {**(W1024 if widths == "W1024" else W100), "encoder_layers": 1}
    jcfg, cfg = _resolve(tmp_path, overrides)
    assert cfg.speller.memory_dim == 2 * cfg.listener.units
    jp = jax_init_las(jax.random.PRNGKey(13), jcfg)
    params = params_from_numpy(_flat(jp), cfg, device="cpu")
    batch = _batch(13)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    jloss, _ = jax.jit(lambda p: jax_compute_loss(p, jcfg, jb, train=False, implementation="xla"))(jp)
    jmem, _, jmask = jax.jit(lambda p: jax_encode(p, jcfg, jb["audio"], jb["audio_lengths"]))(jp)
    jtok = np.asarray(jax_greedy_decode(jp.speller, jcfg.speller, jmem, jmask, STEPS)[0])
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    with torch.no_grad():
        loss, _ = LAS.compute_loss(params, cfg, tb, train=False)
        mem, _, mask = LAS.encode(params, cfg, tb["audio"], tb["audio_lengths"])
        tok, _, _ = greedy_decode(params.speller, cfg.speller, mem, mask, STEPS)
        sc = cfg.speller
        widths_ = FG.DecoderWidths(sc.vocab_size, sc.embedding_dim, sc.units, sc.attention_units,
                                   sc.attention_layer_size, sc.memory_dim, sc.bos_id, sc.eos_id, sc.num_layers)
        kw, _ = FG.kernel_widths(mem.shape[0], widths_, mem.shape[1])
        weights, pmem = FG.pad_speller(FG.flat_weights(params.speller), mem, widths_, kw)
        pparams, _ = FG._unflatten(weights, pmem, sc.bos_id, sc.eos_id)
        ptok, _ = FG.greedy_decode_fused_plain(pparams, kw, pmem, mask, STEPS)
    assert (kw != widths_) == (widths == "W100")
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=LOSS_RTOL)
    np.testing.assert_allclose(mem.numpy(), np.asarray(jmem), rtol=1e-4, atol=1e-5)
    np.testing.assert_array_equal(tok.numpy(), jtok)
    np.testing.assert_array_equal(ptok.numpy(), jtok)


def test_speller_padding_is_exact():
    """Every width of a speller padded (E 30 → 32, U 34 → 64, A 62 → 64, AL
    250 → 256, M 202 → 204, the granularity of a cut of 8 blocks): the
    kernel's plain version on the padded weights and memory gives the
    unpadded tokens."""
    from phones_las_torch.models.speller import init_speller

    sc = SpellerConfig(vocab_size=34, embedding_dim=30, num_layers=2, units=34, memory_dim=202,
                       attention_units=62, attention_layer_size=250)
    sp = init_speller(sc, torch.Generator().manual_seed(17))
    rs = np.random.RandomState(17)
    mem = torch.from_numpy(rs.randn(5, 11, 202).astype(np.float32))
    lens = torch.tensor([11, 3, 7, 1, 11])
    mask = (torch.arange(11)[None, :] < lens[:, None]).float()
    w = FG.DecoderWidths(34, 30, 34, 62, 250, 202, sc.bos_id, sc.eos_id, 2)
    kw = FG.DecoderWidths(34, 32, 64, 64, 256, 204, sc.bos_id, sc.eos_id, 2)
    weights, pmem = FG.pad_speller(FG.flat_weights(sp), mem, w, kw)
    pp, _ = FG._unflatten(weights, pmem, sc.bos_id, sc.eos_id)
    with torch.no_grad():
        want, _ = FG.greedy_decode_fused_plain(sp, sc, mem, mask, 12)
        got, _ = FG.greedy_decode_fused_plain(pp, kw, pmem, mask, 12)
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    assert len(set(want.flatten().tolist())) > 2  # the rows emit more than <eos>
