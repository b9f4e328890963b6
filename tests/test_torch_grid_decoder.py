"""The decoder kernel's grid layout (``csrc/greedy.cu::greedy_grid_kernel``)
on the CPU: its plan, its cuts and its shared memory and workspace against
the .cu's arithmetic, and an emulation of its reduction order against the
JAX reference.

A CUDA kernel does not run here, so what can go wrong in its index
arithmetic is checked on the Python cut the wrapper hands it (every row,
column, position and k covered exactly once) and its summation order is
emulated in PyTorch: each dense stage's column blocks and k parts summed
as the kernel sums them, each row's attention cut into the kernel's
chunks (scores, the row's maximum over the chunks' maxima, each chunk's
sum and unnormalised part of the context, the parts over the row's sum
merged in chunk order) and the argmax merged in column block order."""

import math
import os
import re

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from phones_las_tpu.decode.pallas_greedy import greedy_decode_fused as jax_greedy_decode_fused
from phones_las_tpu.models.speller import SpellerConfig as JaxSpellerConfig
from phones_las_tpu.models.speller import init_speller as jax_init_speller

from phones_las_torch.decode import fused_greedy as FG
from phones_las_torch.models.speller import SpellerConfig
from tests.torch_threads import one_thread

one_thread()

CU = os.path.join(os.path.dirname(FG.__file__), "..", "csrc", "greedy.cu")
THREADS, DR, NWARPS = FG.THREADS, FG.GROUP_ROWS, FG.THREADS // 32


def _speller(u, m, a=None, al=None, v=34, e=128, n_cells=2):
    return SpellerConfig(vocab_size=v, embedding_dim=e, num_layers=n_cells, units=u, memory_dim=m,
                         attention_units=a or u, attention_layer_size=al or u)


CHECKPOINT = _speller(256, 512, v=26)  # the committed checkpoint's speller
W1024 = _speller(1024, 2048, al=256)  # LAS-4-1024 through the reference's flags
W2048 = _speller(2048, 4096)  # encoder, decoder and attention units 2048
SPELLERS = {"checkpoint": CHECKPOINT, "W1024": W1024, "W1024 attention layer 1024": _speller(1024, 2048),
            "W2048": W2048, "W100": _speller(36, 200, 60, 256, e=32), "one cell": _speller(256, 512, v=120, n_cells=1)}


def _widths(cfg):
    return cfg.embedding_dim, cfg.units, cfg.attention_units, cfg.attention_layer_size, cfg.memory_dim


def _cu():
    return open(CU).read()


def _cu_constant(name):
    return int(re.search(rf"constexpr (?:int|size_t) {name} = (\d+);", _cu()).group(1))


def _pad4(n):
    return -(-n // 4) * 4


def _round8(n):
    return -(-n // 8) * 8


def _cu_regions(function, names):
    """The sizes a .cu layout function adds region by region (``off += ...``),
    evaluated with ``names`` (the function's arguments and locals)."""
    body = re.search(rf"{function}\(.*?\n}}\n", _cu(), re.S).group(0)
    exprs = re.findall(r"off \+= ([^;]+);", body)
    env = {"pad4": _pad4, "round8": _round8, "NSLOT": FG.NSLOT, "THREADS": THREADS, "N_STAGES": len(FG.GRID_STAGES),
           **names}
    return [eval(re.sub(r"\((?:size_t|int)\)", "", x), {}, env) for x in exprs]


def test_constants_are_the_kernels():
    """The Python mirror's constants are the .cu's."""
    for name in ("THREADS", "NSLOT", "KS_MAX", "MAX_TILES", "SMEM_MAX"):
        assert getattr(FG, name) == _cu_constant(name), name
    assert _cu_constant("DR") == DR and (_cu_constant("LAYOUT_HELD"), _cu_constant("LAYOUT_GRID")) == (0, 1)
    assert FG.DecoderPlan(1, 8, 1, grid=FG.grid_cuts(8, CHECKPOINT)).layout == 1


# ---- the plan: the faster layout by the step model, the grid layout past the held one

# the held layout's shapes on the main paths before the step model chose:
# phases 1 and 3 (the flagship, B = 8 and the eval set's 64 rows), 5 and 6
# (the eval set), 9 (the G2P), 12a (each preset's serving shape), 13a (the
# LAS paper's speller), 14 (the bench's greedy rows, V = 34): (B, T_enc,
# speller, cluster, groups, the layout the plan takes now)
HELD = [
    (64, 250, CHECKPOINT, 8, 8, "held"), (8, 250, CHECKPOINT, 8, 1, "held"), (64, 101, CHECKPOINT, 8, 8, "held"),
    (64, 28, _speller(160, 320, v=45, e=64, n_cells=1), 8, 8, "held"),
    (32, 400, _speller(256, 512, v=65, n_cells=1), 8, 4, "held"),
    (32, 400, _speller(256, 512, v=32, n_cells=1), 8, 4, "held"),
    (32, 438, _speller(256, 512, v=120, n_cells=1), 8, 4, "held"), (256, 438, _speller(256, 512), 8, 32, "grid"),
    (32, 438, _speller(512, 512, al=256), 8, 4, "grid"), (64, 250, _speller(256, 512), 8, 8, "held"),
]


@pytest.mark.parametrize("b,t,cfg,cluster,groups,takes", HELD)
def test_the_held_layout_keeps_its_plan(b, t, cfg, cluster, groups, takes):
    """Wherever the held layout was planned, its plan (``layout="held"``)
    is the same, at the same widths and cluster: the largest cut whose
    layout fits a block; the plan takes it where the step model says it is
    the faster (every serving shape), else the grid layout (offline B = 256,
    the LAS paper's speller)."""
    kw, plan = FG.kernel_widths(b, cfg, t, "held")
    assert _widths(kw) == _widths(cfg) and plan == FG.DecoderPlan(cluster, DR, groups) and plan.layout == 0
    assert FG.decoder_plan(b, cfg, t, "held") == plan and FG.decoder_smem_bytes(b, t, cfg, cluster) <= FG.SMEM_MAX
    assert all(FG.decoder_smem_bytes(b, t, cfg, c) > FG.SMEM_MAX for c in FG.DECODER_CLUSTERS if c > cluster)
    chosen = FG.kernel_widths(b, cfg, t)[1]
    assert chosen.name == takes and (chosen == plan) == (takes == "held")
    grid = FG.decoder_plan(b, cfg, t, "grid")
    assert (FG.step_us(b, t, cfg, plan) <= FG.step_us(b, t, cfg, grid)) == (takes == "held")


def _held_fits(b, t, kw):
    """Whether the held layout fits a block at some cut of C blocks, the
    widths padded to it as ``kernel_widths`` pads them."""
    kw = FG.DecoderWidths(kw.vocab_size, kw.embedding_dim, kw.units, kw.attention_units, kw.attention_layer_size,
                          kw.memory_dim, kw.bos_id, kw.eos_id, kw.num_layers)
    return any(FG.decoder_smem_bytes(b, t, kw._replace(units=-(-kw.units // (4 * c)) * 4 * c,
                                                       attention_units=-(-kw.attention_units // (4 * c)) * 4 * c,
                                                       attention_layer_size=-(-kw.attention_layer_size // math.lcm(8, 4 * c))
                                                       * math.lcm(8, 4 * c)),
                                      c) <= FG.SMEM_MAX for c in FG.DECODER_CLUSTERS)


@pytest.mark.parametrize("name", sorted(SPELLERS))
def test_the_plan_takes_the_grid_past_the_held_layout(name):
    """Past the held layout (W1024 at every T_enc, long recordings at the
    checkpoint's widths, W2048) the plan takes the grid layout at the
    granular widths, and where the held layout fits, the grid wherever the
    step model says it is the faster; ``layout="grid"`` forces the grid
    anywhere, and no other layout is taken."""
    cfg = SPELLERS[name]
    grid_seen = 0
    for b in (1, 8, 32, 64):
        for t in (219, 438, 5900, 17100, 40000, 100000):
            kw, plan = FG.kernel_widths(b, cfg, t)
            if plan.layout == 0:
                assert FG.decoder_smem_bytes(b, t, kw, plan.cluster) <= FG.SMEM_MAX
            else:
                if _held_fits(b, t, kw):
                    held_kw, held = FG.kernel_widths(b, cfg, t, "held")
                    assert FG.step_us(b, t, kw, plan) < FG.step_us(b, t, held_kw, held)
                assert plan == FG.DecoderPlan(1, DR, -(-b // DR), grid=FG.grid_cuts(b, kw))
                assert kw.units == cfg.units and kw.attention_units == cfg.attention_units  # no padding to a cut
                grid_seen += 1
            assert FG.kernel_widths(b, cfg, t, "grid")[1].layout == 1
    assert grid_seen > 0 or name == "W100"
    for layout in ("cluster", "tiled"):
        with pytest.raises(ValueError, match="layout is one of"):
            FG.decoder_plan(8, cfg, 219, layout)


@pytest.mark.parametrize("v,n_cells", [(2881, 2), (2913, 1), (20000, 2)])
def test_the_grid_takes_every_vocabulary(v, n_cells):
    """Past the largest vocabulary the held layout holds (its out_w slice
    and logits grow with V) the grid layout plans: its logits are column
    blocks of the grid and its pairs lie in global memory."""
    cfg = _speller(256, 512, v=v, n_cells=n_cells)
    assert not _held_fits(8, 438, cfg)
    plan = FG.decoder_plan(8, cfg, 438)
    assert plan.layout == 1 and FG.decoder_smem_bytes(8, 438, cfg, 1, grid=plan.grid) <= FG.SMEM_MAX


@pytest.mark.parametrize("name", ["checkpoint", "W1024", "W2048", "W100"])
def test_the_grid_takes_every_batch_in_passes(name):
    """Each block keeps six ints a row (a launch holds ``grid_rows`` rows:
    the largest multiple of 8 whose bytes fit beside a ring of
    ``SLOT_STREAMED`` floats a slot, 2,920 at A = 1024, 2,584 at A = 2048);
    past
    that the plan decodes the batch in passes of at most as many rows, a
    launch each, as few passes as will do: the passes cover every row once
    and each is a launch of one pass that fits. W1024 at B = 4096 takes two
    passes of 2,048."""
    cfg = SPELLERS[name]
    most = FG.grid_rows(cfg)
    assert most % 8 == 0 and FG.decoder_smem_bytes(most, 1, cfg, 1, grid=FG.grid_cuts(most, cfg)) <= FG.SMEM_MAX
    assert FG._slot(most, cfg) >= FG.SLOT_STREAMED > FG._slot(most + 8, cfg)
    assert most == {"checkpoint": 3176, "W1024": 2920, "W2048": 2584, "W100": 3248}[name]
    for b in (1, most - 1, most, most + 1, 4096, 2 * most + 1, 10000, 100000):
        plan = FG.decoder_plan(b, cfg, 219, "grid")
        passes = -(-b // most)
        assert plan.passes == passes and plan.groups == -(-b // DR)
        n = -(-b // passes)
        assert n <= most and plan.grid == FG.grid_cuts(n, cfg)
        slices = [range(r, min(b, r + n)) for r in range(0, b, n)]
        assert len(slices) == passes
        _covered_once([r for sl in slices for r in sl], range(b))
        for sl in slices:
            sub = FG.decoder_plan(len(sl), cfg, 219, "grid")
            assert sub.passes == 1 and FG.decoder_smem_bytes(len(sl), 219, cfg, 1, grid=sub.grid) <= FG.SMEM_MAX
    if name == "W1024":
        plan = FG.decoder_plan(4096, cfg, 219)
        assert plan.layout == 1 and plan.passes == 2 and plan.grid == FG.grid_cuts(2048, cfg)


BATCHES = (1, 2, 3, 7, 8, 9, 31, 32, 33, 64, 100, 131, 132, 133, 256, 300, 512)


def _covered_once(cells, want):
    seen = {}
    for c in cells:
        seen[c] = seen.get(c, 0) + 1
    assert set(seen) == set(want) and all(n == 1 for n in seen.values())


@pytest.mark.parametrize("name", ["checkpoint", "W1024", "W2048", "W100", "one cell"])
def test_grid_cuts_cover_every_row_and_column(name):
    """At B = 1..512 (and the widths up to U = A = AL = 2048, M = 4096, the
    plan the same at every T_enc to 100,000) each dense stage's blocks lie
    within the grid and cover every (row, column) exactly once, a pass's
    items fit the threads, a tile's input and weight rows fit a slot, the
    k parts' sums fit the ring, every k is summed by exactly one part, and
    the block's shared memory fits."""
    cfg = SPELLERS[name]
    n_out = (cfg.units, cfg.units, cfg.attention_units, cfg.attention_layer_size, cfg.vocab_size)
    for b in BATCHES:
        plans = {FG.decoder_plan(b, cfg, t, "grid") for t in (1, 219, 17100, 100000)}
        assert len(plans) == 1
        g = plans.pop().grid
        assert g.blocks == FG.GRID_BLOCKS and len(g.stages) == len(FG.GRID_STAGES)
        for i, (st, k, n) in enumerate(zip(g.stages, FG.grid_stage_k(cfg), n_out)):
            cells = i < 2
            assert st.cols * st.groups <= g.blocks and st.rows % 8 == 0 and 1 <= st.tiles <= FG.MAX_TILES
            per = st.width // 4 if cells else st.width  # units (4 gate columns each) or columns a block
            covered = []
            for blk in range(st.cols * st.groups):
                grp, cb = divmod(blk, st.cols)
                rows = range(grp * st.rows, min(b, (grp + 1) * st.rows))
                passes = [range(r0, min(rows.stop, r0 + 8 * st.tiles)) for r0 in range(rows.start, rows.stop, 8 * st.tiles)]
                assert [r for p in passes for r in p] == list(rows)
                covered += [(r, c) for r in rows for c in range(cb * per, min(n, (cb + 1) * per))]
            _covered_once(covered, [(r, c) for r in range(b) for c in range(n)])
            tile = FG.grid_tile(k // 4, st.width, st.tiles, g.slot)
            rp = 8 * st.tiles
            assert st.width // 4 * st.tiles * tile.parts <= THREADS
            assert rp * tile.ld + 4 * tile.parts * tile.s4 * st.width <= g.slot
            assert tile.parts * rp * st.width <= FG.NSLOT * g.slot
            _covered_once([k4 for part in FG.grid_part_k4(k // 4, tile) for k4 in part], range(k // 4))
            assert tile.ntiles * tile.parts * tile.s4 >= k // 4
        assert FG.decoder_smem_bytes(b, 100000, cfg, 1, grid=g) <= FG.SMEM_MAX


@pytest.mark.parametrize("grid", [132, 16, 3])
def test_grid_chunks_cover_every_position(grid):
    """Each live row's attention chunks (1 + its share of the spare blocks,
    in proportion to its length; one each past ``grid`` live rows; none for
    a finished row) number at most max(grid, live rows), and the chunks of
    a row cover its valid positions exactly once, a row of none with one
    empty chunk."""
    rng = np.random.RandomState(grid)
    for b in (1, 3, 8, 32, 200):
        for _ in range(4):
            tl = [int(x) for x in rng.randint(0, 3000, b)]
            tl[0] = 0
            finished = [bool(x) for x in rng.rand(b) < 0.3]
            chunks = FG.grid_chunks(tl, finished, grid)
            live = sum(not f for f in finished)
            assert sum(chunks) <= max(grid, live)
            for r in range(b):
                n = chunks[r]
                assert (n == 0) == finished[r]
                if n:
                    cs = -(-tl[r] // n)
                    spans = [range(min(tl[r], c * cs), min(tl[r], min(tl[r], c * cs) + cs)) for c in range(n)]
                    _covered_once([t for s in spans for t in s], range(tl[r]))


def test_grid_smem_and_workspace_are_the_kernels():
    """``decoder_smem_bytes(grid=)`` and ``grid_act_floats`` are
    ``grid_layout``'s and ``grid_ws``'s regions as the .cu adds them."""
    for cfg in (CHECKPOINT, W1024, W2048, SPELLERS["W100"]):
        for b in (1, 8, 33, 512):
            g = FG.grid_cuts(b, cfg)
            smem = _cu_regions("GridLayout grid_layout", {"A": cfg.attention_units, "B": b, "g": g})
            assert FG.decoder_smem_bytes(b, 219, cfg, 1, grid=g) == 4 * sum(smem)
            bp = _round8(b)
            ws = _cu_regions("GridWs grid_ws", {
                "bp": bp, "chunks": _pad4(max(bp, g.blocks)), "n_cells": cfg.num_layers, "U": cfg.units,
                "AL": cfg.attention_layer_size, "A": cfg.attention_units, "M": cfg.memory_dim,
                "lcols": g.stages[-1].cols, "nt": bp // 8})
            assert FG.grid_act_floats(b, cfg, g) == sum(ws)


def test_grid_slices_hold_each_block_its_columns():
    """``grid_slices`` (the wrapper's regrouping of every dense stage's
    weights, a cell's gates side by side) gives column block s the columns
    [s·w, (s+1)·w) of each gate, zero past the stage's columns."""
    g = FG.grid_cuts(8, CHECKPOINT)
    w = torch.randn(40, 4 * 256)
    st = g.stages[0]
    us = st.width // 4
    s = FG.grid_slices(w, st, 256, 4)
    assert s.shape == (st.cols, 40, st.width)
    for cb in range(st.cols):
        for gate in range(4):
            for j in range(us):
                unit = cb * us + j
                want = w[:, gate * 256 + unit] if unit < 256 else torch.zeros(40)
                assert torch.equal(s[cb, :, gate * us + j], want)


# ---- the grid layout's reduction order, emulated, against the JAX reference


def _gather4(parts):
    """grid_gather: part ks on chain ks % 4 while four remain, the rest on chain 0."""
    s = [torch.zeros_like(parts[0]) for _ in range(4)]
    full = len(parts) // 4 * 4
    for ks in range(full):
        s[ks % 4] = s[ks % 4] + parts[ks]
    for ks in range(full, len(parts)):
        s[0] = s[0] + parts[ks]
    return (s[0] + s[1]) + (s[2] + s[3])


def _dense(x, w, st, n, gates=1, slot=FG.SLOT_MAX):
    """A dense stage as the grid sums it: x [B, K] @ w [K, gates·n] →
    [B, gates·n], each column block from its slice, each k part summed in
    order, the parts gathered on four chains."""
    k = x.shape[1]
    slices = FG.grid_slices(w, st, n, gates)
    tile = FG.grid_tile(k // 4, st.width, st.tiles, slot)
    parts_k = FG.grid_part_k4(k // 4, tile)
    out = torch.zeros(x.shape[0], gates * n)
    per = st.width // gates
    for cb in range(st.cols):
        ws = slices[cb]
        parts = []
        for k4s in parts_k:
            acc = torch.zeros(x.shape[0], st.width)
            for k4 in k4s:
                for kk in range(4 * k4, 4 * k4 + 4):
                    acc = acc + x[:, kk, None] * ws[kk][None, :]
            parts.append(acc)
        blk = _gather4(parts)
        for gate in range(gates):
            cols = range(cb * per, min(n, (cb + 1) * per))
            out[:, gate * n + cols.start:gate * n + cols.stop] = blk[:, gate * per:gate * per + len(cols)]
    return out


def _warp_sum(v):
    """A warp's butterfly sum of 32 lane values → lane 0's."""
    v = v.clone()
    for o in (16, 8, 4, 2, 1):
        v = v + v[torch.arange(32) ^ o]
    return v[0]


def _block_sum(vals, per=THREADS):
    """block_reduce<false> of one value a thread (position i on thread i %
    per, each thread's in order)."""
    th = torch.zeros(THREADS)
    for i, x in enumerate(vals):
        th[i % per] = th[i % per] + x
    red = torch.stack([_warp_sum(th[32 * w:32 * w + 32]) for w in range(NWARPS)])
    return _warp_sum(torch.cat([red, torch.zeros(32 - NWARPS)]))


def _score(k, q, v):
    """One position's score: lane l sums float4s l, l + 32, ... of A in
    order, then the warp's butterfly."""
    lanes = torch.zeros(32)
    a4n = k.shape[0] // 4
    for lane in range(32):
        acc = torch.zeros(())
        for a4 in range(lane, a4n, 32):
            for c in range(4):
                acc = acc + torch.tanh(k[4 * a4 + c] + q[4 * a4 + c]) * v[4 * a4 + c]
        lanes[lane] = acc
    return _warp_sum(lanes)


def _emulate_grid(w, cfg, memory, mask, steps, grid):
    """The grid layout's decode in its summation order → (tokens [B, steps],
    [(step, row, context, plain context)] of the live rows)."""
    b, t, m = memory.shape
    plan = FG.decoder_plan(b, cfg, t, "grid", grid).grid
    st = plan.stages
    u, al, v_n = cfg.units, cfg.attention_layer_size, cfg.vocab_size
    keys = torch.einsum("btm,ma->bta", memory, w["wk"])
    tl = [int(torch.nonzero(mask[r]).max()) + 1 if mask[r].any() else 0 for r in range(b)]
    h = [torch.zeros(b, u) for _ in w["cells"]]
    c = [torch.zeros(b, u) for _ in w["cells"]]
    attn = torch.zeros(b, al)
    tok = torch.full((b,), cfg.bos_id, dtype=torch.long)
    fin = [False] * b
    tokens = torch.full((b, steps), cfg.eos_id, dtype=torch.int32)
    contexts = []
    tm = max(1, min(THREADS, plan.slot // m))  # the context's positions a tile
    dense = lambda *args, **kw: _dense(*args, **kw, slot=plan.slot)
    ts_n = max(1, THREADS // (m // 4))  # its parts of a tile's positions
    for s in range(steps):
        if all(fin):
            break
        x = torch.cat([w["emb"][tok], attn], 1)
        for i, (wx, wh, bias) in enumerate(w["cells"]):
            g = dense(torch.cat([x, h[i]], 1), torch.cat([wx, wh]), st[0 if i == 0 else 1], u, 4) + bias
            gi, gf, gg, go = g.split(u, 1)
            c[i] = torch.sigmoid(gf + 1.0) * c[i] + torch.sigmoid(gi) * torch.tanh(gg)
            h[i] = torch.sigmoid(go) * torch.tanh(c[i])
            x = h[i]
        q = dense(x, w["wq"], st[2], cfg.attention_units)
        ctx = torch.zeros(b, m)
        chunks = FG.grid_chunks(tl, fin, grid)
        for r in range(b):
            n = chunks[r]
            if n == 0:
                continue
            cs = -(-tl[r] // n)
            spans = [range(min(tl[r], ci * cs), min(tl[r], min(tl[r], ci * cs) + cs)) for ci in range(n)]
            sc = torch.stack([_score(keys[r, tt], q[r], w["v"]) + (1.0 - mask[r, tt]) * -1e9
                              for tt in range(tl[r])]) if tl[r] else torch.zeros(0)
            mx = max([float(sc[list(sp)].max()) for sp in spans if len(sp)], default=-np.inf)
            e = torch.exp(sc - mx) * mask[r, :tl[r]]
            csum = [_block_sum([e[tt] for tt in sp], tm) for sp in spans]
            total = torch.zeros(())
            for x_ in csum:
                total = total + x_
            total = torch.clamp_min(total, 1e-30)
            pctx = []  # each chunk's part, unnormalised
            for sp in spans:
                parts = [torch.zeros(m) for _ in range(ts_n)]
                for j0 in range(sp.start, sp.stop, tm):
                    for qi, tt in enumerate(range(j0, min(sp.stop, j0 + tm))):
                        parts[qi % ts_n] = parts[qi % ts_n] + e[tt] * memory[r, tt]
                cv = parts[0]
                for p_ in parts[1:]:
                    cv = cv + p_
                pctx.append(cv)
            for p_ in pctx:  # merged: each part over the row's sum, in chunk order
                ctx[r] = ctx[r] + p_ / total
            # the plain formula on the same scores
            probs = torch.exp(sc - sc.max()) * mask[r, :tl[r]] if tl[r] else torch.zeros(0)
            plain = (probs / torch.clamp_min(probs.sum(), 1e-30)) @ memory[r, :tl[r]] if tl[r] else torch.zeros(m)
            contexts.append((s, r, ctx[r].clone(), plain))
        attn = dense(torch.cat([x, ctx], 1), w["attn"], st[3], al)
        lg = dense(attn, w["out_w"], st[4], v_n) + w["out_b"]
        lw = st[4].width
        for r in range(b):
            best, bi = None, v_n
            for cb in range(st[4].cols):  # each block's first maximum, then the blocks in order
                cols = range(cb * lw, min(v_n, (cb + 1) * lw))
                if not len(cols):
                    continue
                blk = lg[r, cols.start:cols.stop]
                j = int(torch.argmax(blk))
                if bi == v_n or float(blk[j]) > best:
                    best, bi = float(blk[j]), cols.start + j
            token = cfg.eos_id if fin[r] else bi
            tokens[r, s] = token
            tok[r] = token
            fin[r] = fin[r] or token == cfg.eos_id
    return tokens, contexts


@pytest.mark.parametrize("grid", [132, 3])
def test_grid_order_matches_jax(grid):
    """Two cells of U = A = 32, M = 64, V = 26, four ragged rows (one of no
    valid position): the grid layout's reduction order, emulated over a
    grid of 132 blocks and of 3 (rows sharing blocks), gives the JAX
    reference kernel's tokens (``greedy_decode_fused`` in interpret mode)
    and contexts within 1e-6 of the plain formula's on the same scores."""
    jcfg = JaxSpellerConfig(vocab_size=26, embedding_dim=8, num_layers=2, units=32, memory_dim=64,
                            attention_type="bahdanau", attention_units=32, attention_layer_size=32)
    jp = jax_init_speller(jax.random.PRNGKey(3), jcfg)
    b, t, steps = 4, 40, 7
    rng = np.random.RandomState(17)
    mem = rng.randn(b, t, 64).astype(np.float32)
    lens = np.array([40, 23, 0, 31])
    mask = (np.arange(t)[None, :] < lens[:, None]).astype(np.float32)
    ref, _ = jax_greedy_decode_fused(jp, jcfg, jnp.asarray(mem), jnp.asarray(mask), max_steps=steps, interpret=True)
    f = lambda x: torch.from_numpy(np.array(x, dtype=np.float32))
    w = {"emb": f(jp.embedding), "wk": f(jp.attention.wk), "wq": f(jp.attention.wq), "v": f(jp.attention.v),
         "attn": f(jp.attention_layer), "out_w": f(jp.out_w), "out_b": f(jp.out_b),
         "cells": [(f(cl.wx), f(cl.wh), f(cl.b)) for cl in jp.cells]}
    cfg = SpellerConfig(vocab_size=26, embedding_dim=8, num_layers=2, units=32, memory_dim=64, attention_units=32,
                        attention_layer_size=32)
    with torch.no_grad():
        tokens, contexts = _emulate_grid(w, cfg, f(mem), f(mask), steps, grid)
    np.testing.assert_array_equal(tokens.numpy(), np.asarray(ref))
    assert contexts and any(r == 2 for _, r, _, _ in contexts)
    for s, r, got, want in contexts:
        assert float((got - want).abs().max()) <= 1e-6, (s, r)
        if r == 2:
            assert float(got.abs().max()) == 0.0  # no valid position: a zero context
