"""The decoder's grid layout with its stages ordered by readiness counters
(``csrc/greedy.cu::greedy_grid_kernel``) and the plan's step model on the
CPU.

A CUDA kernel does not run here, so what can go wrong in it is checked on
what the wrapper hands it and on models of what it does: the Python
mirrors of the .cu's layout functions, the plan's choice by the step
model at every decoder shape of PERF.md's row 3, an emulation of the
kernel's summation order (k parts, chunks, the softmax's second pass
folded into the context: each chunk's part divided by the row's sum after
the product) against the JAX reference, and a schedule model of the
readiness counters over three steps with lagging blocks."""

import os
import random
import re
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from phones_las_tpu.decode.greedy import greedy_decode as jax_greedy_decode
from phones_las_tpu.models.speller import SpellerConfig as JaxSpellerConfig
from phones_las_tpu.models.speller import embed_tokens, init_speller_carry, speller_step
from phones_las_tpu.models.speller import init_speller as jax_init_speller
from phones_las_tpu.ops.attention import precompute_keys as jax_precompute_keys

from phones_las_torch.decode import fused_greedy as FG
from phones_las_torch.models.speller import SpellerConfig
from tests.torch_threads import one_thread

one_thread()

CU = os.path.join(os.path.dirname(FG.__file__), "..", "csrc", "greedy.cu")
THREADS, NWARPS = FG.THREADS, FG.THREADS // 32


def _speller(u, m, a=None, al=None, v=34, e=128, n_cells=2):
    return SpellerConfig(vocab_size=v, embedding_dim=e, num_layers=n_cells, units=u, memory_dim=m,
                         attention_units=a or u, attention_layer_size=al or u)


CHECKPOINT = _speller(256, 512, v=26)
SPELLERS = {"checkpoint": CHECKPOINT, "one cell V=120": _speller(256, 512, v=120, n_cells=1),
            "G2P": _speller(160, 320, v=45, e=64, n_cells=1), "LAS 2x512": _speller(512, 512, al=256),
            "three cells": _speller(256, 512, n_cells=3), "W100": _speller(36, 200, 60, 256, e=32)}
BATCHES = (1, 8, 13, 32, 64, 133, 256)

# the shapes of PERF.md's row 3: (label, B, T_enc, speller); the plan
# takes the held layout at those named, fastest on an H100 (PERF.md §6)
HELD_TAKES = ("flagship", "flagship B=8", "G2P", "TIMIT", "grapheme head", "Common Voice")
ROW3 = [("flagship", 64, 250, CHECKPOINT), ("flagship B=8", 8, 250, CHECKPOINT),
        ("G2P", 64, 28, SPELLERS["G2P"]), ("TIMIT", 32, 400, _speller(256, 512, v=65, n_cells=1)),
        ("grapheme head", 32, 400, _speller(256, 512, v=32, n_cells=1)),
        ("Common Voice", 32, 438, _speller(256, 512, v=120, n_cells=1)),
        ("offline", 256, 438, _speller(256, 512)), ("W1024", 32, 219, _speller(1024, 2048, al=256)),
        ("W1024 T=438", 32, 438, _speller(1024, 2048, al=256)), ("W1024 AL=1024", 32, 219, _speller(1024, 2048)),
        ("LAS 2x512", 32, 438, SPELLERS["LAS 2x512"]), ("T=17100", 8, 17100, _speller(256, 512)),
        ("T=17100 one row", 1, 17100, _speller(256, 512)),
        ("T=40000", 8, 40000, _speller(256, 512)), ("W1024 speller T=5900", 8, 5900, _speller(1024, 2048, al=256)),
        ("W2048", 8, 219, _speller(2048, 4096))]


def _cu():
    return open(CU).read()


def _pad4(n):
    return -(-n // 4) * 4


def _round8(n):
    return -(-n // 8) * 8


def _c_to_py(expr):
    """A .cu size expression as Python: casts dropped, ``c ? x : y`` turned round."""
    expr = re.sub(r"\((?:size_t|int|unsigned)\)", "", expr)
    return re.sub(r"\(([^()?]+?) \? (\([^()]*\)|[^():]+?) : ([^()]+?)\)", r"(\2 if \1 else \3)", expr)


def _regions(function, env):
    body = re.search(rf"{function}\(.*?\n}}\n", _cu(), re.S).group(0)
    return [eval(_c_to_py(x), {}, env) for x in re.findall(r"off \+= ([^;]+);", body)]


def test_the_layout_functions_are_the_kernels():
    """``decoder_smem_bytes(grid=)`` and ``grid_act_floats`` are
    ``grid_layout``'s and ``grid_ws``'s regions as the .cu adds them, the
    ring's slot as large as fits (at least ``SLOT_STREAMED``, at most
    ``SLOT_MAX``), every shared-memory region starts 16-byte aligned, and
    the C API's cut is ``CUT_INTS`` ints."""
    for cfg in (CHECKPOINT, SPELLERS["G2P"], SPELLERS["three cells"], _speller(1024, 2048, al=256)):
        for b in (1, 8, 33, 256, 2920):
            g = FG.grid_cuts(b, cfg)
            assert FG.SLOT_STREAMED <= g.slot <= FG.SLOT_MAX and g.slot == FG._slot(b, cfg)
            a, m, n = cfg.attention_units, cfg.memory_dim, cfg.num_layers
            env = {"pad4": _pad4, "round8": _round8, "NSLOT": FG.NSLOT, "THREADS": THREADS, "A": a, "B": b,
                   "N_STAGES": len(FG.GRID_STAGES), "g": g}
            regions = _regions("GridLayout grid_layout", env)
            assert FG.decoder_smem_bytes(b, 219, cfg, 1, grid=g) == 4 * sum(regions)
            assert all(x % 4 == 0 for x in regions)  # every region starts 16-byte aligned (float4 and bulk copies)
            assert FG.decoder_smem_bytes(b, 219, cfg, 1, grid=g) <= FG.SMEM_MAX
            bp = _round8(b)
            ws = _regions("GridWs grid_ws", {"bp": bp, "chunks": _pad4(max(bp, g.blocks)), "nt": bp // 8,
                                             "n_cells": n, "U": cfg.units, "AL": cfg.attention_layer_size, "A": a,
                                             "M": m, "lcols": g.stages[-1].cols, "pad4": _pad4})
            assert FG.grid_act_floats(b, cfg, g) == sum(ws)
    cut_ints = int(re.search(r"constexpr int CUT_INTS = 5 \* N_STAGES \+ (\d+);", _cu()).group(1)) + 25
    assert FG.CUT_INTS == cut_ints == len(FG.grid_cuts(64, CHECKPOINT).flat())


@pytest.mark.parametrize("label,b,t,cfg", ROW3, ids=[r[0] for r in ROW3])
def test_the_plan_follows_the_step_model(label, b, t, cfg):
    """At each shape of row 3 the plan takes the layout whose modelled step
    is the shorter (``step_us``), and each layout forced is the plan of that
    layout or raises where it does not fit."""
    kw, plan = FG.kernel_widths(b, cfg, t)
    fits = {}
    for layout in ("held", "grid"):
        try:
            w2, p = FG.kernel_widths(b, cfg, t, layout)
        except ValueError:
            continue
        fits[layout] = FG.step_us(b, t, w2, p)
        assert p.name == layout
    assert plan.name in fits and FG.step_us(b, t, kw, plan) == min(fits.values())
    assert plan.name == ("held" if label in HELD_TAKES else "grid")
    assert FG.decoder_plan(b, kw, t) is FG.decoder_plan(b, kw, t)  # cached a shape


def test_forcing_a_layout_that_does_not_fit_raises():
    """``layout="held"`` raises where no cluster layout fits a block (W1024,
    long encoders), ``"grid"`` where no grid launch fits (M past 8 ·
    THREADS), and an unknown layout always."""
    with pytest.raises(ValueError, match="no held layout"):
        FG.decoder_plan(32, _speller(1024, 2048, al=256), 219, "held")
    with pytest.raises(ValueError, match="no held layout"):
        FG.kernel_widths(8, CHECKPOINT, 40000, "held")
    with pytest.raises(ValueError, match="no grid layout"):
        FG.decoder_plan(8, _speller(256, 8 * THREADS + 4), 219, "grid")
    with pytest.raises(ValueError, match="layout is one of"):
        FG.decoder_plan(8, CHECKPOINT, 219, "cluster")
    for layout in ("held", "grid"):
        assert FG.decoder_plan(64, CHECKPOINT, 250, layout).name == layout


# ---- the kernel's summation order, emulated, against JAX's greedy decode


def _gather4(parts):
    s = [torch.zeros_like(parts[0]) for _ in range(4)]
    full = len(parts) // 4 * 4
    for ks in range(full):
        s[ks % 4] = s[ks % 4] + parts[ks]
    for ks in range(full, len(parts)):
        s[0] = s[0] + parts[ks]
    return (s[0] + s[1]) + (s[2] + s[3])


def _dense(x, w, st, n, plan, gates=1):
    """A dense stage as the grid sums it: each column block from its
    slice, each k part summed in order, the parts on four chains."""
    k = x.shape[1]
    slices = FG.grid_slices(w, st, n, gates)
    tile = FG.grid_tile(k // 4, st.width, st.tiles, plan.slot)
    out = torch.zeros(x.shape[0], gates * n)
    per = st.width // gates
    for cb in range(st.cols):
        parts = []
        for k4s in FG.grid_part_k4(k // 4, tile):
            acc = torch.zeros(x.shape[0], st.width)
            for k4 in k4s:
                for kk in range(4 * k4, 4 * k4 + 4):
                    acc = acc + x[:, kk, None] * slices[cb][kk][None, :]
            parts.append(acc)
        blk = _gather4(parts)
        for gate in range(gates):
            cols = range(cb * per, min(n, (cb + 1) * per))
            out[:, gate * n + cols.start:gate * n + cols.stop] = blk[:, gate * per:gate * per + len(cols)]
    return out


def _butterfly(v):
    """A warp's butterfly sum over the last axis of 32 lanes → lane 0's."""
    for o in (16, 8, 4, 2, 1):
        v = v + v[..., torch.arange(32) ^ o]
    return v[..., 0]


def _block_sum(vals, per):
    """block_reduce<false> of one sum a thread, value q on thread q % per."""
    th = torch.zeros(THREADS)
    for q, x in enumerate(vals):
        th[q % per] = th[q % per] + x
    return _butterfly(torch.cat([_butterfly(th.view(NWARPS, 32)), torch.zeros(32 - NWARPS)]))


def _scores(k, q, v):
    """Each position's score: lane l sums float4s l, l + 32, ... of A in
    order, then the warp's butterfly."""
    x = torch.tanh(k + q) * v  # [T, A]
    lanes = torch.zeros(k.shape[0], 32)
    for a4 in range(k.shape[1] // 4):
        for c in range(4):
            lanes[:, a4 % 32] = lanes[:, a4 % 32] + x[:, 4 * a4 + c]
    return _butterfly(lanes)


def _emulate(w, cfg, memory, mask, steps, grid, plan):
    """The kernel's decode in its summation order → (tokens [B, steps],
    logits [steps, B, V])."""
    b, t, m = memory.shape
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
    logits = []
    tm = max(1, min(THREADS, plan.slot // m))  # the context's positions a tile
    ts_n = max(1, THREADS // (m // 4))  # its parts of a tile's positions
    for s in range(steps):
        if all(fin):
            break
        x = torch.cat([w["emb"][tok], attn], 1)
        for i, (wx, wh, bias) in enumerate(w["cells"]):
            g = _dense(torch.cat([x, h[i]], 1), torch.cat([wx, wh]), st[0 if i == 0 else 1], u, plan, 4) + bias
            gi, gf, gg, go = g.split(u, 1)
            c[i] = torch.sigmoid(gf + 1.0) * c[i] + torch.sigmoid(gi) * torch.tanh(gg)
            h[i] = torch.sigmoid(go) * torch.tanh(c[i])
            x = h[i]
        q = _dense(x, w["wq"], st[2], cfg.attention_units, plan)
        ctx = torch.zeros(b, m)
        chunks = FG.grid_chunks(tl, fin, grid)
        for r in range(b):
            n = chunks[r]
            if n == 0:
                continue
            cs = -(-tl[r] // n)
            spans = [range(min(tl[r], ci * cs), min(tl[r], min(tl[r], ci * cs) + cs)) for ci in range(n)]
            sc = _scores(keys[r, :tl[r]], q[r], w["v"]) + (1.0 - mask[r, :tl[r]]) * -1e9
            mx = max([float(sc[list(sp)].max()) for sp in spans if len(sp)], default=-np.inf)
            e = torch.exp(sc - mx) * mask[r, :tl[r]]
            csum, pctx = [], []
            for sp in spans:  # a chunk: e by position, its sum and its part of the context, unnormalised
                csum.append(_block_sum([e[tt] for tt in sp], tm))
                parts = [torch.zeros(m) for _ in range(ts_n)]
                for j0 in range(sp.start, sp.stop, tm):
                    for qi, tt in enumerate(range(j0, min(sp.stop, j0 + tm))):
                        parts[qi % ts_n] = parts[qi % ts_n] + e[tt] * memory[r, tt]
                cv = parts[0]
                for p_ in parts[1:]:
                    cv = cv + p_
                pctx.append(cv)
            total = torch.zeros(())
            for x_ in csum:
                total = total + x_
            total = torch.clamp_min(total, 1e-30)
            for p_ in pctx:  # the merge: each part over the row's sum, added in chunk order
                ctx[r] = ctx[r] + p_ / total
        attn = _dense(torch.cat([x, ctx], 1), w["attn"], st[3], al, plan)
        lg = _dense(attn, w["out_w"], st[4], v_n, plan) + w["out_b"]
        logits.append(lg)
        lw = st[4].width
        for r in range(b):
            best, bi = None, v_n
            for cb in range(st[4].cols):
                cols = range(cb * lw, min(v_n, (cb + 1) * lw))
                if not len(cols):
                    continue
                j = int(torch.argmax(lg[r, cols.start:cols.stop]))
                if bi == v_n or float(lg[r, cols.start + j]) > best:
                    best, bi = float(lg[r, cols.start + j]), cols.start + j
            token = cfg.eos_id if fin[r] else bi
            tokens[r, s] = token
            tok[r] = token
            fin[r] = fin[r] or token == cfg.eos_id
    return tokens, torch.stack(logits)


@pytest.mark.parametrize("n_cells,grid", [(1, 132), (2, 132), (2, 5)])
def test_the_kernels_order_matches_jax(n_cells, grid):
    """U = A = 32, M = 64, V = 26, a ragged batch of 13 rows (lengths 1..40):
    the grid layout's summation order, emulated over a grid of 132
    blocks (rows in several chunks) and of 5 (rows sharing blocks), decodes
    JAX ``greedy_decode``'s tokens, its logits within 1e-5 of JAX's
    ``speller_step`` on those tokens at every step a row is live."""
    jcfg = JaxSpellerConfig(vocab_size=26, embedding_dim=8, num_layers=n_cells, units=32, memory_dim=64,
                            attention_type="bahdanau", attention_units=32, attention_layer_size=32)
    jp = jax_init_speller(jax.random.PRNGKey(5 + n_cells), jcfg)
    b, t, steps = 13, 40, 6
    rng = np.random.RandomState(23)
    mem = rng.randn(b, t, 64).astype(np.float32)
    lens = rng.randint(1, t + 1, b)
    lens[0], lens[1] = t, 1
    mask = (np.arange(t)[None, :] < lens[:, None]).astype(np.float32)
    ref, _, _ = jax_greedy_decode(jp, jcfg, jnp.asarray(mem), jnp.asarray(mask), steps)
    ref = np.asarray(ref)
    # JAX's logits at each step, fed its own tokens
    keys = jax_precompute_keys(jp.attention, jnp.asarray(mem))
    carry = init_speller_carry(jcfg, b, t)
    token = jnp.full((b,), jcfg.bos_id, jnp.int32)
    ref_logits = []
    for s in range(steps):
        carry, lg, _ = speller_step(jp, jcfg, carry, embed_tokens(jp, jcfg, token), keys, jnp.asarray(mem),
                                    jnp.asarray(mask))
        ref_logits.append(np.asarray(lg))
        token = jnp.asarray(ref[:, s])
    f = lambda x: torch.from_numpy(np.array(x, dtype=np.float32))
    w = {"emb": f(jp.embedding), "wk": f(jp.attention.wk), "wq": f(jp.attention.wq), "v": f(jp.attention.v),
         "attn": f(jp.attention_layer), "out_w": f(jp.out_w), "out_b": f(jp.out_b),
         "cells": [(f(cl.wx), f(cl.wh), f(cl.b)) for cl in jp.cells]}
    cfg = SpellerConfig(vocab_size=26, embedding_dim=8, num_layers=n_cells, units=32, memory_dim=64,
                        attention_units=32, attention_layer_size=32)
    plan = FG.grid_cuts(b, cfg, grid)
    assert plan is not None
    with torch.no_grad():
        tokens, logits = _emulate(w, cfg, f(mem), f(mask), steps, grid, plan)
    np.testing.assert_array_equal(tokens.numpy(), ref)
    live = np.ones(b, bool)
    for s in range(logits.shape[0]):
        assert np.abs(logits[s].numpy()[live] - ref_logits[s][live]).max() <= 1e-5, s
        live &= ref[:, s] != jcfg.eos_id


# ---- the readiness counters: a schedule model of the kernel's waits


class _Sched:
    """Blocks as coroutines that run the kernel's stages step by step in
    the order of ``greedy_grid_kernel``, each wait a condition on the
    counters; a scheduler advances a random runnable block one action at a
    time (random delays). Every buffer region carries the step that wrote
    it; each read names the step it must see, so a read before its write
    and a write over a value still to be read both show as a wrong step."""

    def __init__(self, b, n_cells, grid, fin_at, double_h=True, pairs_guard=True):
        self.b, self.n, self.g = b, n_cells, grid
        self.nt = -(-b // 8)
        self.fin_at = fin_at  # the step at whose argmax each row finishes
        self.double_h, self.pairs_guard = double_h, pairs_guard
        self.cnt = {}
        self.mem = {}
        self.bad = []
        # cuts: (cols, groups, tiles of a group) a stage: cells, query, layer, logits
        self.cut = {"cell": (3, 2), "query": (2, 1), "layer": (2, 2), "logits": (2, 1)}

    def c(self, key):
        return self.cnt.get(key, 0)

    def write(self, key, s):
        self.mem[key] = s

    def read(self, key, want, care=True):
        """A read that must see step ``want``'s value, where ``care``: a
        dense stage's read of a row tile whose rows have all finished is
        discarded (its results are, and nothing waits on it)."""
        got = self.mem.get(key, -1)
        if got != want and care:
            self.bad.append((key, got, want))

    def tiles_of(self, stage, blk):
        cols, groups = self.cut[stage]
        if blk >= cols * groups:
            return None
        grp, cb = divmod(blk, cols)
        per = -(-self.nt // groups)
        return cb, range(grp * per, min(self.nt, (grp + 1) * per))

    def block(self, blk):
        b, g, n = self.b, self.g, self.n
        base = [0] * b
        fin = [False] * b
        for s in range(3):
            if all(fin):
                return
            chunks = FG.grid_chunks([10 + r for r in range(b)], fin, g)
            off = np.concatenate([[0], np.cumsum(chunks)]).tolist()
            hpar = lambda x: x % 2 if self.double_h else 0
            live = lambda tt: any(not fin[r] for r in range(8 * tt, min(b, 8 * tt + 8)))
            for l in range(n):
                cut = self.tiles_of("cell", blk)
                if cut:
                    cb, tiles = cut
                    for tt in tiles:
                        care = live(tt)
                        if l > 0:
                            yield lambda tt=tt, l=l: self.c(("h", l - 1, tt)) >= (s + 1) * self.cut["cell"][0]
                            yield None  # the block may lag between its wait and its reads
                            for cc in range(self.cut["cell"][0]):
                                self.read(("h", l - 1, hpar(s + 1), tt, cc), s, care)
                        else:
                            for cc in range(self.cut["layer"][0]):
                                self.read(("attn", tt, cc), s - 1, care)
                        for cc in range(self.cut["cell"][0]):
                            self.read(("h", l, hpar(s), tt, cc), s - 1, care)
                        yield None
                        self.write(("h", l, hpar(s + 1), tt, cb), s)
                        self.cnt[("h", l, tt)] = self.c(("h", l, tt)) + 1
            hcols = self.cut["cell"][0]
            cut = self.tiles_of("query", blk)
            if cut:
                cb, tiles = cut
                for tt in tiles:
                    yield lambda tt=tt: self.c(("h", n - 1, tt)) >= (s + 1) * hcols
                    yield None  # the block may lag between its wait and its reads
                    for cc in range(hcols):
                        self.read(("h", n - 1, hpar(s + 1), tt, cc), s, live(tt))
                    yield None
                    self.write(("q", tt, cb), s)
                    self.cnt[("q", tt)] = self.c(("q", tt)) + 1
            mine = list(range(blk, off[b], g))
            row = lambda idx: max(r for r in range(b) if off[r] <= idx)
            for idx in mine:
                r = row(idx)
                yield lambda r=r: self.c(("q", r // 8)) >= (s + 1) * self.cut["query"][0]
                yield None  # the block may lag between its wait and its reads
                for cc in range(self.cut["query"][0]):
                    self.read(("q", r // 8, cc), s)
                yield None
                self.write(("cmax", idx), s)
                self.cnt[("p1", r)] = self.c(("p1", r)) + 1
            for idx in mine:
                r = row(idx)
                want = base[r] + chunks[r]
                yield lambda r=r, want=want: self.c(("p1", r)) >= want
                yield None  # the block may lag between its wait and its reads
                for i in range(off[r], off[r + 1]):
                    self.read(("cmax", i), s)
                yield None
                self.write(("pctx", idx), s)
                self.cnt[("p2", r)] = self.c(("p2", r)) + 1
            for idx in mine:  # the merge: each chunk's block its slice of the row's context
                r = row(idx)
                want = base[r] + chunks[r]
                yield lambda r=r, want=want: self.c(("p2", r)) >= want
                yield None  # the block may lag between its wait and its reads
                for i in range(off[r], off[r + 1]):
                    self.read(("pctx", i), s)
                yield None
                self.write(("ctx", r, idx - off[r]), s)
                self.cnt[("ctx", r)] = self.c(("ctx", r)) + 1
            cut = self.tiles_of("layer", blk)
            if cut:
                cb, tiles = cut
                for tt in tiles:
                    rows = [r for r in range(8 * tt, min(b, 8 * tt + 8)) if not fin[r]]
                    yield lambda tt=tt, rows=rows: (self.c(("h", n - 1, tt)) >= (s + 1) * hcols
                                                    and all(self.c(("ctx", r)) >= base[r] + chunks[r] for r in rows))
                    yield None  # the block may lag between its wait and its reads
                    for cc in range(hcols):
                        self.read(("h", n - 1, hpar(s + 1), tt, cc), s, live(tt))
                    for r in rows:
                        for c in range(chunks[r]):
                            self.read(("ctx", r, c), s)
                    yield None
                    self.write(("attn", tt, cb), s)
                    self.cnt[("attn", tt)] = self.c(("attn", tt)) + 1
            ppar = s % 2 if self.pairs_guard else 0
            cut = self.tiles_of("logits", blk)
            if cut:
                cb, tiles = cut
                for tt in tiles:
                    yield lambda tt=tt: ((not self.pairs_guard or self.c(("done", s % 2)) >= s // 2 * g)
                                         and self.c(("attn", tt)) >= (s + 1) * self.cut["layer"][0])
                    yield None  # the block may lag between its wait and its reads
                    for cc in range(self.cut["layer"][0]):
                        self.read(("attn", tt, cc), s, live(tt))
                    yield None
                    self.write(("pairs", ppar, tt, cb), s)
                    self.cnt[("lg", tt)] = self.c(("lg", tt)) + 1
            yield lambda: all(self.c(("lg", tt)) >= (s + 1) * self.cut["logits"][0] for tt in range(self.nt))
            yield None  # the block may lag between its wait and its reads
            for tt in range(self.nt):
                for cc in range(self.cut["logits"][0]):
                    self.read(("pairs", ppar, tt, cc), s)
            yield None
            for r in range(b):
                base[r] += chunks[r]
                fin[r] = fin[r] or self.fin_at[r] <= s
            self.cnt[("done", s % 2)] = self.c(("done", s % 2)) + 1

    def run(self, seed, lagging=None):
        """Each block's actions take random times (a quarter of the blocks,
        or those ``lagging``, a thousand times longer); the block whose
        clock is earliest among those that may go acts next, and a waiting
        block's clock runs on."""
        rnd = random.Random(seed)
        blocks = {blk: self.block(blk) for blk in range(self.g)}
        waiting = {blk: None for blk in blocks}
        slow = {blk: rnd.choice((1.0, 1.0, 1.0, 1000.0)) if lagging is None else 1000.0 if blk in lagging else 1.0
                for blk in blocks}
        clock = {blk: 0.0 for blk in blocks}
        while blocks:
            ready = [k for k in blocks if waiting[k] is None or waiting[k]()]
            assert ready, "every block waits: the counters deadlock"
            k = min(ready, key=lambda x: clock[x])
            now = clock[k]
            for x in blocks:
                if x not in ready:
                    clock[x] = max(clock[x], now)
            try:
                waiting[k] = next(blocks[k])
                clock[k] = now + rnd.expovariate(1.0) * slow[k]
            except StopIteration:
                del blocks[k], waiting[k]
        return self.bad


@pytest.mark.parametrize("seed", range(12))
def test_every_read_waits_on_its_write(seed):
    """Three steps, blocks advanced in a random order: 20 rows (three row
    tiles) on 7 blocks, rows finishing at steps 0–2; and 3 rows on 12
    blocks, some of which take part in no stage but the argmax. Every read
    sees the value of the step it must see (no read before its write, no
    write over a value still to be read), and no block waits forever."""
    rnd = random.Random(1000 + seed)
    fin_at = [rnd.choice((0, 1, 2, 9)) for _ in range(20)]
    assert _Sched(20, 2, 7, fin_at).run(seed) == []
    assert _Sched(3, 2, 12, fin_at[:3]).run(seed) == []


def test_the_model_sees_a_missing_guard():
    """The model is not blind: h in one buffer (peers write this step's h
    while a cell still reads the last step's), or the pairs without their
    parity and the arrivals' guard (a block that takes part in no stage but
    the argmax may still read a step's pairs when the next step's are
    written), shows wrong reads under random delays."""
    assert any(_Sched(20, 2, 7, [9] * 20, double_h=False).run(seed) for seed in range(12))
    assert any(_Sched(3, 2, 12, [9] * 3, pairs_guard=False).run(seed, lagging={11}) for seed in range(12))
    assert not any(_Sched(3, 2, 12, [9] * 3).run(seed, lagging={11}) for seed in range(12))
