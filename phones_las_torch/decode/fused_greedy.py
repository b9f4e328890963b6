"""Fused greedy decoder: the CUDA kernel ``csrc/greedy.cu`` and its plain
PyTorch version.

Replaces the Pallas kernel ``phones_las_tpu/decode/pallas_greedy.py::
greedy_decode_fused``. Two layouts. The held one: a thread-block cluster
of C blocks decodes a group of ``GROUP_ROWS`` = 8 batch rows (the reference
kernel's own group) and loops over the steps inside the kernel; groups run
in parallel, so every batch size is served. In the dense stages (the
cells, ``wq``, the attention layer) each block owns a slice of the output
columns and computes it for all 8 rows, so a weight is read once per group
and step; activations travel between the blocks through distributed
shared memory, one cluster barrier a stage; attention runs per row, one
row a block. The output projection is sliced over the blocks as well: each
block holds ``ceil(V / C)`` of its columns, and the rows' (maximum, first
index) pairs meet in every block, so the shared memory a block needs grows
with V / C (``decoder_smem_bytes``) and the phone vocabularies fit. A group
stops when all its rows have emitted <eos>; the last group is padded with
rows that start finished.

The grid layout (``csrc/greedy.cu::greedy_grid_kernel``): one cooperative
launch of one block an SM, every block in every stage of a step, no grid
barrier between them: each stage's writers raise readiness counters of
the row tiles (or rows) they wrote and its readers wait on those of the
rows they read. Each dense stage's columns are cut over the grid
(``grid_cuts``: column blocks, and row groups where they cut the blocks'
intake), so a weight is read once a step for the whole batch (holding
each block's weights in its shared memory for the launch was measured
slower: the ring it leaves is smaller); each live row's attention is cut
over the grid in chunks of positions in proportion to its length
(``grid_chunks``): the chunks' maxima, then each chunk's sum and
unnormalised part of the context, merged in slices of columns by the
row's chunks' blocks (each part over the row's sum, in chunk order). It
takes every encoder length and spellers up to U = A = AL = 2048, M =
4096, and stops when every row has emitted <eos>. Every block keeps each row's flags in its shared memory, so a
launch takes at most ``grid_rows`` rows (2,920 at A = 1024, 2,584 at A =
2048); a larger batch is decoded in passes of rows, a launch each
(``DecoderPlan.passes``), so no batch size is refused.
The plan (``decoder_plan``) takes, at each shape, the layout whose step
is the shorter by a model fitted to the card's readings (``step_us``,
``HELD_MODEL``, ``GRID_MODEL``): on an NVIDIA H100 the held layout at the
serving shapes, the grid at offline B = 256, at the LAS paper's speller
and wherever the held layout does not fit (the speller widths of
LAS-4-1024, U = A = 1024, M = 2048; encoder lengths past a few thousand;
vocabularies past a few thousand entries). ``layout`` forces one
(``LAYOUTS``), for readings in turns.
Every width runs: a width that is no multiple of the kernel's
granularity is zero padded (``ops/padding.py``, exact) to one that a plan
takes (``kernel_widths``). The layout work the kernel needs
(``column_slices``, ``grid_slices``: each block's weight slice made
contiguous; ``pad_speller``), the kernel's shared-memory layouts, the grid
layout's workspace and the choice of layout and cut (``decoder_plan``,
which refuses a shape that no plan fits before any launch) are here, where
the CPU tests reach them.
The kernel is the operator ``torch.ops.phones_las_torch.greedy_decode_fused``
(the speller's weights flattened by ``flat_weights``; CPU: the plain
version, CUDA: the launch, widths read from the weights' shapes), so an
exported program holds it as one node.

Bounds on the H100 at the main path's shape (B = 64, T = 250, 200 steps,
2 × 256 cells): about 3.3 MFLOP of float32 per row and step, ≈ 0.6 ms at
67 TFLOP/s when every row runs to the cap — if the operands lay on chip.
The weights (≈ 5.6 MB) and a row's keys and memory (768 KB) exceed a
cluster's shared memory, so the held layout streams them from L2 each
step: ≈ 94 MB a step at B = 64, which at ≈ 5.5 TB/s is its own floor of
≈ 17 µs a step (3.4 ms for 200 steps). The grid layout reads the
weights once a step (L2-resident), so its floor is about the keys and
memory, 49 MB a step (9–15 µs), and what bounds it is its chain of
dependent stages.

Reproduced exactly from the reference kernel: the forget bias
hard-coded to 1.0, float32 dots, and the masked softmax
``exp(s − max)·mask / max(Σ, 1e-30)``, which differs from
``attention_scores``'s for a row with no valid position.
"""

from __future__ import annotations

import ctypes
import functools
import math
from types import SimpleNamespace
from typing import TYPE_CHECKING, List, NamedTuple, Optional, Tuple

import torch

from phones_las_torch.ops.attention import precompute_keys
from phones_las_torch.ops.padding import pad_blocks, pad_gates, round_up
from phones_las_torch.utils.device import check_kernel_device
from phones_las_torch.utils.diagnostics import annotate

if TYPE_CHECKING:  # the model code stays out of an exported program's loader
    from phones_las_torch.models.speller import SpellerConfig, SpellerParams

_NEG = -1e9
GROUP_ROWS = 8  # rows a cluster decodes together
DECODER_CLUSTERS = (8, 4, 2, 1)  # cluster sizes, tried in this order
THREADS = 512  # threads of a block (the kernel's THREADS)
SMEM_MAX = 232448  # shared memory a block may use on the H100 (the kernel's SMEM_MAX)
# what the kernel's optional cycle counters count, in order
CLOCK_NAMES = (
    "cell_staging", "cell_product", "cell_update", "cell_barrier", "query_product", "query_exchange",
    "scores", "softmax", "context", "context_exchange", "layer_staging", "layer_product",
    "layer_exchange", "logits", "argmax", "steps",
)
# the grid layout's counters: the stages (each with its ring), the waits on
# readiness counters (the dense stages' for their input rows, the
# attention's, the argmax's for every row tile's pairs), the context's
# merge; inside the stages, the ring's fills, its first tile's waits (its
# start-up), its other tiles' waits and its uses
GRID_CLOCK_NAMES = (
    "dense_fill", "cells", "ring_wait", "dense_waits", "query", "ring_first_wait", "scores",
    "softmax_context", "attention_waits", "context_merge", "ring_use", "layer", "logits", "argmax_wait",
    "argmax", "steps", "attention_fill", "dense_publish", "dense_epilogue",
)
CLOCKS = len(GRID_CLOCK_NAMES)  # the counters a measurement hands _launch (the held layout's 16 first)


def supports(cfg: "SpellerConfig") -> bool:
    return (
        cfg.attention_type == "bahdanau"
        and cfg.attention_layer_size > 0
        and cfg.binf_mode in ("none", "head")
    )


def decoded_lengths(tokens: torch.Tensor, eos_id: int) -> torch.Tensor:
    """[B, S] tokens → [B] count before the first <eos>."""
    return torch.sum(torch.cumsum(tokens == eos_id, dim=1) == 0, dim=1).to(torch.int32)


def greedy_decode_fused_plain(
    params: "SpellerParams",
    cfg: "SpellerConfig",
    memory: torch.Tensor,
    enc_mask: torch.Tensor,
    max_steps: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the kernel, with the kernel's own arithmetic
    → (tokens [B, max_steps] <eos>-padded, lengths [B])."""
    b = memory.shape[0]
    dev = memory.device
    keys = precompute_keys(params.attention, memory)
    mask = enc_mask.to(torch.float32)
    states = [
        (torch.zeros((b, cfg.units), device=dev), torch.zeros((b, cfg.units), device=dev))
        for _ in params.cells
    ]
    attn_vec = torch.zeros((b, cfg.attn_vec_dim), device=dev)
    token = torch.full((b,), cfg.bos_id, dtype=torch.long, device=dev)
    finished = torch.zeros((b,), dtype=torch.bool, device=dev)
    tokens = torch.full((b, max_steps), cfg.eos_id, dtype=torch.int32, device=dev)
    for s in range(max_steps):
        if bool(finished.all()):
            break
        x = torch.cat([params.embedding[token], attn_vec], dim=-1)
        for l, cell in enumerate(params.cells):
            h, c = states[l]
            gates = torch.matmul(x, cell.wx) + cell.b + torch.matmul(h, cell.wh)
            gi, gf, gg, go = torch.chunk(gates, 4, dim=-1)
            c = torch.sigmoid(gf + 1.0) * c + torch.sigmoid(gi) * torch.tanh(gg)
            h = torch.sigmoid(go) * torch.tanh(c)
            states[l] = (h, c)
            x = h
        q = torch.matmul(x, params.attention.wq)
        scores = torch.matmul(torch.tanh(keys + q[:, None, :]), params.attention.v)
        scores = scores + (1.0 - mask) * _NEG
        e = torch.exp(scores - torch.amax(scores, dim=-1, keepdim=True)) * mask
        probs = e / torch.clamp_min(torch.sum(e, dim=-1, keepdim=True), 1e-30)
        ctx = torch.einsum("bt,btm->bm", probs, memory)
        attn_vec = torch.matmul(torch.cat([x, ctx], dim=-1), params.attention_layer)
        logits = torch.matmul(attn_vec, params.out_w) + params.out_b
        nxt = torch.where(finished, cfg.eos_id, torch.argmax(logits, dim=-1))
        tokens[:, s] = nxt.to(torch.int32)
        token = nxt
        finished = finished | (nxt == cfg.eos_id)
    return tokens, decoded_lengths(tokens, cfg.eos_id)


def _pad4(n: int) -> int:
    return -(-n // 4) * 4


# the grid layout (csrc/greedy.cu's constants of the same names)
GRID_BLOCKS = 132  # blocks of the grid on an H100 SXM: one a streaming multiprocessor
SLOT_STREAMED = 12288  # the smallest slot of a launch (grid_rows)
SLOT_MAX = 16384  # floats of a slot at most: a cell's pass at the checkpoint's widths in two tiles
NSLOT = 3  # slots of the ring: two tiles in flight while one is used
KS_MAX = 32  # most parts a dense stage's k is split into
MAX_TILES = 128  # most row tiles of 8 in one pass of a dense stage
CUT_INTS = 26  # the C API's cut: each stage's five numbers, then the slot's floats
# the layouts a caller may ask for: None the plan (the faster of the held
# layout and the grid layout by the step model), "held" the held layout,
# "grid" the grid layout
LAYOUTS = (None, "held", "grid")
# the grid layout's dense stages, in the order of GridPlan.stages
GRID_STAGES = ("first cell", "other cells", "query", "attention layer", "logits")

# The step model, µs a step, that chooses the layout (``step_us``): the
# held layout waves · (a + bytes a block · (1 / r1 + blocks at once / r2))
# (its weights over the cluster and its rows' keys and memory, from L2
# shared by the clusters); the grid layout a0 + a1 · cells (the chain of
# dependent stages) + c · the ring's round trips a block (each dense
# stage's tiles, its share of the attention's tiles of keys and memory)
# + its FMAs a block / f. Fitted to ``chip_smoke.py --sweep-decoder``'s
# readings on an NVIDIA H100 80GB HBM3 (PERF.md, section 6).
HELD_MODEL = (23.5, 42.1e3, 4.92e6)  # a µs, r1 bytes/µs, r2 bytes/µs
GRID_MODEL = (45.2, 10.0, 2.73, 385e3)  # a0 µs, a1 µs a cell, c µs a round trip, f FMAs/µs


class StageCut(NamedTuple):
    """A dense stage of the grid layout cut over the grid: block ``g`` <
    ``cols * groups`` computes column block ``g % cols`` for the rows of
    row group ``g // cols``; a block takes its rows in passes of ``tiles``
    row tiles of 8."""

    cols: int  # column blocks: each a contiguous slice of the stage's weights
    width: int  # floats of a column block (a cell's: 4 gates of width / 4 units)
    groups: int  # row groups
    rows: int  # rows of a row group, a multiple of 8
    tiles: int  # row tiles of 8 a pass


class GridPlan(NamedTuple):
    """How the grid layout cuts a launch: one block an SM, every block in
    every stage of a step. (Each live row's attention is cut in the kernel,
    step by step, into chunks in proportion to its length: ``grid_chunks``.)"""

    blocks: int  # blocks of the grid, all co-resident
    stages: Tuple[StageCut, ...]  # GRID_STAGES' cuts
    slot: int = SLOT_MAX  # floats of a slot of the ring

    def flat(self) -> List[int]:
        """The C API's ``cut`` argument: each stage's five numbers, the slot."""
        return [x for st in self.stages for x in st] + [self.slot]


class DenseTile(NamedTuple):
    """How a pass of a grid dense stage cuts its k (``csrc/greedy.cu::
    grid_tile``): a thread an item (k part, row tile, column group of 4);
    tile j holds float4s [j·parts·s4, (j+1)·parts·s4) of k, part ks its
    float4s [ks·s4, (ks+1)·s4) of each tile."""

    parts: int  # k parts
    s4: int  # float4s of a part in a tile
    ld: int  # floats of a staged input row
    ntiles: int


def grid_tile(k4n: int, wc: int, tiles: int, slot: int = SLOT_MAX) -> DenseTile:
    """The cut of a pass whose k has ``k4n`` float4s, with a column block
    of ``wc`` columns and ``tiles`` row tiles: at most ``KS_MAX`` parts, as
    many as the threads hold, each part ``s4`` float4s of a tile as deep as
    a slot of ``slot`` floats holds (its input rows and its weight rows);
    of those, the cut of the fewest tiles (each a round trip through the
    ring), then of the most parts."""
    rp = 8 * tiles
    avail = (slot - 4 * rp) // (4 * (rp + wc))  # float4s of k a slot holds
    best = None
    for ks in range(max(1, min(KS_MAX, THREADS // (wc // 4 * tiles), k4n)), 0, -1):
        s4 = max(1, min(-(-k4n // ks), avail // ks))
        n = -(-k4n // (ks * s4))
        if best is None or n < best.ntiles:
            best = DenseTile(ks, s4, 4 * ks * s4 + 4, n)
    return best


def _tile_fits(k: int, st: "StageCut", slot: int) -> bool:
    """A pass's tile within a slot and its k parts' sums within the ring
    (``csrc/greedy.cu::bad_grid``)."""
    tile = grid_tile(k // 4, st.width, st.tiles, slot)
    rp = 8 * st.tiles
    return rp * tile.ld + 4 * tile.parts * tile.s4 * st.width <= slot and tile.parts * rp * st.width <= NSLOT * slot


def grid_part_k4(k4n: int, tile: DenseTile) -> List[List[int]]:
    """The float4s of k each part of a pass sums, in the order it sums them."""
    deep = tile.parts * tile.s4
    return [[k4 for k4 in range(k4n) if (k4 % deep) // tile.s4 == ks] for ks in range(tile.parts)]


def grid_chunks(tl: List[int], finished: List[bool], grid: int) -> List[int]:
    """Each row's attention chunks at a step (``csrc/greedy.cu``'s cut):
    a live row of ``tl`` valid positions takes 1 + floor((grid − live rows)
    · tl / Σ tl) chunks (one each past ``grid`` live rows), a finished row
    none; chunk index idx (rows in order) goes to block idx % grid."""
    live = [t for t, f in zip(tl, finished) if not f]
    spare, total = max(0, grid - len(live)), sum(live)
    return [0 if f else 1 + (spare * t // total if total else 0) for t, f in zip(tl, finished)]


def _stage_cut(b: int, n: int, grid: int, cells: bool) -> Optional[StageCut]:
    """The cut of a dense stage with ``n`` output columns (``cells``: ``n``
    units of 4 gate columns each) over ``grid`` blocks for ``b`` rows: the
    number of row groups R whose column blocks (``grid // R`` of them)
    take in the fewest floats a block, k · (width + rows) — a block reads
    its weight slice and its rows' inputs once a step —, the fewest groups
    on a tie."""
    n_tiles, n4, best = -(-b // 8), -(-n // 4), None
    for groups in range(1, min(n_tiles, grid) + 1):
        cols_max = grid // groups
        per = -(-n // cols_max) if cells else 4 * -(-n4 // cols_max)  # units, or columns, a block
        width = 4 * per if cells else per
        if width // 4 > THREADS:
            continue
        rows = 8 * -(-n_tiles // groups)
        if best is None or width + rows < best.width + best.rows:
            best = StageCut(-(-n // per), width, -(-b // rows), rows, min(rows // 8, THREADS // (width // 4), MAX_TILES))
    return best


def _stage_n(cfg) -> Tuple[int, ...]:
    """Each dense stage's outputs: units (the cells) or columns."""
    return (cfg.units, cfg.units, cfg.attention_units, cfg.attention_layer_size, cfg.vocab_size)


def _stage_mult(cfg) -> Tuple[int, ...]:
    """How many weight matrices each dense stage's cut serves: the other
    cells' is their number."""
    return (1, cfg.num_layers - 1, 1, 1, 1)


def _grid_fixed_floats(b: int, cfg) -> int:
    """Floats of a grid block's shared memory but the ring: the slots'
    barriers, each slot's mask or context weights, q and v of a row, every
    row's fed token, finished flag, length, chunks, chunks before this step
    and first chunk (B + 1), the flags, the reduction, each stage's tile
    cut."""
    return (_pad4(2 * NSLOT) + NSLOT * THREADS + 2 * _pad4(cfg.attention_units) + 5 * round_up(b, 8)
            + round_up(b + 1, 8) + 4 + 64 + 4 * len(GRID_STAGES))


def _slot(b: int, cfg) -> int:
    """The largest slot (at most ``SLOT_MAX``) whose ring fits a block beside
    the rows' flags."""
    return min(SLOT_MAX, (SMEM_MAX // 4 - _grid_fixed_floats(b, cfg)) // NSLOT // 4 * 4)


def _fit_tiles(k: int, st: StageCut, slot: int) -> Optional[StageCut]:
    """The cut with as many row tiles a pass (at most its own) as a slot holds."""
    for tiles in range(st.tiles, 0, -1):
        if _tile_fits(k, st._replace(tiles=tiles), slot):
            return st._replace(tiles=tiles)
    return None


def grid_cuts(b: int, cfg, grid: int = GRID_BLOCKS) -> Optional[GridPlan]:
    """The grid layout's cut of a batch of ``b`` rows over ``grid`` blocks
    (a pure function of the batch and the widths; no encoder length
    enters): the five dense stages' cuts, and the ring's slot, as large as
    fits beside the rows' flags (``_slot``). None where a stage cannot be
    cut."""
    u, a, al, v = cfg.units, cfg.attention_units, cfg.attention_layer_size, cfg.vocab_size
    stages = (_stage_cut(b, u, grid, True), _stage_cut(b, u, grid, True), _stage_cut(b, a, grid, False),
              _stage_cut(b, al, grid, False), _stage_cut(b, v, grid, False))
    slot = _slot(b, cfg)
    if b < 1 or grid < 1 or any(st is None for st in stages) or slot < SLOT_STREAMED:
        return None
    stages = tuple(_fit_tiles(k, st, slot) for k, st in zip(grid_stage_k(cfg), stages))
    return GridPlan(grid, stages, slot) if all(stages) else None


def grid_stage_k(cfg) -> Tuple[int, ...]:
    """The k (input floats) of each of GRID_STAGES' dense stages."""
    e, u, al, m = cfg.embedding_dim, cfg.units, cfg.attention_layer_size, cfg.memory_dim
    return (e + al + u, 2 * u, u, u + m, al)


def decoder_smem_bytes(b: int, t: int, cfg, c: int, grid: Optional[GridPlan] = None) -> int:
    """Shared memory a block of the kernel takes for ``t`` encoder
    positions under a cluster of ``c`` blocks in the held layout, or in
    the grid layout of ``grid`` for ``b`` rows (``c`` and ``t`` unused):
    the Python mirror of ``csrc/greedy.cu::dec_layout`` and
    ``grid_layout`` (the held layout's the same at every batch ``b``; the
    grid layout's the same at every ``t``). ``cfg`` is a ``SpellerConfig``
    or ``DecoderWidths``."""
    if grid is not None:  # the ring's slots, then the rest (_grid_fixed_floats)
        return 4 * (NSLOT * grid.slot + _grid_fixed_floats(b, cfg))
    e, u, a, al = cfg.embedding_dim, cfg.units, cfg.attention_units, cfg.attention_layer_size
    m, n_cells, r = cfg.memory_dim, cfg.num_layers, GROUP_ROWS
    vc = _pad4(-(-cfg.vocab_size // c))  # vocabulary columns a block owns
    kmax = max(e + al + u, 2 * u, u + m)  # a row of the stage
    widest = max(4 * u // c, a // c, al // c)
    floats = (
        r * kmax + n_cells * 2 * r * u + n_cells * r * (u // c) + r * al + r * a + r * m  # stage .. ctx
        + max(THREADS * 4 * r, r * widest, THREADS * 4, m, (THREADS // 32) * r * vc)  # part
        + vc * (al + 4) + vc + n_cells * 4 * (u // c)  # out_w slice, out_b slice, biases
        + 2 * _pad4(t) + _pad4(a) + r * vc  # scores, mask, v, logits
        + 2 * 8 * r + 4 * r + 64  # the blocks' pairs, the rows' flags, the reduction
    )
    return 4 * floats


def grid_rows(cfg) -> int:
    """The most rows one grid launch takes: the
    largest multiple of 8 whose flags (six ints a row) fit a block beside
    a ring of ``SLOT_STREAMED`` floats a slot; 0 where none do."""
    fixed = NSLOT * SLOT_STREAMED + _grid_fixed_floats(0, cfg) - 8  # the floats no row adds
    return max(0, (SMEM_MAX // 4 - fixed - 8) // 6 // 8 * 8)


def grid_act_floats(b: int, cfg, plan: GridPlan) -> int:
    """Floats of the grid layout's workspace in global memory
    (``csrc/greedy.cu::grid_ws``), for B rows padded to 8: each cell's h
    [2][B][U] and c [B][U], the attention vector [B][AL], q [B][A], the
    context [B][M], the chunks' maxima, sums and parts of the context (at
    most max(B, blocks) chunks), the logits' column blocks' (maximum,
    index) pairs [2][B][cols] (by step parity), every row's length, the
    counters (the prologue's barrier, the argmax's arrivals, each row
    tile's of h of each cell, q, the attention vector and the pairs, each
    row's of its chunks' maxima, parts and context)."""
    bp, n = round_up(b, 8), cfg.num_layers
    cl, chunks = plan.stages[-1].cols, _pad4(max(bp, plan.blocks))
    return (3 * n * bp * cfg.units + bp * (cfg.attention_layer_size + cfg.attention_units + cfg.memory_dim)
            + chunks * (2 + cfg.memory_dim) + 4 * _pad4(bp * cl) + bp + _pad4(4 + (n + 3) * bp // 8 + 3 * bp))


class DecoderPlan(NamedTuple):
    """How the decoder kernel cuts its work."""

    cluster: int  # C: blocks of a cluster = column slices of every dense stage (grid: 1, no cluster)
    rows: int  # rows of a group (GROUP_ROWS)
    groups: int  # clusters of the launch: ceil(B / rows)
    grid: Optional[GridPlan] = None  # the grid layout: its cut (no clusters, every block in every stage)
    passes: int = 1  # grid layout: launches, each a pass of ceil(B / passes) rows (the first pass's cut)

    @property
    def layout(self) -> int:
        """The C API's layout argument: 0 held, 1 grid."""
        return int(self.grid is not None)

    @property
    def name(self) -> str:
        """"held" or "grid"."""
        return "held" if self.grid is None else "grid"


def _cuts(cfg) -> List[int]:
    """The cluster sizes that cut the units, the attention units and the
    attention layer into slices of a multiple of 4 columns."""
    return [c for c in DECODER_CLUSTERS
            if cfg.units % (4 * c) == 0 and cfg.attention_units % (4 * c) == 0
            and cfg.attention_layer_size % (4 * c) == 0]


def _held_fit(b: int, cfg, t: int) -> Optional[DecoderPlan]:
    for c in _cuts(cfg):
        if decoder_smem_bytes(b, t, cfg, c) <= SMEM_MAX:
            return DecoderPlan(c, GROUP_ROWS, -(-b // GROUP_ROWS))
    return None


def _grid_fit(b: int, cfg, blocks: int) -> Optional[DecoderPlan]:
    most = grid_rows(cfg)
    if most < 1 or cfg.memory_dim > 8 * THREADS:
        return None
    passes = -(-b // most)
    g = grid_cuts(-(-b // passes), cfg, blocks)
    return None if g is None else DecoderPlan(1, GROUP_ROWS, -(-b // GROUP_ROWS), grid=g, passes=passes)


def _dense_weights(cfg) -> int:
    """Floats of the dense stages' weights a step reads."""
    return sum(m * k * n * (4 if i < 2 else 1)
               for i, (m, k, n) in enumerate(zip(_stage_mult(cfg), grid_stage_k(cfg), _stage_n(cfg))))


def grid_step_terms(b: int, t: int, cfg, g: GridPlan) -> Tuple[float, float]:
    """What the grid layout's step model counts for ``b`` rows of ``t``
    positions: a block's round trips through the ring (each dense stage's
    passes of tiles, its share of the attention's tiles of keys and of
    memory rows) and its FMAs."""
    mult, ks = _stage_mult(cfg), grid_stage_k(cfg)
    a, m = cfg.attention_units, cfg.memory_dim
    trips = sum(mu * -(-st.rows // (8 * st.tiles)) * grid_tile(k // 4, st.width, st.tiles, g.slot).ntiles
                for mu, k, st in zip(mult, ks, g.stages))
    pos = b * t / g.blocks  # a block's positions a step
    trips += -(-pos // max(1, g.slot // a)) + -(-pos // max(1, g.slot // m))
    fma = sum(mu * k * st.width * st.rows for mu, k, st in zip(mult, ks, g.stages))
    return trips, fma


def _grid_step_us(b: int, t: int, cfg, g: GridPlan) -> float:
    """The grid layout's modelled µs a step (GRID_MODEL): its chain, its
    most loaded block's round trips and FMAs (``grid_step_terms``)."""
    a0, a1, c, f = GRID_MODEL
    trips, fma = grid_step_terms(b, t, cfg, g)
    return a0 + a1 * cfg.num_layers + c * trips + fma / f


def step_us(b: int, t: int, cfg, plan: DecoderPlan, grid: int = GRID_BLOCKS) -> float:
    """The step model: a plan's modelled µs a step at ``b`` rows of ``t``
    encoder positions (HELD_MODEL, GRID_MODEL), a pass of rows after
    another."""
    if plan.grid is not None:
        return plan.passes * _grid_step_us(-(-b // plan.passes), t, cfg, plan.grid)
    a, r1, r2 = HELD_MODEL
    c = plan.cluster
    at_once = max(1, grid // c)  # clusters the card runs at once
    waves = -(-plan.groups // at_once)
    blocks = c * min(plan.groups, at_once)
    nbytes = 4 * (_dense_weights(cfg) / c + GROUP_ROWS / c * t * (cfg.attention_units + cfg.memory_dim))
    return waves * (a + nbytes * (1.0 / r1 + blocks / r2))


def _plan_key(cfg) -> Tuple[int, ...]:
    return (cfg.vocab_size, cfg.embedding_dim, cfg.units, cfg.attention_units, cfg.attention_layer_size,
            cfg.memory_dim, cfg.num_layers)


@functools.lru_cache(maxsize=4096)
def _plan(b: int, key: Tuple[int, ...], t: int, layout: Optional[str], grid: int) -> Optional[DecoderPlan]:
    with annotate("plt.plan"):  # cached: a span a plan made, on a new shape only
        cfg = SimpleNamespace(**dict(zip(("vocab_size", "embedding_dim", "units", "attention_units",
                                          "attention_layer_size", "memory_dim", "num_layers"), key)))
        if layout == "held":
            return _held_fit(b, cfg, t)
        if layout == "grid":
            return _grid_fit(b, cfg, grid)
        plans = [p for p in (_held_fit(b, cfg, t), _grid_fit(b, cfg, grid)) if p is not None]
        return min(plans, key=lambda p: step_us(b, t, cfg, p, grid)) if plans else None


def decoder_plan(b: int, cfg: "SpellerConfig", t: int = 1, layout: Optional[str] = None,
                 grid: int = GRID_BLOCKS) -> DecoderPlan:
    """The kernel's layout (and cluster size, or grid cut) for a batch,
    ``t`` encoder positions and a config — a pure function, cached a shape.

    The held layout: C is the largest of ``DECODER_CLUSTERS`` that cuts
    the units, the attention units and the attention layer into slices of
    a multiple of 4 columns (16-byte loads) and whose layout fits a block's
    shared memory (``decoder_smem_bytes`` ≤ ``SMEM_MAX``). The grid layout
    of ``grid`` blocks, in as few passes of rows as ``grid_rows`` allows,
    its blocks holding their weights where they fit and the step model
    says so (``grid_cuts``). The plan takes the one of the two that fit
    whose modelled step (``step_us``) is the shorter. ``layout`` forces a
    layout (``LAYOUTS``), for readings in turns. Raises ``ValueError`` for
    widths the kernel does not take (every width a multiple of 4, the
    attention layer of 8: ``kernel_widths`` pads the others) and for a
    shape that the layout asked for, or none, fits."""
    widths = {
        "embedding_dim": cfg.embedding_dim, "units": cfg.units, "attention_units": cfg.attention_units,
        "attention_layer_size": cfg.attention_layer_size, "memory_dim": cfg.memory_dim,
    }
    odd = {k: v for k, v in widths.items() if v % (8 if k == "attention_layer_size" else 4)}
    if layout not in LAYOUTS:
        raise ValueError(f"the fused greedy decoder's layout is one of {LAYOUTS}, got {layout!r}")
    if odd or b < 1 or t < 1 or cfg.vocab_size < 1:
        raise ValueError(
            f"the fused greedy decoder takes a batch, encoder length and vocabulary >= 1 and widths that are "
            f"multiples of 4 (the attention layer of 8), got B={b}, T={t}, V={cfg.vocab_size}, {odd}"
        )
    plan = _plan(b, _plan_key(cfg), t, layout, grid)
    if plan is not None:
        return plan
    raise ValueError(f"the fused greedy decoder fits {'no layout' if layout is None else f'no {layout} layout'} at "
                     f"B={b}, T={t}, {cfg.num_layers} cell(s) of {cfg.units}, attention {cfg.attention_units}, "
                     f"memory {cfg.memory_dim}: the grid layout of {grid} blocks takes {grid_rows(cfg)} rows a pass "
                     f"and M <= {8 * THREADS}")


def kernel_widths(b: int, cfg, t: int, layout: Optional[str] = None,
                  grid: int = GRID_BLOCKS) -> Tuple["DecoderWidths", DecoderPlan]:
    """The widths the kernel runs ``cfg`` at, and ``layout``'s plan there
    (``decoder_plan``): each width rounded up to the kernel's granularity
    (E, U, A and M to 4, the attention layer to 8). Where the held layout
    fits no cut of those, it is tried at the cut of C blocks (U, A and the
    attention layer to 4·C) for the largest C whose held layout fits; the
    plan (``layout`` None) then takes it if its modelled step is shorter
    than the grid layout's at the granular widths (the grid pads its own
    column blocks). The padding is exact (``ops/padding.py``); raises
    ``ValueError`` where nothing fits (``decoder_plan``'s message)."""
    w = DecoderWidths(cfg.vocab_size, round_up(cfg.embedding_dim, 4), round_up(cfg.units, 4),
                      round_up(cfg.attention_units, 4), round_up(cfg.attention_layer_size, 8),
                      round_up(cfg.memory_dim, 4), cfg.bos_id, cfg.eos_id, cfg.num_layers)
    if layout in (None, "held") and b >= 1 and t >= 1 and _held_fit(b, w, t) is None:
        for c in DECODER_CLUSTERS:
            cand = w._replace(units=round_up(w.units, 4 * c), attention_units=round_up(w.attention_units, 4 * c),
                              attention_layer_size=round_up(w.attention_layer_size, math.lcm(8, 4 * c)))
            if (held := _held_fit(b, cand, t)) is None:
                continue
            if layout == "held":
                return cand, held
            grid_plan = _plan(b, _plan_key(w), t, "grid", grid)
            if grid_plan is None or step_us(b, t, cand, held, grid) < step_us(b, t, w, grid_plan, grid):
                return cand, held
            break
    return w, decoder_plan(b, w, t, layout, grid)  # raises where nothing fits


def pad_speller(weights: List[torch.Tensor], memory: torch.Tensor, widths, kw) -> Tuple[List[torch.Tensor], torch.Tensor]:
    """``flat_weights`` of a speller of ``widths`` and its memory, zero
    padded to the kernel widths ``kw`` (``kernel_widths``) → (weights,
    memory): the embedding's columns; wk's rows (memory) and columns
    (attention units); wq's rows (units) and columns; v; the attention
    layer's rows ([h; context] → [Up; Mp]) and columns; out_w's rows; each
    cell's wx rows (the first cell's [embedding; attention vector], the
    others' h), wh rows and every gate's columns, bias. Exact: see
    ``ops/padding.py``. Unchanged where nothing grows."""
    e, u, a, al, m = (widths.embedding_dim, widths.units, widths.attention_units, widths.attention_layer_size,
                      widths.memory_dim)
    ep, up, ap, alp, mp = kw.embedding_dim, kw.units, kw.attention_units, kw.attention_layer_size, kw.memory_dim
    emb, wk, wq, v, attn_layer, out_w, out_b = weights[:7]
    out = [
        pad_blocks(emb, 1, [e], [ep]),
        pad_blocks(pad_blocks(wk, 0, [m], [mp]), 1, [a], [ap]),
        pad_blocks(pad_blocks(wq, 0, [u], [up]), 1, [a], [ap]),
        pad_blocks(v, 0, [a], [ap]),
        pad_blocks(pad_blocks(attn_layer, 0, [u, m], [up, mp]), 1, [al], [alp]),
        pad_blocks(out_w, 0, [al], [alp]),
        out_b,
    ]
    for i in range(7, len(weights), 3):
        wx, wh, bias = weights[i:i + 3]
        rows = ([e, al], [ep, alp]) if i == 7 else ([u], [up])
        out += [pad_gates(pad_blocks(wx, 0, *rows), u, up), pad_gates(pad_blocks(wh, 0, [u], [up]), u, up),
                pad_gates(bias, u, up)]
    return out, pad_blocks(memory, 2, [m], [mp])


def column_slices(w: torch.Tensor, c: int, gates: int = 1) -> torch.Tensor:
    """``w [..., gates·N]`` (gate-major columns) → ``[C, ..., gates·N/C]``:
    slice ``s`` holds columns ``[s·N/C, (s+1)·N/C)`` of every gate side by
    side, contiguous, as block ``s`` of a cluster streams them."""
    n = w.shape[-1] // gates
    if w.shape[-1] != gates * n or n % c:
        raise ValueError(f"column_slices: {tuple(w.shape)} does not cut into {c} slices of {gates} gates")
    lead = w.shape[:-1]
    x = w.reshape(*lead, gates, c, n // c)
    return x.movedim(-2, 0).reshape(c, *lead, gates * (n // c)).contiguous()


def grid_slices(w: torch.Tensor, cut: StageCut, n: int, gates: int = 1) -> torch.Tensor:
    """``w [..., gates·n]`` (gate-major columns) → ``[cut.cols, ...,
    cut.width]``: each gate's ``n`` columns zero padded to ``cols ·
    width / gates``, then ``column_slices``: column block ``s`` holds
    columns ``[s·w, (s+1)·w)`` of every gate (w = width / gates), as block
    ``s`` of a grid stage streams them."""
    per = cut.width // gates
    return column_slices(pad_blocks(w, -1, [n] * gates, [cut.cols * per] * gates), cut.cols, gates)


class DecoderWidths(NamedTuple):
    """What the kernel and its plain version read of a ``SpellerConfig``,
    taken from the weights' shapes inside the operator."""

    vocab_size: int
    embedding_dim: int
    units: int
    attention_units: int
    attention_layer_size: int
    memory_dim: int
    bos_id: int
    eos_id: int
    num_layers: int

    @property
    def attn_vec_dim(self) -> int:
        return self.attention_layer_size


def flat_weights(params: "SpellerParams") -> List[torch.Tensor]:
    """The speller's weights as the operator takes them: embedding, wk, wq,
    v, attention layer, out_w, out_b, then wx, wh, b of each cell."""
    a = params.attention
    ws = [params.embedding, a.wk, a.wq, a.v, params.attention_layer, params.out_w, params.out_b]
    for cell in params.cells:
        ws += [cell.wx, cell.wh, cell.b]
    return ws


def _unflatten(weights, memory: torch.Tensor, bos_id: int, eos_id: int):
    """``flat_weights``' list → (a view with the parameters' attribute
    names, ``DecoderWidths``)."""
    emb, wk, wq, v, attn_layer, out_w, out_b = weights[:7]
    cells = [SimpleNamespace(wx=weights[i], wh=weights[i + 1], b=weights[i + 2]) for i in range(7, len(weights), 3)]
    params = SimpleNamespace(
        embedding=emb, attention=SimpleNamespace(wk=wk, wq=wq, v=v), attention_layer=attn_layer,
        out_w=out_w, out_b=out_b, cells=cells,
    )
    widths = DecoderWidths(
        out_w.shape[1], emb.shape[1], cells[0].wh.shape[0], wq.shape[1], attn_layer.shape[1],
        memory.shape[2], bos_id, eos_id, len(cells),
    )
    return params, widths


@torch.library.custom_op("phones_las_torch::greedy_decode_fused", mutates_args=(), device_types="cpu")
def greedy_decode_fused_op(
    memory: torch.Tensor, enc_mask: torch.Tensor, weights: List[torch.Tensor], bos_id: int, eos_id: int,
    max_steps: int,
) -> torch.Tensor:
    """The kernel as an operator → tokens [B, max_steps] int32: the plain
    version on the CPU, the kernel on CUDA, exact shapes for tracing.
    ``weights`` is ``flat_weights`` of the speller."""
    params, widths = _unflatten(weights, memory, bos_id, eos_id)
    return greedy_decode_fused_plain(params, widths, memory, enc_mask, max_steps)[0]


@greedy_decode_fused_op.register_kernel("cuda")
def _(memory, enc_mask, weights, bos_id, eos_id, max_steps):
    check_kernel_device(memory, enc_mask, *weights)  # raises on mixed devices
    params, widths = _unflatten(weights, memory, bos_id, eos_id)
    return _launch(params, widths, memory, enc_mask, max_steps)


@greedy_decode_fused_op.register_fake
def _(memory, enc_mask, weights, bos_id, eos_id, max_steps):
    return memory.new_empty((memory.shape[0], max_steps), dtype=torch.int32)


def _launch(params, widths: DecoderWidths, memory, enc_mask, max_steps: int,
            clocks: Optional[torch.Tensor] = None, layout: Optional[str] = None) -> torch.Tensor:
    """The kernel's launches (built at first use) → tokens: one, or (the
    grid layout past ``grid_rows``) one a pass of rows. ``clocks``
    (measurements only), an int64 CUDA tensor of ``CLOCKS``, receives the SM
    cycles the first block spent in each part of a step (``CLOCK_NAMES``;
    the grid layout's ``GRID_CLOCK_NAMES``) and, at 15, the steps it ran. ``layout``
    forces a layout (``decoder_plan``; measurements only); the grid layout
    takes as many blocks as the card has SMs. Widths the kernel does not
    take as they are run zero padded (``kernel_widths``, ``pad_speller``).
    The host's work before each launch is the span ``plt.decode.prep``."""
    from phones_las_torch.csrc import _build

    lib = _build.library()
    b, t, _ = memory.shape
    dev = memory.device
    with annotate("plt.decode.prep"):  # the plan; the rest of the prep below
        kw, plan = kernel_widths(b, widths, t, layout, torch.cuda.get_device_properties(dev).multi_processor_count)
    if plan.passes > 1:  # more rows than a grid launch holds: a launch a pass
        n = -(-b // plan.passes)
        tokens = torch.cat([_launch(params, widths, memory[r:r + n], enc_mask[r:r + n], max_steps, clocks, layout)
                            for r in range(0, b, n)])
        greedy_decode_fused.last_launch["passes"] = plan.passes
        return tokens
    with annotate("plt.decode.prep"):  # everything else before the launch, a pass
        g = plan.grid
        c = g.blocks if g is not None else plan.cluster  # the C API's cluster argument: the grid's blocks there
        f32 = lambda x: x.detach().to(torch.float32).contiguous()
        weights, memory = pad_speller([f32(w) for w in flat_weights(params)], memory, widths, kw)
        params, _ = _unflatten(weights, memory, kw.bos_id, kw.eos_id)
        u, a, al, m, v_n = kw.units, kw.attention_units, kw.attention_layer_size, kw.memory_dim, kw.vocab_size
        keys = precompute_keys(params.attention, memory).contiguous()
        mem = memory.contiguous()
        mask = enc_mask.to(torch.float32).contiguous()
        emb, v, out_w, out_b = f32(params.embedding), f32(params.attention.v), f32(params.out_w), f32(params.out_b)
        if emb.data_ptr() % 16:  # the kernel reads embedding rows in 16-byte loads
            emb = emb.clone()
        cells = []  # per cell: wx over wh [slices, din + U, width], bias [slices, width]
        if g is None:  # a cluster's column slices
            wq = column_slices(f32(params.attention.wq), c)
            attn_w = column_slices(f32(params.attention_layer), c)
            for cell in params.cells:
                cells += [column_slices(torch.cat([f32(cell.wx), f32(cell.wh)]), c, gates=4),
                          column_slices(f32(cell.b), c, gates=4)]
        else:  # the grid's column blocks, each stage its own cut; out_w and out_b too
            wq = grid_slices(f32(params.attention.wq), g.stages[2], a)
            attn_w = grid_slices(f32(params.attention_layer), g.stages[3], al)
            for i, cell in enumerate(params.cells):
                cut = g.stages[0 if i == 0 else 1]
                cells += [grid_slices(torch.cat([f32(cell.wx), f32(cell.wh)]), cut, u, 4),
                          grid_slices(f32(cell.b), cut, u, 4)]
            out_w, out_b = grid_slices(out_w, g.stages[4], v_n), grid_slices(out_b, g.stages[4], v_n)
        cell_ptrs = torch.tensor([x.data_ptr() for x in cells], dtype=torch.int64, device=dev)
        # the grid layout's workspace (zero: h, c and the attention vector before
        # the first step, the barrier's counter) and its rows' scores
        act = torch.zeros(grid_act_floats(b, kw, g), device=dev) if g is not None else None
        ws = torch.empty((round_up(b, GROUP_ROWS), t), device=dev) if g is not None else None
        cut = (ctypes.c_int * len(g.flat()))(*g.flat()) if g is not None else None
        tokens = torch.empty((b, max_steps), dtype=torch.int32, device=dev)
        info = (ctypes.c_int * 4)()
    err = lib.plt_greedy_decode(
        keys.data_ptr(), mem.data_ptr(), mask.data_ptr(), b, t, a, m, emb.data_ptr(), v_n,
        kw.embedding_dim, wq.data_ptr(), v.data_ptr(), attn_w.data_ptr(), al, out_w.data_ptr(), out_b.data_ptr(),
        cell_ptrs.data_ptr(), len(params.cells), u, kw.bos_id, kw.eos_id, max_steps, c, plan.layout,
        None if act is None else act.data_ptr(), None if ws is None else ws.data_ptr(), cut, tokens.data_ptr(),
        info, None if clocks is None else clocks.data_ptr(), torch.cuda.current_stream(dev).cuda_stream,
    )
    _build.check(err, "plt_greedy_decode")
    greedy_decode_fused.launches += 1
    greedy_decode_fused.grid_launches += plan.layout == 1  # of them, in the grid layout
    greedy_decode_fused.last_launch = {
        "layout": plan.name, "modelled_us_per_step": step_us(b, t, kw, plan, g.blocks if g is not None else GRID_BLOCKS),
        "cluster": plan.cluster, "rows": plan.rows, "groups": plan.groups, "passes": plan.passes,
        "grid": None if g is None else {"blocks": g.blocks, "slot": g.slot, **{
            name: st._asdict() for name, st in zip(GRID_STAGES, g.stages)}},
        "kernel_widths": {k: getattr(kw, k) for k in ("embedding_dim", "units", "attention_units",
                                                        "attention_layer_size", "memory_dim")},
        "smem_expected": decoder_smem_bytes(b, t, kw, plan.cluster, g),
        # clusters (grid: blocks) the card runs at once
        "max_active_clusters": info[0], "smem_bytes": info[1], "registers": info[2], "static_smem_bytes": info[3],
    }
    return tokens


def greedy_decode_fused(
    params: "SpellerParams",
    cfg: "SpellerConfig",
    memory: torch.Tensor,  # [B, T, M] float32
    enc_mask: torch.Tensor,  # [B, T]
    max_steps: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """→ (tokens [B, max_steps] <eos>-padded, lengths [B]), through the
    operator ``torch.ops.phones_las_torch.greedy_decode_fused``.

    A CPU tensor runs the plain version; a CUDA tensor launches the
    kernel (built at first use) or raises."""
    if not supports(cfg):
        raise ValueError("the fused greedy decoder takes bahdanau attention with an attention layer")
    if memory.ndim != 3 or memory.dtype != torch.float32:
        raise ValueError(f"memory must be [B, T, M] float32, got {tuple(memory.shape)} {memory.dtype}")
    b, t, m = memory.shape
    if enc_mask.shape != (b, t) or m != cfg.memory_dim:
        raise ValueError(f"enc_mask {tuple(enc_mask.shape)} / memory {tuple(memory.shape)} do not match the config")
    weights = flat_weights(params)
    check_kernel_device(memory, enc_mask, *weights)
    tokens = torch.ops.phones_las_torch.greedy_decode_fused(memory, enc_mask, weights, cfg.bos_id, cfg.eos_id, max_steps)
    return tokens, decoded_lengths(tokens, cfg.eos_id)


greedy_decode_fused.launches = 0
greedy_decode_fused.grid_launches = 0
greedy_decode_fused.last_launch = None  # plan and occupancy of the last launch, for reports
