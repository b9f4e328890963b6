"""Fused greedy decoder: the CUDA kernel ``csrc/greedy.cu`` and its plain
PyTorch version.

Replaces the Pallas kernel ``phones_las_tpu/decode/pallas_greedy.py::
greedy_decode_fused``. A thread-block cluster of C blocks decodes a group
of ``GROUP_ROWS`` = 8 batch rows (the reference kernel's own group) and
loops over the steps inside the kernel; groups run in parallel, so every
batch size is served. In the dense stages (the cells, ``wq``, the
attention layer) each block owns a slice of the output columns and
computes it for all 8 rows, so a weight is read once per group and step;
activations travel between the blocks through distributed shared memory,
one cluster barrier a stage; attention runs per row, one row a block. The
output projection is sliced over the blocks as well: each block holds
``ceil(V / C)`` of its columns, and the rows' (maximum, first index) pairs
meet in every block, so the shared memory a block needs grows with V / C
(``decoder_smem_bytes``) and the phone vocabularies fit. Where the
activations that every block reads whole (each cell's h, the context, the
attention vector) do not fit in every block beside the rest — the speller
widths of LAS-4-1024, U = A = 1024, M = 2048 — the streamed layout keeps
them, and ``out_w``, in global memory (L2), written by their owners and
staged by the readers after the cluster barrier that already ends each
stage. Past what that layout holds (a row's scores grow with the encoder
length, a stage's input row with the widths) the tiled layout keeps each
row's scores in a global workspace and stages every input in tiles, so
every encoder length runs, and spellers up to U = A = AL = 2048, M = 4096.
Every width runs: a width that is no multiple of the kernel's
granularity is zero padded (``ops/padding.py``, exact) to one that a plan
takes (``kernel_widths``). A group stops
when all its rows have emitted <eos>; the last group is padded with rows
that start finished. The layout work the kernel needs (``column_slices``:
each block's weight slice made contiguous; ``pad_speller``), the kernel's
shared-memory layout and the choice of C and layout (``decoder_plan``,
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
cluster's shared memory, so they stream from L2 each step: ≈ 94 MB a step
at B = 64, which at ≈ 5.5 TB/s is the design's own floor of ≈ 17 µs a
step (3.4 ms for 200 steps).

Reproduced exactly from the reference kernel: the forget bias
hard-coded to 1.0, float32 dots, and the masked softmax
``exp(s − max)·mask / max(Σ, 1e-30)``, which differs from
``attention_scores``'s for a row with no valid position.
"""

from __future__ import annotations

import ctypes
import math
from types import SimpleNamespace
from typing import TYPE_CHECKING, List, NamedTuple, Optional, Tuple

import torch

from phones_las_torch.ops.attention import precompute_keys
from phones_las_torch.ops.padding import pad_blocks, pad_gates, round_up
from phones_las_torch.utils.device import check_kernel_device

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


KTILE = 2048  # tiled layout: floats of a row of the stage (csrc/greedy.cu's KTILE)
TTILE = 2048  # tiled layout: encoder positions of a tile of attention weights (TTILE)


def decoder_smem_bytes(b: int, t: int, cfg, c: int, streamed: bool = False, tiled: bool = False) -> int:
    """Shared memory a block of the kernel takes for ``t`` encoder
    positions under a cluster of ``c`` blocks, in the held, the streamed or
    (``tiled``, which implies streamed) the tiled layout: the Python mirror
    of ``csrc/greedy.cu::dec_layout`` (the same at every batch ``b``; the
    tiled layout's is the same at every ``t``). ``cfg`` is a
    ``SpellerConfig`` or ``DecoderWidths``."""
    del b  # a group's layout does not depend on the batch
    e, u, a, al = cfg.embedding_dim, cfg.units, cfg.attention_units, cfg.attention_layer_size
    m, n_cells, r = cfg.memory_dim, cfg.num_layers, GROUP_ROWS
    streamed = streamed or tiled
    vc = _pad4(-(-cfg.vocab_size // c))  # vocabulary columns a block owns
    kmax = max(e + al + u, 2 * u, u + m)
    kt = min(kmax, KTILE) if tiled else kmax  # a row of the stage
    widest = max(4 * u // c, a // c, al // c)
    held = 0 if streamed else 1  # each cell's h, the attention vector, the context, the out_w slice
    qrows = -(-r // c) if streamed else r
    floats = (
        r * kt + held * n_cells * 2 * r * u + n_cells * r * (u // c) + held * r * al + qrows * a
        + held * r * m  # stage .. ctx
        + max(THREADS * 4 * r, r * widest, THREADS * 4, m, (THREADS // 32) * r * vc)  # part
        + held * vc * (al + 4) + vc + n_cells * 4 * (u // c)  # out_w slice, out_b slice, biases
        + (TTILE if tiled else 2 * _pad4(t)) + _pad4(a) + r * vc  # scores (a tile of weights), mask, v, logits
        + 2 * 8 * r + 4 * r + 64  # the blocks' pairs, the rows' flags, the reduction
    )
    return 4 * floats


def decoder_act_floats(cfg) -> int:
    """Floats of one group's activations in global memory in the streamed
    layout (``csrc/greedy.cu::act_floats``): each cell's h [2][8][U], the
    attention vector [8][AL], the context [8][M]."""
    r = GROUP_ROWS
    return cfg.num_layers * 2 * r * cfg.units + r * cfg.attention_layer_size + r * cfg.memory_dim


class DecoderPlan(NamedTuple):
    """How one launch of the decoder kernel cuts its work."""

    cluster: int  # C: blocks of a cluster = column slices of every dense stage
    rows: int  # rows of a group (GROUP_ROWS)
    groups: int  # clusters of the launch: ceil(B / rows)
    streamed: bool = False  # the activations every block reads whole, and out_w, in global memory
    tiled: bool = False  # (streamed, and) the scores in global memory, every stage's input in tiles

    @property
    def layout(self) -> int:
        """The C API's layout argument: 0 held, 1 streamed, 2 tiled."""
        return 2 if self.tiled else int(self.streamed)


def _cuts(cfg) -> List[int]:
    """The cluster sizes that cut the units, the attention units and the
    attention layer into slices of a multiple of 4 columns."""
    return [c for c in DECODER_CLUSTERS
            if cfg.units % (4 * c) == 0 and cfg.attention_units % (4 * c) == 0
            and cfg.attention_layer_size % (4 * c) == 0]


def _first_fit(b: int, cfg, t: int) -> Optional[DecoderPlan]:
    for streamed, tiled in ((False, False), (True, False), (True, True)):
        for c in _cuts(cfg):
            if decoder_smem_bytes(b, t, cfg, c, streamed, tiled) <= SMEM_MAX:
                return DecoderPlan(c, GROUP_ROWS, -(-b // GROUP_ROWS), streamed, tiled)
    return None


def decoder_plan(b: int, cfg: "SpellerConfig", t: int = 1) -> DecoderPlan:
    """The kernel's cluster size and layout for a batch, ``t`` encoder
    positions and a config — a pure function.

    C is the largest of ``DECODER_CLUSTERS`` that cuts the units, the
    attention units and the attention layer into slices of a multiple of 4
    columns (16-byte loads) and whose held layout fits a block's shared
    memory (``decoder_smem_bytes`` ≤ ``SMEM_MAX``); where no cut's held
    layout fits, the largest cut whose streamed layout does; where none
    does either (long encoder sequences, wide spellers), the largest cut
    whose tiled layout does, which does not grow with T. Raises
    ``ValueError`` for widths the kernel does not take (every width a
    multiple of 4, the attention layer of 8: ``kernel_widths`` pads the
    others) and for a shape that no plan fits."""
    widths = {
        "embedding_dim": cfg.embedding_dim, "units": cfg.units, "attention_units": cfg.attention_units,
        "attention_layer_size": cfg.attention_layer_size, "memory_dim": cfg.memory_dim,
    }
    odd = {k: v for k, v in widths.items() if v % (8 if k == "attention_layer_size" else 4)}
    if odd or b < 1 or t < 1 or cfg.vocab_size < 1:
        raise ValueError(
            f"the fused greedy decoder takes a batch, encoder length and vocabulary >= 1 and widths that are "
            f"multiples of 4 (the attention layer of 8), got B={b}, T={t}, V={cfg.vocab_size}, {odd}"
        )
    plan = _first_fit(b, cfg, t)
    if plan is None:
        c = _cuts(cfg)[0]
        raise ValueError(
            f"the fused greedy decoder needs {decoder_smem_bytes(b, t, cfg, c, tiled=True)} bytes of shared memory "
            f"a block at T={t}, V={cfg.vocab_size}, {cfg.num_layers} cell(s) of {cfg.units} (cluster {c}, tiled), "
            f"over the {SMEM_MAX} bytes a block may use"
        )
    return plan


def kernel_widths(b: int, cfg, t: int) -> Tuple["DecoderWidths", DecoderPlan]:
    """The widths the kernel runs ``cfg`` at, and its plan there: each width
    rounded up to the kernel's granularity (E, U, A and M to 4, the
    attention layer to 8); where no plan fits those, also to the cut of C
    blocks (U, A and the attention layer to 4·C) for the largest C that
    fits. The padding is exact (``ops/padding.py``); raises ``ValueError``
    where nothing fits (``decoder_plan``'s message)."""
    w = DecoderWidths(cfg.vocab_size, round_up(cfg.embedding_dim, 4), round_up(cfg.units, 4),
                      round_up(cfg.attention_units, 4), round_up(cfg.attention_layer_size, 8),
                      round_up(cfg.memory_dim, 4), cfg.bos_id, cfg.eos_id, cfg.num_layers)
    candidates = [w] + [w._replace(units=round_up(w.units, 4 * c), attention_units=round_up(w.attention_units, 4 * c),
                                   attention_layer_size=round_up(w.attention_layer_size, math.lcm(8, 4 * c)))
                        for c in DECODER_CLUSTERS]
    for cand in candidates:
        if b >= 1 and t >= 1 and (plan := _first_fit(b, cand, t)) is not None:
            return cand, plan
    return w, decoder_plan(b, w, t)  # raises


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
            clocks: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One launch of the kernel (built at first use) → tokens. ``clocks``
    (measurements only), an int64 CUDA tensor of 16, receives the SM cycles
    the first block spent in each part of a step (``CLOCK_NAMES``) and,
    last, the steps it ran. Widths the kernel does not take as they are
    run zero padded (``kernel_widths``, ``pad_speller``)."""
    from phones_las_torch.csrc import _build

    lib = _build.library()
    b, t, _ = memory.shape
    kw, plan = kernel_widths(b, widths, t)
    c = plan.cluster
    dev = memory.device
    f32 = lambda x: x.detach().to(torch.float32).contiguous()
    weights, memory = pad_speller([f32(w) for w in flat_weights(params)], memory, widths, kw)
    params, _ = _unflatten(weights, memory, kw.bos_id, kw.eos_id)
    m = kw.memory_dim
    keys = precompute_keys(params.attention, memory).contiguous()
    mem = memory.contiguous()
    mask = enc_mask.to(torch.float32).contiguous()
    emb, v, out_w, out_b = f32(params.embedding), f32(params.attention.v), f32(params.out_w), f32(params.out_b)
    if emb.data_ptr() % 16:  # the kernel reads embedding rows in 16-byte loads
        emb = emb.clone()
    wq = column_slices(f32(params.attention.wq), c)
    attn_w = column_slices(f32(params.attention_layer), c)
    cells = []  # per cell: wx over wh [C, din + U, 4U/C], bias [C, 4U/C]
    for cell in params.cells:
        cells += [column_slices(torch.cat([f32(cell.wx), f32(cell.wh)]), c, gates=4),
                  column_slices(f32(cell.b), c, gates=4)]
    cell_ptrs = torch.tensor([x.data_ptr() for x in cells], dtype=torch.int64, device=dev)
    # the streamed and tiled layouts' activations, a group's each, zero before
    # the first step; the tiled layout's scores, a row's each
    act = torch.zeros((plan.groups, decoder_act_floats(kw)), device=dev) if plan.streamed else None
    ws = torch.zeros((plan.groups * plan.rows, t), device=dev) if plan.tiled else None
    tokens = torch.empty((b, max_steps), dtype=torch.int32, device=dev)
    info = (ctypes.c_int * 4)()
    err = lib.plt_greedy_decode(
        keys.data_ptr(), mem.data_ptr(), mask.data_ptr(), b, t,
        kw.attention_units, m, emb.data_ptr(), kw.vocab_size,
        kw.embedding_dim, wq.data_ptr(), v.data_ptr(), attn_w.data_ptr(),
        kw.attention_layer_size, out_w.data_ptr(), out_b.data_ptr(),
        cell_ptrs.data_ptr(), len(params.cells), kw.units, kw.bos_id,
        kw.eos_id, max_steps, c, plan.layout, None if act is None else act.data_ptr(),
        None if ws is None else ws.data_ptr(), tokens.data_ptr(), info, None if clocks is None else clocks.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    _build.check(err, "plt_greedy_decode")
    greedy_decode_fused.launches += 1
    greedy_decode_fused.streamed_launches += plan.streamed and not plan.tiled  # of them, in each wide layout
    greedy_decode_fused.tiled_launches += plan.tiled
    greedy_decode_fused.last_launch = {
        "cluster": c, "rows": plan.rows, "groups": plan.groups, "streamed": plan.streamed, "tiled": plan.tiled,
        "kernel_widths": {k: getattr(kw, k) for k in ("embedding_dim", "units", "attention_units",
                                                        "attention_layer_size", "memory_dim")},
        "smem_expected": decoder_smem_bytes(b, t, kw, c, plan.streamed, plan.tiled),
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
greedy_decode_fused.streamed_launches = 0
greedy_decode_fused.tiled_launches = 0
greedy_decode_fused.last_launch = None  # plan and occupancy of the last launch, for reports
