"""LSTM layers (port of ``phones_las_tpu/ops/lstm.py``).

Cell semantics as the reference (TF1 ``BasicLSTMCell``): parameters
``wx [D, 4U]``, ``wh [U, 4U]`` and one bias ``b [4U]``, gate order
(i, f, g, o), and ``forget_bias`` added to the forget preactivation at
run time, not folded into the stored bias. Per-step masking reproduces
``dynamic_rnn(sequence_length=...)``: the state freezes and the output
is zero past each row's length. ``torch.nn.LSTM`` is not used.

The input projection ``x @ wx + b`` for all steps is one matrix product;
the serial recurrence ``gates = xp[t] + h @ wh`` runs as a CUDA kernel
(``csrc/lstm.cu``) on CUDA tensors and as its plain PyTorch version on
CPU tensors:

* without gradients, ``bidir_recurrence`` runs both directions of a
  BiLSTM layer (through the operator
  ``torch.ops.phones_las_torch.bidir_recurrence``, which an exported
  program holds as one node) and ``recurrence`` one direction of
  ``lstm_layer``, each one launch of the same primal kernel;
* under gradients, ``RecurrenceFunction`` and ``BidirRecurrenceFunction``
  (the reference's custom VJPs ``pallas_recurrence`` and
  ``pallas_bidir_recurrence``) run ``recurrence_residual`` forward, which
  also saves the carried state before each step, and ``recurrence_bwd``
  backward.

The forward kernel, up to the widths whose slices a cluster holds (U up to
256 in float32, 384 in bf16), is one template launched as thread-block
clusters: a cluster of C blocks runs one direction for a tile of Bt batch
rows over all T steps, block c owning units ``[c·U/C, (c+1)·U/C)`` with
their four gate columns and holding that slice of ``wh`` in shared memory
for the whole time loop; each step the blocks exchange their h slices
through distributed shared memory (``st.async`` onto transaction
barriers). Past those widths, up to U = ``MAX_UNITS`` = 2048, and below
them where a cut fits a block only without its slice, the grid layout
(``lstm_grid_kernel``, ``lstm_grid_bf16_kernel`` on wgmma,
``lstm_grid_mma_kernel`` on mma.sync; ``grid_plan``): one cooperative
launch of one block an SM, each block a run of units of one direction with
its slice of ``wh`` in shared memory as far as it fits, h through global
memory, each chunk published on a readiness counter and taken in by bulk
copies that overlap the product as soon as its writers have published it
(no grid barrier); a batch past the rows one launch holds runs in passes
of rows. The VJP's serial loop, up to ``GRID_UNITS_BWD`` =
512 in float32 and 384 in bf16, is the template's design run backwards in
time: block c multiplies the gate gradients of its own units by its slice
of ``whᵀ`` (resident, or streamed by the threads' loads) into a partial dh
of every unit, the blocks send each other the parts they own and add them
in rank order (so repeated runs are bitwise equal). Past those widths its
own grid layout (``lstm_bwd_grid_kernel``, ``lstm_bwd_grid_bf16_kernel``;
``grid_bwd_plan``): one cooperative launch in clusters of cl blocks, a
cluster's blocks the k pieces of a group of output units, each block's tile
of ``whᵀ`` in shared memory as far as it fits, the gate gradients through
global memory behind one grid barrier a step, the cluster's partial dh
added in rank order. What of this is layout and choice lives here, where
the CPU tests reach it: ``regroup_wh``/``ungroup_wh``, ``grid_wh``/
``ungrid_wh`` and ``grid_wht``/``ungrid_wht`` (``wh`` and ``whᵀ`` by the
blocks' cuts), ``grid_h``/``ungrid_h`` (the forward's h buffers),
``forward_plan``, ``grid_plan``, ``backward_plan`` and
``grid_bwd_plan`` (the route, the cut, the shared-memory bytes and the
width the kernel runs at, from the shape, pure functions; the grid
layouts' cuts from a step's cost, ``_grid_step_cycles`` and
``_grid_bwd_step_cycles``). Every U from 1 to ``MAX_UNITS`` runs on the
card: a U that is no multiple of 8, or that no cut fits, runs at a wider U
with zero padding (``ops/padding.py``: exact), the results sliced back;
``tests/test_torch_cluster_layout.py``, ``tests/test_torch_lstm_grid.py``,
``tests/test_torch_lstm_bwd_layout.py`` and ``tests/test_torch_vjp_grid.py``
emulate the decompositions in plain PyTorch on them.

Recurrent-dot precision is an explicit argument ``prec`` (the reference
reads it from the ambient ``jax.default_matmul_precision`` scope):
'highest' is float32; 'bf16' rounds h and wh to bf16 and accumulates in
float32, with the gate math and the cell state in float32. In bf16 mode
the reference streams ``xp``, the outputs and ``dxp`` in bf16; the port
keeps them float32 and stores only the residuals ``hprev``/``cprev`` in
bf16, as the reference does.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Callable, List, NamedTuple, Optional, Sequence, Tuple

import torch
from torch import nn

from phones_las_torch.ops.masking import length_mask
from phones_las_torch.ops.padding import pad_gates, pad_lstm_wh, pad_units, round_up, slice_gates
from phones_las_torch.utils.device import check_kernel_device

PRECISIONS = ("highest", "bf16")


class LSTMParams(nn.Module):
    """One direction's parameters. wx: [D, 4U], wh: [U, 4U], b: [4U]."""

    def __init__(self, input_dim: int, units: int, device=None):
        super().__init__()
        z = lambda *shape: nn.Parameter(torch.zeros(shape, device=device), requires_grad=False)
        self.wx = z(input_dim, 4 * units)
        self.wh = z(units, 4 * units)
        self.b = z(4 * units)

    @property
    def units(self) -> int:
        return self.wh.shape[0]


def uniform_(t: torch.Tensor, limit: float, generator: torch.Generator) -> torch.Tensor:
    """Fill ``t`` with U(-limit, limit) drawn on the CPU from ``generator``
    (so one seed gives the same weights on every device)."""
    with torch.no_grad():
        r = torch.rand(t.shape, generator=generator, dtype=torch.float32)
        return t.copy_((r * 2.0 - 1.0) * limit)


def glorot_(t: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
    """Glorot-uniform fill of a [fan_in, fan_out] matrix, in place."""
    return uniform_(t, math.sqrt(6.0 / (t.shape[0] + t.shape[1])), generator)


def glorot_lstm_(p: LSTMParams, generator: torch.Generator) -> LSTMParams:
    """Glorot-uniform kernels (TF1 default initializer), zero bias, in place.

    TF1's LSTMCell holds ONE concatenated kernel [D+U, 4U], so glorot's
    fan-in is D+U for both halves: wx and wh share the limit
    sqrt(6/(D+U+4U))."""
    d, u = p.wx.shape[0], p.units
    limit = math.sqrt(6.0 / (d + u + 4 * u))
    uniform_(p.wx, limit, generator)
    uniform_(p.wh, limit, generator)
    with torch.no_grad():
        p.b.zero_()
    return p


def init_lstm_params(input_dim: int, units: int, generator: torch.Generator, device=None) -> LSTMParams:
    """The reference's ``init_lstm_params``: ``glorot_lstm_`` of fresh parameters."""
    return glorot_lstm_(LSTMParams(input_dim, units, device), generator)


def resolve_rnn_precision(matmul_precision: Optional[str] = None) -> str:
    """The reference's rule, with its ambient matmul-precision scope given
    explicitly (``LASConfig.matmul_precision``): 'highest' and 'bf16' are
    kept; 'default', 'fastest' and 'bfloat16' map to the bf16 recurrent
    dot; anything else (including None) to the float32 one."""
    if matmul_precision in PRECISIONS:
        return matmul_precision
    return "bf16" if matmul_precision in ("default", "fastest", "bfloat16") else "highest"


def _check_prec(prec: str) -> None:
    if prec not in PRECISIONS:
        raise ValueError(f"prec must be one of {PRECISIONS}, got {prec!r}")


def _cell_math(gates: torch.Tensor, c: torch.Tensor, forget_bias: float):
    i, f, g, o = torch.chunk(gates, 4, dim=-1)
    c_new = torch.sigmoid(f + forget_bias) * c + torch.sigmoid(i) * torch.tanh(g)
    h_new = torch.sigmoid(o) * torch.tanh(c_new)
    return h_new, c_new


def _bf16_round(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).to(torch.float32)


def _dot_operand(x: torch.Tensor, prec: str) -> torch.Tensor:
    """``x`` as the recurrent dots read it: float32, rounded to bf16 in bf16 mode."""
    return _bf16_round(x) if prec == "bf16" else x.float()


def rec_dot(h: torch.Tensor, wh: torch.Tensor, prec: str) -> torch.Tensor:
    """h @ wh at the recurrent-dot precision: float32, or bf16 operands
    with float32 accumulation (a product of two bf16 values is exact in
    float32, so rounding the operands and multiplying in float32 is the
    bf16×bf16→f32 dot)."""
    if prec == "bf16":
        return torch.matmul(_bf16_round(h), _bf16_round(wh))
    return torch.matmul(h, wh)


def _res_dtype(prec: str) -> torch.dtype:
    """Residual storage: bf16 in bf16 mode (the dot rounds h_prev anyway,
    so only c_prev loses precision), float32 otherwise."""
    return torch.bfloat16 if prec == "bf16" else torch.float32


def _time_order(t: int, reverse: bool):
    return range(t - 1, -1, -1) if reverse else range(t)


def _recurrence_loop(xp_tm, mask_tm, wh, forget_bias, reverse, prec, save_res):
    """The plain step loop → (out, hprev or None, cprev or None, h, c)."""
    _check_prec(prec)
    t, b, four_u = xp_tm.shape
    u = four_u // 4
    dev = xp_tm.device
    h = torch.zeros((b, u), dtype=torch.float32, device=dev)
    c = torch.zeros_like(h)
    out = torch.empty((t, b, u), dtype=torch.float32, device=dev)
    hprev = torch.empty((t, b, u), dtype=_res_dtype(prec), device=dev) if save_res else None
    cprev = torch.empty_like(hprev) if save_res else None
    for tt in _time_order(t, reverse):
        if save_res:
            hprev[tt] = h
            cprev[tt] = c
        gates = xp_tm[tt] + rec_dot(h, wh, prec)
        h_new, c_new = _cell_math(gates, c, forget_bias)
        m = mask_tm[tt][:, None]
        h = m * h_new + (1.0 - m) * h
        c = m * c_new + (1.0 - m) * c
        out[tt] = m * h_new
    return out, hprev, cprev, h, c


def _count(fn, prec: str, plan) -> None:
    """One call of a wrapper's kernel, counted on the wrapper: in all and in
    bf16 mode; through the grid layout (the forward's, the VJP's loop's: a
    launch a pass of rows), in all, in bf16 mode and, of the forward's bf16
    launches, on wgmma (the rest on mma.sync)."""
    fn.launches += 1
    fn.bf16_launches += prec == "bf16"
    grid = getattr(plan, "grid", None)
    if grid is not None:
        fn.grid_launches += grid.passes
        fn.bf16_grid_launches += grid.passes * (prec == "bf16")
        if hasattr(fn, "wgmma_grid_launches"):
            fn.wgmma_grid_launches += grid.passes * (prec == "bf16" and not grid.mma)


def recurrence_plain(
    xp_tm: torch.Tensor,  # [T, B, 4U] time-major projected input (bias included)
    mask_tm: torch.Tensor,  # [T, B] 1.0 for valid steps
    wh: torch.Tensor,
    forget_bias: float,
    reverse: bool,
    prec: str = "highest",
) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """Plain recurrence, the mirror of ``_recurrence_xla``:
    → (out [T, B, U], (h, c) final state)."""
    out, _, _, h, c = _recurrence_loop(xp_tm, mask_tm, wh, forget_bias, reverse, prec, False)
    return out, (h, c)


def bidir_recurrence_plain(xpf_tm, xpb_tm, mask_tm, whf, whb, forget_bias=1.0, prec="highest"):
    """Plain version of the BiLSTM kernel: → (out_f, out_b, (hf, cf), (hb, cb))."""
    out_f, st_f = recurrence_plain(xpf_tm, mask_tm, whf, forget_bias, False, prec)
    out_b, st_b = recurrence_plain(xpb_tm, mask_tm, whb, forget_bias, True, prec)
    return out_f, out_b, st_f, st_b


def _check_recurrence_args(xps, mask_tm, whs, name: str) -> Tuple[int, int, int]:
    """Shapes and types the kernels of this module take → (T, B, U)."""
    if not 1 <= len(xps) <= 2 or len(whs) != len(xps):
        raise ValueError(f"{name}: one or two directions, got {len(xps)} inputs and {len(whs)} weights")
    t, b, four_u = xps[0].shape
    u = four_u // 4
    for xp in xps:
        if xp.shape != (t, b, four_u) or xp.dtype != torch.float32:
            raise ValueError(f"{name}: xp must be [T, B, 4U] float32, got {tuple(xp.shape)} {xp.dtype}")
    for wh in whs:
        if wh.shape != (u, four_u):
            raise ValueError(f"{name}: wh must be [{u}, {four_u}], got {tuple(wh.shape)}")
    if mask_tm.shape != (t, b) or mask_tm.dtype != torch.float32:
        raise ValueError(f"{name}: mask must be [{t}, {b}] float32, got {tuple(mask_tm.shape)} {mask_tm.dtype}")
    if four_u % 4 or not 0 < u <= MAX_UNITS:
        raise ValueError(f"{name}: the kernels take U from 1 to {MAX_UNITS}, got U={four_u / 4:g}")
    return t, b, u


def _ptrs(ts: Sequence[torch.Tensor]) -> List[Optional[int]]:
    """Two pointer slots, the second None (NULL) for one direction."""
    return [t.data_ptr() for t in ts] + [None] * (2 - len(ts))


def _rev_bits(reverse: Sequence[bool]) -> int:
    return sum(1 << d for d, r in enumerate(reverse) if r)


def recurrence(
    xp_tm: torch.Tensor,  # [T, B, 4U] float32
    mask_tm: torch.Tensor,  # [T, B] float32
    wh: torch.Tensor,  # [U, 4U]
    forget_bias: float = 1.0,
    reverse: bool = False,
    prec: str = "highest",
) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """One direction's recurrence → (out [T, B, U], (h, c) final state),
    with ``lax.scan(reverse=reverse)`` semantics.

    Replaces ``phones_las_tpu/ops/lstm.py::_recurrence_pallas`` (the primal
    of ``pallas_recurrence``). A CPU tensor runs ``recurrence_plain``; a
    CUDA tensor launches ``plt_lstm_recurrence`` of ``csrc/lstm.cu`` for
    one direction or raises."""
    _check_prec(prec)
    if not check_kernel_device(xp_tm, mask_tm, wh):
        return recurrence_plain(xp_tm, mask_tm, wh, forget_bias, reverse, prec)
    (out, _, _, h, c), = _launch_forward("plt_lstm_recurrence", [xp_tm], mask_tm, [wh], forget_bias, [reverse], prec)
    _count(recurrence, prec, _launch_forward.last_plan)
    return out, (h, c)


recurrence.launches = 0
recurrence.bf16_launches = 0
recurrence.grid_launches = 0
recurrence.bf16_grid_launches = 0
recurrence.wgmma_grid_launches = 0


def recurrence_residual_plain(xps, mask_tm, whs, forget_bias, reverse, prec="highest"):
    """Plain version of ``recurrence_residual``: per direction (out,
    hprev, cprev, h, c), with hprev[t], cprev[t] the carried state before
    step t in the direction's own order (bf16 in bf16 mode)."""
    return [
        _recurrence_loop(xp, mask_tm, wh, forget_bias, rev, prec, True)
        for xp, wh, rev in zip(xps, whs, reverse)
    ]


def recurrence_residual(
    xps: Sequence[torch.Tensor],  # per direction [T, B, 4U] float32
    mask_tm: torch.Tensor,  # [T, B] float32
    whs: Sequence[torch.Tensor],  # per direction [U, 4U]
    forget_bias: float = 1.0,
    reverse: Sequence[bool] = (False,),
    prec: str = "highest",
) -> List[Tuple[torch.Tensor, ...]]:
    """The training forward of one or two directions → per direction
    (out [T, B, U], hprev [T, B, U], cprev [T, B, U], h [B, U], c [B, U]);
    hprev/cprev are the carried state before each step, bf16 in bf16 mode.

    Replaces ``phones_las_tpu/ops/lstm.py::_recurrence_pallas_residual``
    (the forward rules ``_pallas_rec_fwd`` and ``_bidir_fwd``, which call it
    once per direction; here both directions of a layer are one launch of
    ``plt_lstm_residual``, ``csrc/lstm.cu``). A CPU tensor runs the
    plain version; a CUDA tensor launches the kernel or raises."""
    _check_prec(prec)
    if len(reverse) != len(xps):
        raise ValueError(f"one reverse flag per direction, got {len(reverse)} for {len(xps)}")
    if not check_kernel_device(*xps, mask_tm, *whs):
        return recurrence_residual_plain(xps, mask_tm, whs, forget_bias, reverse, prec)
    res = _launch_forward("plt_lstm_residual", xps, mask_tm, whs, forget_bias, reverse, prec)
    _count(recurrence_residual, prec, _launch_forward.last_plan)
    return res


recurrence_residual.launches = 0
recurrence_residual.bf16_launches = 0
recurrence_residual.grid_launches = 0
recurrence_residual.bf16_grid_launches = 0
recurrence_residual.wgmma_grid_launches = 0


# the forward kernel's constants, as csrc/lstm.cu has them
FWD_THREADS = 256
SMEM_MAX = 232448  # dynamic shared memory a block may use on the H100
CLUSTER_SIZES = (8, 4, 2, 1)  # tried in this order; 8 is the portable maximum
ROW_TILES = (8, 16)
XP_RING = 3  # xp tiles a block keeps in flight
# the widest U the kernels take (csrc/lstm.cu's bad_shape): the widest the
# card holds to the plain versions (chip_smoke.py: phase 13a at U = 2048,
# W2048 served and trained in 13d). The plans in shared memory go further
# (every multiple of 8 to 4·MAX_UNITS has a forward and a VJP grid plan:
# tests/test_torch_wide_kernels.py), so what bounds it is what is checked,
# not what fits
MAX_UNITS = 2048
RESIDENT_UNITS = 256  # the widest float32 U whose slices a cluster holds in shared memory
# the forward past RESIDENT_UNITS (bf16: RING_UNITS_BF16) takes the grid
# layout (grid_plan); the VJP's loop in float32 past GRID_UNITS_BWD and in
# bf16 past RING_UNITS_BF16 its own grid layout (grid_bwd_plan). Up to
# GRID_UNITS_BWD the VJP's template streams its slice by the threads' loads
# (on the H100 it read faster than the grid layout at U = 512: PERF.md)
GRID_UNITS_BWD = 512
# bf16 past this U: the forward's and the VJP's grid layouts; up to it the
# template holds its slice (U <= 384; on the H100 the grid layouts read faster
# than the template's streamed slice at U = 448, 512 and 1024: PERF.md)
RING_UNITS_BF16 = 384
# the step's cost a grid plan is chosen by, in SM cycles (H100 SXM at 1980
# MHz; the two rates as the listener kernels' streamed routes measured them,
# PERF.md)
FMA_PER_CYCLE = 128  # float32 FMA lanes of an SM
MMA_FMA_PER_CYCLE = 1024  # bf16 multiply-adds an SM's tensor cores run a cycle through mma.sync (about half the peak)
L2_BYTES_PER_CYCLE = 2800  # the card's L2 read rate, ≈ 5.5 TB/s
SM_BYTES_PER_CYCLE = 22  # what one SM takes in from L2
SMEM_BYTES_PER_CYCLE = 128  # an SM's shared-memory bandwidth


class ForwardPlan(NamedTuple):
    """How one launch of the forward kernel cuts its work."""

    cluster: int  # C: blocks of a cluster = slices of the units
    bt: int  # batch rows of a cluster's tile
    ksplit: int  # float32: parts the k range is split into among the warps
    resident: bool  # the block's wh slice lies in shared memory (else it streams from L2)
    smem: int  # dynamic shared memory bytes of a block
    units: int  # the U the kernel runs at: the layer's, or wider with zero padding
    grid: Optional["GridPlan"] = None  # the grid layout's cut (then cluster is 1, bt its rows, ksplit its parts)


def kernel_units(u: int, c: int) -> int:
    """The U a cluster of ``c`` blocks runs a layer of ``u`` units at:
    ``u`` rounded up to slices of a multiple of 8 units a block."""
    return round_up(u, 8 * c)


def _plan_candidates(u: int) -> List[Tuple[int, bool, int]]:
    """The (C, resident, kernel U) the template plans try, in order (the
    forward's takes the grid layout at the first that is not resident): the cuts of U
    itself into slices of a multiple of 8 units, first with the block's
    slice of wh resident in shared memory, then streamed from L2; then the
    cuts of a U padded to a multiple of 8·C, resident, then streamed."""
    exact = [c for c in CLUSTER_SIZES if u % (8 * c) == 0]
    padded = [c for c in CLUSTER_SIZES if c not in exact]
    return ([(c, True, u) for c in exact] + [(c, False, u) for c in exact]
            + [(c, res, kernel_units(u, c)) for c in padded for res in (True, False)])


def _check_units(u: int) -> None:
    if u % 8 or not 0 < u <= MAX_UNITS:
        raise ValueError(f"the kernels take U a multiple of 8 from 8 to {MAX_UNITS}, got U={u}")


def regroup_wh(wh: torch.Tensor, c: int) -> torch.Tensor:
    """``wh [U, 4U]`` (gate-major columns i|f|g|o) → ``[C, U, 4·U/C]``:
    slice ``s`` holds, for units ``[s·U/C, (s+1)·U/C)``, their four gate
    columns side by side, so a block's cell update is local."""
    u = wh.shape[0]
    if wh.shape != (u, 4 * u) or u % c:
        raise ValueError(f"regroup_wh: wh must be [U, 4U] with U a multiple of C={c}, got {tuple(wh.shape)}")
    return wh.reshape(u, 4, c, u // c).permute(2, 0, 1, 3).reshape(c, u, 4 * (u // c)).contiguous()


def ungroup_wh(wg: torch.Tensor) -> torch.Tensor:
    """The inverse of ``regroup_wh``: ``[C, U, 4·U/C]`` → ``[U, 4U]``."""
    c, u, nc = wg.shape
    return wg.reshape(c, u, 4, nc // 4).permute(1, 2, 0, 3).reshape(u, 4 * u).contiguous()


def _kernel_wh(wh: torch.Tensor, c: int, prec: str) -> torch.Tensor:
    """``wh`` as the forward template reads it: float32 ``[C, U, 4·U/C]``,
    or for the tensor cores bf16 ``[C, 4·U/C, K]`` with k contiguous and
    zero padded to K = U rounded up to 16."""
    wg = regroup_wh(wh.detach(), c)
    if prec != "bf16":
        return wg.to(torch.float32).contiguous()
    u = wg.shape[1]
    return torch.nn.functional.pad(wg.to(torch.bfloat16).transpose(1, 2), (0, -u % 16)).contiguous()


def ring_fragments(w: torch.Tensor, ksplit: int, kc: int) -> torch.Tensor:
    """A bf16 slice ``w [C, N, K]`` (N a multiple of 8: the product's
    columns; K a multiple of 16: the contraction) in the order the bf16 grid
    kernels read it from their ring of bulk copies: k steps of 16, each the N / 8 column tiles, each the 32
    lanes' B fragments of ``mma.m16n8k16`` (lane 4·g + t holds column g's
    k = 2t, 2t + 1, 2t + 8, 2t + 9), the tiles cut into ``ksplit`` pieces;
    chunks of ``kc`` k steps of one piece, group after group, piece after
    piece → [C, K·N] contiguous."""
    c, n, k = w.shape
    x = w.reshape(c, n // 8, 8, k // 16, 2, 4, 2).permute(0, 3, 1, 2, 5, 4, 6)  # [C, K16, NT, g, t, half, pair]
    x = x.reshape(c, k // 16, ksplit, n // 8 // ksplit, 128)
    groups = [x[:, g0:g0 + kc].transpose(1, 2).reshape(c, -1) for g0 in range(0, k // 16, kc)]
    return torch.cat(groups, 1).contiguous()


def _wh_slice_bytes(u: int, c: int, bf16: bool) -> int:
    """A forward template block's slice of wh in shared memory (bf16 rows
    padded by 16 bytes)."""
    nc, kp = 4 * (u // c), -(-u // 16) * 16
    return nc * (kp + 8) * 2 if bf16 else u * nc * 4


def forward_smem_bytes(u: int, c: int, bt: int, ksplit: int, bf16: bool) -> int:
    """A block's dynamic shared memory in the forward template, as
    ``fwd_layout`` of csrc/lstm.cu lays it out: the wh slice, two h
    buffers, the partial sums, three xp tiles (gates and mask) and the state
    (c, h, out); the grid layout's is ``grid_smem_bytes``'."""
    us = u // c
    nc = 4 * us
    kp = -(-u // 16) * 16
    h = 2 * 16 * (kp + 8) * 2 if bf16 else 2 * bt * u * 4
    return _wh_slice_bytes(u, c, bf16) + h + ksplit * bt * nc * 4 + XP_RING * (bt * nc + bt) * 4 + 3 * bt * us * 4


def _ksplit(u: int, c: int, bt: int, bf16: bool) -> int:
    """float32: as many k parts as give every thread an item of 8 rows × 4
    columns (at most 16, at most one part per 4 k); bf16: the tensor-core
    product is not split."""
    if bf16:
        return 1
    items = (bt // 8) * (u // c)
    return max(1, min(16, FWD_THREADS // items, u // 4))


def _choose_tile(fits, b: int, nd: int, max_active):
    """Of one cluster size's plans, by rising tile: the smallest tile whose
    ``ceil(B/Bt)·nd`` clusters the card runs at once, as ``max_active(plan)``
    says; without that knowledge, or if no tile fits in one wave, the
    largest tile (the smallest if the batch fits in it)."""
    if max_active is not None:
        for plan in fits:
            if -(-b // plan.bt) * nd <= max_active(plan):
                return plan
        return fits[-1]
    return fits[0] if b <= fits[0].bt else fits[-1]


# the grid layouts (csrc/lstm.cu): one cooperative launch of one block an
# SM, each block a run of units with its slice of wh (the VJP: whᵀ) in
# shared memory as far as it fits, the moving operand through global memory
GRID_SMS = 132  # the H100 SXM's SMs: the blocks a launch may have where no card is asked
GRID_SLOTS_MAX = 16
GRID_WS_HEAD = 128  # the VJP's workspace bytes before the dgates buffers: the barrier's counter
GRID_SMEM_MAX = SMEM_MAX - 1024  # a grid kernel's dynamic shared memory: its barriers are static
GRID_KS = (1, 2, 4, 8)  # k parts
GRID_TILES = {False: (4, 8), True: (1, 2, 4)}  # the VJP's: float32 rows a thread; bf16 16-row tiles
GRID_CHUNKS = (16, 32, 64, 128)  # the VJP's k rows of a chunk
GRID_SLOTS_A_PART = (2, 3, 4)  # ring slots a k part
GRID_COPY_CYCLES = 2000  # a bulk copy's latency from L2: the ring's bytes in flight over it bound the intake

# the forward's grid layout (lstm_grid_kernel / lstm_grid_bf16_kernel): no
# grid barrier, a readiness counter a chunk of h; float32 a thread's 8
# columns × 4 or 8 rows, h chunks k-major; bf16 on wgmma, M the block's gate
# columns in tiles of 64 (zero rows past them), N the pass's rows, both
# operands in the canonical 128-byte-swizzled K-major layout
FWD_GRID_TILES_F32 = (4, 8)  # float32: rows a thread
FWD_GRID_KS = {False: GRID_KS, True: (1, 2)}  # k parts (bf16: one, or a warpgroup each)
FWD_GRID_SLOTS_BF16 = (2, 3, 4, 6, 8)  # bf16 on wgmma: ring slots a k part
FWD_GRID_MTW = (1, 2, 4)  # bf16: M tiles a warpgroup
FWD_GRID_CHUNKS = {False: (32, 64, 128), True: (128,)}  # k rows of a chunk (wgmma: two of the swizzle's atoms)
FWD_GRID_ROWS_BF16 = (16, 32, 64, 128)  # the wgmma's N: rows a bf16 launch holds
FWD_GRID_ALIGN_BF16 = 1024  # bytes reserved to align the bf16 kernel's region to the swizzle's atoms
# the step's cost a forward plan is chosen by, in SM cycles (H100 SXM at 1980
# MHz), its constants fitted to the H100's readings of every layout at six
# shapes (chip_smoke.py --sweep-forward, PERF.md)
FWD_F32_FMA_SHARE = {4: 0.57, 8: 0.65}  # the float32 product's share of the FMA rate on its busy threads, by TR
WGMMA_FMA_PER_CYCLE = 1000  # bf16 multiply-adds an SM's tensor cores ran a cycle through wgmma
WGMMA_CHUNK_CYCLES = 1600  # a warpgroup's chunk of 128 k on wgmma: its group issued and waited on
FWD_RING_CHUNK_CYCLES = 600  # each chunk of a step's h through the ring: its copy, waits and release
FWD_FIXED_CYCLES = 3800  # the publication (its release), the stores that follow it, the first chunk's latency
FWD_CELL_CYCLES = {False: 3000, True: 1700}  # the cell update of 4 units of a row a thread (bf16: fast exp)


class GridPlan(NamedTuple):
    """How a grid layout cuts a launch (csrc/lstm.cu's GridCut without the
    pass's rows): the forward's (``grid_plan``) or the VJP's loop's
    (``grid_bwd_plan``)."""

    blocks: int  # blocks of a launch: nd · units / us, at most one an SM
    us: int  # units a block (a multiple of 8; the bf16 forward: of 16)
    rows: int  # batch rows a launch holds (a pass)
    tile: int  # float32: rows a thread; bf16: the forward's M tiles a warpgroup, the VJP's 16-row tiles
    ks: int  # k parts: chunk i belongs to part i mod ks
    kc: int  # k rows of a chunk
    kp: int  # the k range padded to a multiple of kc · ks
    nres: int  # chunks of a block's wh slice held in shared memory (the rest stream each step)
    ns: int  # ring slots
    passes: int  # launches of rows the batch takes
    cl: int = 1  # the VJP's loop: blocks of a cluster, the k pieces of a group's units (the forward: 1)
    mma: bool = False  # the bf16 forward: its product on mma.sync (tile: 16-row tiles), not on wgmma

    @property
    def resident_share(self) -> float:
        """The share of a block's wh slice held in shared memory."""
        return self.nres * self.kc / self.kp


def grid_units(u: int, nd: int, sms: int = GRID_SMS, least: int = 8) -> Tuple[int, int]:
    """The forward's grid cut of ``u`` units a direction over at most
    ``sms`` blocks → (units a block, the kernel U): the fewest units a
    block, a multiple of 8 and at least ``least`` (the bf16 kernel's 16: a
    whole M tile of gate columns), whose ``nd · ceil(u / us)`` blocks the
    card holds; the kernel U is ``u`` rounded up to them (zero padding)."""
    us = least
    while nd * -(-u // us) > sms:
        us += 8
    return us, round_up(u, us)


def grid_bf16_ntw(nt: int, ks: int, mt: int) -> int:
    """The VJP's bf16 grid kernel's bound on a warp's n-tiles (csrc/lstm.cu::
    grid_bf16_ntw): ``nt`` over the 8 / ``ks`` warps of a part, rounded up to
    2, 4 or 8, with ``mt`` · it ≤ 16; 0 where none is built."""
    need = -(-nt // (FWD_THREADS // 32 // ks))
    for ntw in (2, 4, 8):
        if need <= ntw:
            return ntw if mt * ntw <= 16 else 0
    return 0


def grid_chunk_bytes(nc: int, rows: int, kc: int, bf16: bool) -> Tuple[int, int]:
    """Bytes of a chunk of the VJP's moving operand (``rows`` rows of
    dgates) and of a chunk of a block's tile of whᵀ (``nc`` product
    columns), ``kc`` k rows each, as its grid kernels stage them: float32
    operand ``[rows][kc + 4]`` (a row padded by 16 bytes), whᵀ ``[kc][nc]``;
    bf16 both in the tensor cores' fragment order, 512 bytes a 16-row tile
    and k step of the operand, 256 an n-tile and k step of whᵀ."""
    if bf16:
        return kc // 16 * rows // 16 * 512, kc // 16 * nc // 8 * 256
    return rows * (kc + 4) * 4, kc * nc * 4


def fwd_chunk_bytes(nc: int, rows: int, kc: int, bf16: bool, mma: bool = False) -> Tuple[int, int]:
    """Bytes of a chunk of the forward's h (``rows`` rows) and of wh (``nc``
    gate columns), ``kc`` k rows each: float32 [kc][rows] and [kc][nc];
    bf16 on wgmma [rows][kc] and [nc rounded up to 64][kc], K-major, the
    swizzle permuting within rows; bf16 on mma.sync the same bytes in the
    fragments' order, nc unpadded."""
    if bf16:
        return rows * kc * 2, kc * (nc if mma else round_up(nc, 64)) * 2
    return rows * kc * 4, kc * nc * 4


def grid_smem_bytes(us: int, rows: int, kc: int, kp: int, nres: int, ns: int, bf16: bool, mma: bool = False) -> int:
    """A block's dynamic shared memory in the forward's grid layout, as
    ``fwd_grid_layout`` of csrc/lstm.cu lays it out: the resident chunks of
    wh, the ring's slots (a chunk of h, and of wh where some of it streams),
    the product [rows, 4·us + 4], the xp tile and mask, the state (c, h)
    and the step's out, and in bf16 on wgmma the bytes that align the region
    to 1024."""
    nc = 4 * us
    hchunk, wchunk = fwd_chunk_bytes(nc, rows, kc, bf16, mma)
    slot = hchunk + (wchunk if nres < kp // kc else 0)
    return (nres * wchunk + ns * slot + rows * (nc + 4) * 4 + (rows * nc + rows + 3) // 4 * 16
            + 3 * rows * us * 4 + (FWD_GRID_ALIGN_BF16 if bf16 and not mma else 0))


def grid_ws_bytes(plan: "GridPlan", nd: int, bf16: bool) -> int:
    """The forward's grid workspace: a readiness counter a chunk of each
    direction (rounded to 128 bytes), then two h buffers of every chunk of
    each direction."""
    nch = plan.kp // plan.kc
    return (round_up(4 * nd * nch, 128)
            + 2 * nd * nch * fwd_chunk_bytes(4 * plan.us, plan.rows, plan.kc, bf16, plan.mma)[0])


def _grid_product_cycles(p: GridPlan, nc: int, bf16: bool, copy_cycles: int = GRID_COPY_CYCLES) -> Tuple[float, float]:
    """A block's step of the VJP's grid loop, ``nc`` product columns, in SM
    cycles → (the product, the intake): the product's float32 FMAs on the
    busy threads, each k step of 4 also issuing a thread's 4 + TR shared
    loads; or the tensor cores' multiply-adds, or the shared-memory reads of
    their fragments where those take longer (every warp of a part reads all
    of its chunks' operand fragments, and its NTW fragments of whᵀ a k
    step); the bytes a block takes in from L2 (the moving operand and the
    chunks of whᵀ that stream) at one SM's rate, at what the ring keeps in
    flight over a copy's latency, and at the card's rate."""
    nch = p.kp // p.kc
    if bf16:
        k16, wp = p.kp // 16, FWD_THREADS // 32 // p.ks
        frags = wp * p.tile * k16 * 512 + p.ks * wp * grid_bf16_ntw(nc // 8, p.ks, p.tile) * (k16 // p.ks) * 256
        product = max(p.tile * (nc // 8) * k16 * 2048 / MMA_FMA_PER_CYCLE, frags / SMEM_BYTES_PER_CYCLE)
    else:
        ncg = nc // 4
        busy = p.ks * (FWD_THREADS // p.ks // ncg) * ncg / FWD_THREADS
        issue = 16 * p.tile / (17 * p.tile + 4)
        product = p.rows * p.kp * nc / (FMA_PER_CYCLE * busy * issue)
    hchunk, wchunk = grid_chunk_bytes(nc, p.rows, p.kc, bf16)
    return product, _intake_cycles(p, nch * hchunk + (nch - p.nres) * wchunk, hchunk + (
        wchunk if p.nres < nch else 0), copy_cycles)


def _intake_cycles(p: GridPlan, nbytes: int, slot: int, copy_cycles: int) -> float:
    """A block's step of intake from L2: ``nbytes`` at one SM's rate, at what
    the ring's slots keep in flight over a copy's latency, and at its share
    of the card's rate."""
    return nbytes / min(SM_BYTES_PER_CYCLE, p.ns * slot / copy_cycles, L2_BYTES_PER_CYCLE / p.blocks)


def _fwd_product_cycles(p: GridPlan, bf16: bool) -> Tuple[float, float]:
    """A block's step of the forward's grid layout in SM cycles → (the
    product, the intake). float32: the FMAs (rows · kp · 4us) on the busy
    threads at the share of the FMA rate the card gave them, and a part's
    chunks' waits; bf16 on wgmma: the multiply-adds (over whole M tiles) at
    the rate wgmma gave them, or a warpgroup's groups one after another,
    where those take longer; bf16 on mma.sync: as the VJP's loop's
    (``_grid_product_cycles``). The intake: h and the chunks of wh that stream
    (``_intake_cycles``)."""
    nc, nch = 4 * p.us, p.kp // p.kc
    if bf16 and p.mma:
        product = _grid_product_cycles(p, nc, True)[0]  # as the VJP's loop on mma.sync
    elif bf16:
        chain = (nch if p.ks == 1 else nch / 2) * p.tile * WGMMA_CHUNK_CYCLES
        product = max(p.rows * p.kp * round_up(nc, 64) / WGMMA_FMA_PER_CYCLE, chain)
    else:
        ncg = nc // 8
        busy = p.ks * (FWD_THREADS // p.ks // ncg) * ncg / FWD_THREADS
        product = p.rows * p.kp * nc / (FMA_PER_CYCLE * busy * FWD_F32_FMA_SHARE[p.tile])
    hchunk, wchunk = fwd_chunk_bytes(nc, p.rows, p.kc, bf16, p.mma)
    return product, _intake_cycles(p, nch * hchunk + (nch - p.nres) * wchunk, hchunk + (
        wchunk if p.nres < nch else 0), GRID_COPY_CYCLES)


def _grid_step_cycles(p: GridPlan, bf16: bool) -> float:
    """A step of the forward's grid layout in SM cycles, the cost its plan
    is chosen by: the product against the intake (``_fwd_product_cycles``),
    plus the publication with the stores that follow it and the step's
    first chunk (its writers' publication and its copy: no grid barrier),
    each chunk's way through the ring, the parts' sum and the cell
    update."""
    nc = 4 * p.us
    product, intake = _fwd_product_cycles(p, bf16)
    rest = (FWD_FIXED_CYCLES + p.kp // p.kc * FWD_RING_CHUNK_CYCLES + p.ks * (p.rows * nc / FWD_THREADS + 100)
            + -(-p.rows * p.us // (4 * FWD_THREADS)) * FWD_CELL_CYCLES[bf16])
    return max(product, intake) + rest


def _grid_layouts(b: int, nd: int, units: int, us: int, nc: int, k: int, bf16: bool, smem, cl: int = 1):
    """Every layout the VJP's grid kernels take for a cut of ``units`` units
    a direction into blocks of ``us`` (clusters of ``cl``), a block's
    product ``nc`` columns wide over a k range of ``k``: k parts, a thread's
    rows or the row tiles, the chunk's k rows and the ring's slots, each
    holding as many chunks of whᵀ as fit beside the ring (the rest stream
    each step; ``smem(rows, kc, kp, nres, ns)``: a block's bytes) →
    GridPlans."""
    for ks in GRID_KS:
        for tile in GRID_TILES[bf16]:
            if bf16:
                rows = 16 * tile
                if not grid_bf16_ntw(nc // 8, ks, tile):
                    continue
            else:
                nrt = FWD_THREADS // ks // (nc // 4)
                if nrt < 1:
                    continue
                rows = nrt * tile
            yield from _with_chunks(b, nd, units, us, rows, tile, ks, k, GRID_CHUNKS, nc * (2 if bf16 else 4), smem, cl)


def _with_chunks(b, nd, units, us, rows, tile, ks, k, chunks, wrow: int, smem, cl: int = 1, slots=None):
    """A layout's plans at each chunk and ring depth (``slots``: the ring's
    slots to try, by default 2, 3 or 4 a k part), each holding as many
    chunks of wh as fit beside the ring (``wrow``: bytes of a k row of a
    block's wh)."""
    for kc, ns in ((kc, ns) for kc in chunks for ns in (slots or [per * ks for per in GRID_SLOTS_A_PART])):
        kp = round_up(k, kc * ks)
        nch = kp // kc
        if ns > GRID_SLOTS_MAX or nch < ks:
            continue
        nres = nch
        if smem(rows, kc, kp, nres, ns) > GRID_SMEM_MAX:
            nres = (GRID_SMEM_MAX - smem(rows, kc, kp, 0, ns)) // (kc * wrow)
            if nres < 0:
                continue
        yield GridPlan(nd * units // us, us, rows, tile, ks, kc, kp, nres, ns, -(-b // rows), cl)


def _fwd_grid_layouts(b: int, nd: int, units: int, us: int, bf16: bool, smem):
    """Every layout the forward's grid kernels take for a cut of ``units``
    units a direction into blocks of ``us``: float32 k parts and a thread's
    rows (a part's row tiles of 8 columns × 4 or 8 rows a thread), at every
    chunk and ring depth (``_with_chunks``); bf16 one part (an even number
    of M tiles of 64 gate columns, half a warpgroup) or two (a warpgroup a
    part), the rows a launch holds (a built instance), at 2–8 ring slots a
    part → GridPlans."""
    nc = 4 * us
    if bf16:
        mt = -(-us // 16)
        for ks in FWD_GRID_KS[True]:
            mtw = mt // 2 if ks == 1 else mt
            if (ks == 1 and mt % 2) or mtw not in FWD_GRID_MTW:
                continue
            for rows in FWD_GRID_ROWS_BF16:
                if mtw * rows <= 128:
                    yield from _with_chunks(b, nd, units, us, rows, mtw, ks, units, FWD_GRID_CHUNKS[True],
                                            round_up(nc, 64) * 2, smem,
                                            slots=[per * ks for per in FWD_GRID_SLOTS_BF16])
        return
    for ks in FWD_GRID_KS[False]:
        nrt = FWD_THREADS // ks // (nc // 8)
        for tile in FWD_GRID_TILES_F32 if nrt >= 1 else ():
            yield from _with_chunks(b, nd, units, us, nrt * tile, tile, ks, units, FWD_GRID_CHUNKS[False], nc * 4, smem)


def grid_candidates(b: int, u: int, nd: int, prec: str = "highest", sms: int = GRID_SMS) -> List[GridPlan]:
    """Every layout the forward's grid kernels take for a shape: the cut of
    the units (``grid_units``: bf16 on wgmma in runs of 16 units or more,
    half-empty M tiles reading slower on the H100; and wider runs where no
    layout takes that one), then ``_fwd_grid_layouts``; bf16 also every
    layout of its mma.sync route (``_fwd_mma_layouts``)."""
    bf16 = prec == "bf16"
    plans = _fwd_cut_layouts(u, nd, sms, 16 if bf16 else 8,
                             lambda us, units, smem: _fwd_grid_layouts(b, nd, units, us, bf16, smem), bf16, False)
    if bf16:
        plans += _fwd_cut_layouts(u, nd, sms, 8, lambda us, units, smem: _fwd_mma_layouts(b, nd, units, us, smem),
                                  True, True)
    return plans


def _fwd_cut_layouts(u, nd, sms, least, layouts, bf16, mma) -> List[GridPlan]:
    us, units = grid_units(u, nd, sms, least)
    while True:  # wider runs where no layout takes this one (wgmma: an odd number of M tiles past 2)
        smem = lambda rows, kc, kp, nres, ns: grid_smem_bytes(us, rows, kc, kp, nres, ns, bf16, mma)
        plans = list(layouts(us, units, smem))
        if plans or us >= units:
            return plans
        us += 8
        units = round_up(u, us)


def _fwd_mma_layouts(b: int, nd: int, units: int, us: int, smem):
    """Every layout of the bf16 forward's mma.sync route for a cut into
    blocks of ``us`` units: the VJP's loop's layouts (``_grid_layouts``: k
    parts, 16-row tiles, chunks of a multiple of 16 k rows, 2–4 ring slots a
    part) over the block's 4·us gate columns → GridPlans (``mma``)."""
    return (p._replace(mma=True) for p in _grid_layouts(b, nd, units, us, 4 * us, units, True, smem))


def grid_plan(b: int, u: int, nd: int, prec: str = "highest", sms: int = GRID_SMS) -> GridPlan:
    """The forward's grid layout plan for a shape — a pure function: of
    every layout its kernels take (``grid_candidates``) the one whose passes
    of rows cost the fewest cycles (``_grid_step_cycles``). Raises
    ``ValueError`` where no layout fits."""
    _check_prec(prec)
    bf16 = prec == "bf16"
    plans = grid_candidates(b, u, nd, prec, sms)
    if not plans:
        raise ValueError(f"no layout of the grid kernels fits U={u}")
    return min(plans, key=lambda p: p.passes * _grid_step_cycles(p, bf16))


def _grid_forward_plan(b: int, u: int, nd: int, prec: str, sms: int) -> ForwardPlan:
    g = grid_plan(b, u, nd, prec, sms)
    units = g.us * g.blocks // nd
    smem = grid_smem_bytes(g.us, g.rows, g.kc, g.kp, g.nres, g.ns, prec == "bf16", g.mma)
    return ForwardPlan(1, g.rows, g.ks, g.nres == g.kp // g.kc, smem, units, g)


def sw128_swizzle(n: int) -> torch.Tensor:
    """The 128-byte swizzle of wgmma's canonical K-major layout on a chunk
    of ``n`` rows of 64 bf16: for each stored element, the logical one (row,
    k) it holds → a flat index of length 64·n. A row's 16-byte group j lies
    at j ^ (row mod 8); an involution."""
    r = torch.arange(n)[:, None, None]
    j = torch.arange(8)[None, :, None]
    e = torch.arange(8)[None, None, :]
    return (r * 64 + ((j ^ (r % 8)) * 8) + e).reshape(-1)


def grid_wh(wh: torch.Tensor, plan: GridPlan, prec: str) -> torch.Tensor:
    """``wh [U, 4U]`` as the forward's grid kernels read it, block after
    block (the runs of ``plan.us`` units), each block's columns its units'
    four gates side by side ([unit][gate]) and its k range zero padded to
    ``plan.kp``: float32 ``[blocks, kp, 4·us]``; bf16 the K-major operand A
    of wgmma, chunk after chunk of 64 k, each ``[4·us][64]`` (zero rows up
    to a multiple of 64) with the 128-byte swizzle (``sw128_swizzle``) →
    ``[blocks, kp·ncp]``; bf16 on mma.sync (``plan.mma``) in the tensor
    cores' B fragment order (``ring_fragments``, one piece) → ``[blocks,
    kp·4·us]``."""
    u = wh.shape[0]
    us = plan.us
    if wh.shape != (u, 4 * u) or u % us:
        raise ValueError(f"grid_wh: wh must be [U, 4U] with U a multiple of {us}, got {tuple(wh.shape)}")
    w = wh.detach().reshape(u, 4, u // us, us).permute(2, 0, 3, 1).reshape(u // us, u, 4 * us)
    w = torch.nn.functional.pad(w, (0, 0, 0, plan.kp - u))
    if prec != "bf16":
        return w.to(torch.float32).contiguous()
    if plan.mma:  # the B fragments of mma.m16n8k16, one piece
        return ring_fragments(w.to(torch.bfloat16).transpose(1, 2), 1, plan.kp // 16)
    n, ncp = u // us, round_up(4 * us, 64)
    x = torch.nn.functional.pad(w.to(torch.bfloat16), (0, ncp - 4 * us))  # zero rows of A up to whole M tiles
    x = x.reshape(n, plan.kp // 64, 64, ncp).transpose(2, 3).reshape(n, plan.kp // 64, ncp * 64)
    return x[:, :, sw128_swizzle(ncp)].reshape(n, plan.kp * ncp).contiguous()


def ungrid_wh(wg: torch.Tensor, u: int, plan: GridPlan) -> torch.Tensor:
    """The inverse of ``grid_wh`` (float32 or bf16) → ``wh [u, 4u]``."""
    us, kp = plan.us, plan.kp
    n, nc = u // us, 4 * us
    if wg.dtype == torch.bfloat16 and plan.mma:  # undo ring_fragments: [n, K16, NT, g, t, half, pair] → [n, nc, kp]
        x = wg.reshape(n, kp // 16, nc // 8, 8, 4, 2, 2).permute(0, 2, 3, 1, 5, 4, 6)
        wg = x.reshape(n, nc, kp).transpose(1, 2)
    elif wg.dtype == torch.bfloat16:  # undo the swizzle (an involution), the K-major order and the zero rows
        ncp = round_up(nc, 64)
        x = wg.reshape(n, kp // 64, ncp * 64)[:, :, sw128_swizzle(ncp)]
        wg = x.reshape(n, kp // 64, ncp, 64).transpose(2, 3).reshape(n, kp, ncp)[..., :nc]
    w = wg.reshape(n, kp, nc)[:, :u]
    return w.reshape(n, u, us, 4).permute(1, 3, 0, 2).reshape(u, 4 * u).contiguous()


def grid_h(h: torch.Tensor, plan: GridPlan, prec: str) -> torch.Tensor:
    """A pass's h ``[rows, kernel U]`` as the forward's grid kernels store it
    in an h buffer (their ``put_h``), chunk after chunk of ``plan.kc`` k,
    k padded with zeros to ``plan.kp``: float32 k-major ``[kc][rows]``;
    bf16 (rounded) the K-major operand B of wgmma, ``[rows][64]`` with the
    128-byte swizzle; bf16 on mma.sync the A fragments of m16n8k16
    (``_a_frag_index``) → flat."""
    rows = plan.rows
    if prec == "bf16" and plan.mma:
        x = torch.nn.functional.pad(h, (0, plan.kp - h.shape[1])).to(torch.bfloat16)
        out = torch.empty(rows * plan.kp, dtype=torch.bfloat16)
        out[_a_frag_index(rows, plan.kp)] = x.reshape(-1)
        return out
    if prec == "bf16":  # atom columns of 64 k, each [rows][64] swizzled (a chunk: kc / 64 of them)
        x = torch.nn.functional.pad(h, (0, plan.kp - h.shape[1])).reshape(rows, plan.kp // 64, 64)
        x = x.transpose(0, 1).to(torch.bfloat16).reshape(-1, rows * 64)
        return x[:, sw128_swizzle(rows)].reshape(-1).contiguous()
    x = torch.nn.functional.pad(h, (0, plan.kp - h.shape[1])).reshape(rows, plan.kp // plan.kc, plan.kc)
    return x.permute(1, 2, 0).reshape(-1).contiguous()


def _a_frag_index(rows: int, kp: int) -> torch.Tensor:
    """Where csrc/lstm.cu's ``a_frag_word`` puts h[row, k] (bf16) in an h
    buffer of the mma.sync route: k steps of 16, each the rows' 16-row tiles,
    each the 32 lanes' A fragments of m16n8k16 (lane 4·(r mod 8) + (k mod 8)
    / 2 holds rows r and r + 8 at k mod 16 and k mod 16 + 8) → for each (row,
    k) in row-major order its element's index."""
    row = torch.arange(rows)[:, None]
    k = torch.arange(kp)[None, :]
    r, kk = row % 16, k % 16
    word = (((k // 16) * (rows // 16) + row // 16) * 32 + (r % 8) * 4 + (kk % 8) // 2) * 4 + r // 8 + 2 * (kk // 8)
    return (word * 2 + k % 2).reshape(-1)


def ungrid_h(hg: torch.Tensor, u: int, plan: GridPlan) -> torch.Tensor:
    """The inverse of ``grid_h`` → ``h [rows, u]``."""
    rows, kc = plan.rows, plan.kc
    if hg.dtype == torch.bfloat16 and plan.mma:
        return hg[_a_frag_index(rows, plan.kp)].reshape(rows, plan.kp)[:, :u].contiguous()
    if hg.dtype == torch.bfloat16:
        x = hg.reshape(-1, rows * 64)[:, sw128_swizzle(rows)].reshape(-1, rows, 64).transpose(0, 1)
    else:
        x = hg.reshape(-1, kc, rows).permute(2, 0, 1)
    return x.reshape(rows, -1)[:, :u].contiguous()


# the VJP's loop in the grid layout (csrc/lstm.cu's lstm_bwd_grid_kernel /
# lstm_bwd_grid_bf16_kernel): the output units of a direction in groups of
# cl·us, a cluster of cl blocks each; inside a cluster the k range (the 4U
# gate columns) in cl pieces, a block's tile of whᵀ held as far as it fits
GRID_CLUSTERS = (1, 2, 4, 8)  # blocks of a cluster (1: no exchange, every block takes in all 4U)
GRID_BWD_CLOCKS = 7  # the loop's cycle counters (csrc/lstm.cu's GRID_BWD_CLOCKS)
# the loop's step model, in SM cycles, its constants fitted to the H100's
# readings of every layout at five shapes (chip_smoke.py --sweep-vjp, PERF.md)
GRID_BWD_PRODUCT_FACTOR = {False: 1.8, True: 2.0}  # the product's cycles over _grid_product_cycles' count
GRID_BWD_COPY_CYCLES = 4000  # a bulk copy's latency, over which the ring's bytes in flight bound the intake
GRID_COPY_ISSUE_CYCLES = 100  # a bulk copy a step: the producer's issue and the consumers' wait for it
GRID_BWD_FIXED_CYCLES = 5000  # the grid barrier, the arrival and the step's first chunk
GRID_DGATES_CYCLES = 1000  # the cell gradients of a (row, unit) a thread: loads, four dgates, their stores
GRID_EXCHANGE_CYCLES = 300  # the cluster's exchange of the partial dh: its latency, and the partials' wait ...
GRID_EXCHANGE_BLOCK_CYCLES = 100  # ... and this more for each block of the cluster ...
DSMEM_BYTES_PER_CYCLE = 8  # ... and its bytes at this rate


def grid_bwd_units(u: int, nd: int, cl: int, sms: int = GRID_SMS) -> Tuple[int, int]:
    """The VJP's grid cut of ``u`` units a direction into clusters of ``cl``
    blocks over at most ``sms`` blocks → (units a block, the kernel U): the
    fewest units a block, a multiple of 8, whose ``nd · cl · ceil(u / (cl ·
    us))`` blocks the card holds; the kernel U is ``u`` rounded up to groups
    of ``cl · us`` (zero padding)."""
    us = 8
    while nd * cl * -(-u // (cl * us)) > sms:
        us += 8
    return us, round_up(u, cl * us)


def grid_bwd_smem_bytes(us: int, cl: int, rows: int, kc: int, kp: int, nres: int, ns: int, bf16: bool) -> int:
    """A block's dynamic shared memory in the VJP's grid loop, as
    ``grid_layout(..., bwd)`` of csrc/lstm.cu lays it out: the resident
    chunks of its tile of whᵀ, the ring's slots (a chunk of dgates, and of
    whᵀ where some of it streams), the product [rows, cl·us], the cluster's
    partials [2, cl, rows, us] (cl > 1), two tiles of a step's factors
    ([rows, 7·us] and the mask) and the kept dh and dc."""
    nc = cl * us
    hchunk, wchunk = grid_chunk_bytes(nc, rows, kc, bf16)
    slot = hchunk + (wchunk if nres < kp // kc else 0)
    recv = 2 * cl * rows * us * 4 if cl > 1 else 0
    tile = (rows * 7 * us + rows + 3) // 4 * 16
    return nres * wchunk + ns * slot + rows * nc * 4 + recv + 2 * tile + 2 * rows * us * 4


def grid_bwd_ws_bytes(plan: GridPlan, nd: int, bf16: bool) -> int:
    """A pass's workspace of the VJP's grid loop: the barrier's counter, then
    two dgates buffers of every chunk of each piece of each direction."""
    return GRID_WS_HEAD + 2 * nd * plan.cl * (plan.kp // plan.kc) * grid_chunk_bytes(
        plan.cl * plan.us, plan.rows, plan.kc, bf16)[0]


def _grid_bwd_step_cycles(p: GridPlan, bf16: bool) -> float:
    """A step of the VJP's grid loop in SM cycles, the cost its plan is
    chosen by: the product of the cluster's cl·us units over the block's k
    piece (``_grid_product_cycles`` times ``GRID_BWD_PRODUCT_FACTOR``)
    against the intake of that piece's dgates and the streamed whᵀ, plus a
    cost a bulk copy, the barrier and the arrival, the parts' sum, the cell
    gradients of the block's units and, with cl > 1, the cluster's exchange
    of the partial dh."""
    nc, nch = p.cl * p.us, p.kp // p.kc
    product, intake = _grid_product_cycles(p, nc, bf16, GRID_BWD_COPY_CYCLES)
    rest = (GRID_BWD_FIXED_CYCLES + (2 * nch - p.nres) * GRID_COPY_ISSUE_CYCLES
            + p.ks * (p.rows * nc / FWD_THREADS + 100) + p.rows * p.us / FWD_THREADS * GRID_DGATES_CYCLES)
    if p.cl > 1:
        rest += GRID_EXCHANGE_CYCLES + GRID_EXCHANGE_BLOCK_CYCLES * p.cl + p.rows * nc * 4 / DSMEM_BYTES_PER_CYCLE
    return max(product * GRID_BWD_PRODUCT_FACTOR[bf16], intake) + rest


def grid_bwd_candidates(b: int, u: int, nd: int, bf16: bool, cl: int, sms: int = GRID_SMS):
    """Every layout of the VJP's grid loop its kernels take at a cluster size
    (``_grid_layouts`` of a cut by ``grid_bwd_units`` over ``sms`` blocks, a
    block's product the cluster's cl·us units over its piece of 4U/cl gate
    columns) → [GridPlan]."""
    us, units = grid_bwd_units(u, nd, cl, sms)
    smem = lambda rows, kc, kp, nres, ns: grid_bwd_smem_bytes(us, cl, rows, kc, kp, nres, ns, bf16)
    return list(_grid_layouts(b, nd, units, us, cl * us, 4 * units // cl, bf16, smem, cl))


def _grid_bwd_cheapest(b: int, u: int, nd: int, bf16: bool, cl: int, sms: int) -> Optional[GridPlan]:
    plans = grid_bwd_candidates(b, u, nd, bf16, cl, sms)
    return min(plans, key=lambda p: p.passes * _grid_bwd_step_cycles(p, bf16)) if plans else None


def grid_bwd_plan(b: int, u: int, nd: int, prec: str = "highest", sms: int = GRID_SMS,
                  held: Optional[Callable[[GridPlan], int]] = None, clusters: Sequence[int] = GRID_CLUSTERS) -> GridPlan:
    """The VJP's grid loop's plan for a shape — a pure function: of the
    cheapest layout of each cluster size in ``clusters``
    (``grid_bwd_candidates`` by passes × ``_grid_bwd_step_cycles``), the one
    that costs the fewest cycles among those the card takes. A cut in
    clusters (cl > 1) is taken only where ``held(plan)``, the blocks the
    card holds at once of that launch made cooperative in clusters (0 where
    it refuses such a launch), covers the plan's blocks; where it holds
    fewer, the cut is made again over that many blocks. Without ``held``
    every cut is taken (the planner's tests; on the card the wrapper asks
    it). Raises ``ValueError`` where no layout fits."""
    _check_prec(prec)
    bf16 = prec == "bf16"
    best, best_cost = None, None
    for cl in clusters:
        plan = _grid_bwd_cheapest(b, u, nd, bf16, cl, sms)
        if plan is not None and cl > 1 and held is not None:
            n = held(plan)
            if n < plan.blocks:
                plan = _grid_bwd_cheapest(b, u, nd, bf16, cl, n) if n >= nd * cl else None
                if plan is not None and held(plan) < plan.blocks:
                    plan = None
        if plan is None:
            continue
        cost = plan.passes * _grid_bwd_step_cycles(plan, bf16)
        if best is None or cost < best_cost:
            best, best_cost = plan, cost
    if best is None:
        raise ValueError(f"no layout of the VJP's grid kernels fits U={u}")
    return best


def grid_wht(wh: torch.Tensor, plan: GridPlan, prec: str) -> torch.Tensor:
    """``wh [U, 4U]`` as the VJP's grid loop reads it: the tile of block g·cl
    + r (group g, cluster rank r) is ``whᵀ`` restricted to the gate columns of
    the unit run ``[r·U/cl, (r+1)·U/cl)`` (its k, ``4·j + gate`` for the run's
    unit j, zero padded to ``plan.kp``) and the output units ``[g·cl·us,
    (g+1)·cl·us)``: float32 ``[blocks, kp, cl·us]``; bf16 in the tensor
    cores' B fragment order (``ring_fragments``, one piece) → ``[blocks,
    kp·cl·us]``."""
    u = wh.shape[0]
    ug = plan.cl * plan.us
    if wh.shape != (u, 4 * u) or u % ug:
        raise ValueError(f"grid_wht: wh must be [U, 4U] with U a multiple of {ug}, got {tuple(wh.shape)}")
    w = wh.detach().reshape(u // ug, ug, 4, plan.cl, u // plan.cl).permute(0, 3, 4, 2, 1)
    w = torch.nn.functional.pad(w.reshape(u // plan.us, 4 * u // plan.cl, ug), (0, 0, 0, plan.kp - 4 * u // plan.cl))
    if prec != "bf16":
        return w.to(torch.float32).contiguous()
    return ring_fragments(w.to(torch.bfloat16).transpose(1, 2), 1, plan.kp // 16)


def ungrid_wht(wg: torch.Tensor, u: int, plan: GridPlan) -> torch.Tensor:
    """The inverse of ``grid_wht`` (float32 or bf16) → ``wh [u, 4u]``."""
    cl, kp, ug = plan.cl, plan.kp, plan.cl * plan.us
    n = u // plan.us
    if wg.dtype == torch.bfloat16:  # undo ring_fragments: [n, K16, NT, g, t, half, pair] → [n, ug, kp]
        x = wg.reshape(n, kp // 16, ug // 8, 8, 4, 2, 2).permute(0, 2, 3, 1, 5, 4, 6)
        wg = x.reshape(n, ug, kp).transpose(1, 2)
    w = wg.reshape(n, kp, ug)[:, :4 * u // cl]
    return w.reshape(u // ug, cl, u // cl, 4, ug).permute(0, 4, 3, 1, 2).reshape(u, 4 * u).contiguous()


def forward_plan(
    b: int, u: int, nd: int, prec: str = "highest",
    max_active: Optional[Callable[..., int]] = None, layout: Optional[str] = None, sms: int = GRID_SMS,
) -> ForwardPlan:
    """The forward kernel's plan for a shape — a pure function. Takes every
    U that is a multiple of 8 from 8 to ``MAX_UNITS`` (the wrappers pad any
    other U to the next multiple of 8).

    Up to the resident widths (float32 ``RESIDENT_UNITS``, bf16
    ``RING_UNITS_BF16``) the cluster template: C is the largest of
    ``CLUSTER_SIZES`` that divides U into slices of a multiple of 8 units
    whose wh slice fits in shared memory beside the rest; where none does
    and no cut of U fits a block even without its slice, the largest C whose
    slices of U zero padded to a multiple of 8·C fit (``_plan_candidates``,
    ``ForwardPlan.units``: bf16 U = 360, 376). Bt is the
    smallest tile (the shortest step) whose ``ceil(B/Bt)·nd`` clusters the
    card runs at once, as ``max_active(C, Bt, ksplit)`` says (on the card:
    ``cudaOccupancyMaxActiveClusters``); without that knowledge, or if no
    tile fits in one wave, the largest tile that fits in shared memory.
    Past the resident widths, and below them where a cut of U fits a block
    only without its slice of wh (float32 U = 104–248 but 112, 128, 160,
    192; bf16 136–368 in the cuts' gaps: on the H100 the grid layout read
    2–3× faster there than the template's former streamed slice, each
    step's slice from L2, PERF.md), the grid layout
    (``grid_plan`` over ``sms`` SMs, ``ForwardPlan.grid``). ``layout="grid"``
    forces the grid layout at any U, for comparisons. Raises ``ValueError``
    for a U outside that range."""
    _check_prec(prec)
    _check_units(u)
    if layout not in (None, "grid"):
        raise ValueError(f"layout must be None or 'grid', got {layout!r}")
    bf16 = prec == "bf16"
    if layout is None and u <= (RING_UNITS_BF16 if bf16 else RESIDENT_UNITS):
        for c, resident, units in _plan_candidates(u):
            fits = []
            for bt in ROW_TILES:
                ks = _ksplit(units, c, bt, bf16)
                smem = forward_smem_bytes(units, c, bt, ks, bf16)
                if smem - (0 if resident else _wh_slice_bytes(units, c, bf16)) <= SMEM_MAX:
                    fits.append(ForwardPlan(c, bt, ks, True, smem, units))
            if fits and not resident:
                break  # it fits only without its slice: the grid layout
            if fits:
                return _choose_tile(fits, b, nd, None if max_active is None else (
                    lambda p: max_active(p.cluster, p.bt, p.ksplit)))
    return _grid_forward_plan(b, u, nd, prec, sms)


def _route(plan) -> int:
    """The kernels' route argument: 0 streamed by the threads' loads (the
    VJP's template), 1 resident, 3 the grid layout (bf16 on wgmma), 4 the
    grid layout with bf16 on mma.sync."""
    g = getattr(plan, "grid", None)
    return (4 if g.mma else 3) if g is not None else int(plan.resident)


@functools.lru_cache(maxsize=None)
def forward_kernel_info(u: int, bf16: bool, save_res: bool, c: int, bt: int, ksplit: int) -> dict:
    """What the card gives one plan of the forward template (built at first
    use): the clusters it runs at once, its dynamic and static shared
    memory bytes and its registers a thread (the grid layout's:
    ``grid_kernel_info``)."""
    from phones_las_torch.csrc import _build

    info = (ctypes.c_int * 4)()
    err = _build.library().plt_lstm_fwd_info(u, int(bf16), int(save_res), c, bt, ksplit, 1, info)
    _build.check(err, "plt_lstm_fwd_info")
    return {"max_active_clusters": info[0], "smem_bytes": info[1], "registers": info[2], "static_smem_bytes": info[3]}


def _grid_cut_fields(g: GridPlan, row0: int, nrows: int) -> Tuple[int, ...]:
    """csrc/lstm.cu's GridCut of a pass: its 12 fields in order."""
    return g.blocks, g.us, g.rows, row0, nrows, g.tile, g.ks, g.kc, g.kp, g.nres, g.ns, g.cl


def _grid_cut(g: GridPlan, row0: int, nrows: int):
    """csrc/lstm.cu's GridCut of a pass, as the C array its entries read."""
    return (ctypes.c_int * 12)(*_grid_cut_fields(g, row0, nrows))


@functools.lru_cache(maxsize=None)
def grid_kernel_info(u: int, nd: int, bf16: bool, g: GridPlan) -> dict:
    """What the card gives a plan of the grid layout at kernel U ``u``
    (built at first use): the blocks it holds at once (the launch has
    ``g.blocks``), the dynamic and static shared memory bytes and the
    registers a thread; and the plan's resident share of wh and its passes."""
    from phones_las_torch.csrc import _build

    info = (ctypes.c_int * 4)()
    err = _build.library().plt_lstm_grid_info(u, nd, int(bf16) + int(g.mma), _grid_cut(g, 0, g.rows), info)
    _build.check(err, "plt_lstm_grid_info")
    return {"max_active_blocks": info[0], "smem_bytes": info[1], "registers": info[2], "static_smem_bytes": info[3],
            "blocks": g.blocks, "resident_share": g.resident_share, "passes": g.passes}


def _launch_forward(entry, xps, mask_tm, whs, forget_bias, reverse, prec, plan: Optional[ForwardPlan] = None,
                    clocks: Optional[torch.Tensor] = None):
    """One launch of the forward kernel (the grid layout: one a pass of
    rows). ``plan`` overrides ``forward_plan`` (measurements only);
    ``clocks``, an int64 CUDA tensor of 5, receives the SM cycles one block
    spent in the parts of a step (``chip_smoke.py``'s ``FWD_CLOCKS``). Where
    the plan's kernel U is wider than the layer's, xp and wh are zero padded
    to it and the results sliced back (``ops/padding.py``)."""
    t, b, u = _check_recurrence_args(xps, mask_tm, whs, entry)
    from phones_las_torch.csrc import _build

    lib = _build.library()
    bf16 = prec == "bf16"
    save = entry == "plt_lstm_residual"
    nd = len(xps)
    dev = xps[0].device
    if plan is None:
        plan = _card_forward_plan(b, round_up(u, 8), nd, prec, save,
                                  dev.index if dev.index is not None else torch.cuda.current_device())
    up, grid = plan.units, plan.grid
    wdt = torch.bfloat16 if bf16 else torch.float32
    xps = [pad_gates(x, u, up).contiguous() for x in xps]
    if grid is None:
        whs = [_kernel_wh(pad_lstm_wh(w.detach(), up), plan.cluster, prec) for w in whs]
    else:
        whs = [grid_wh(pad_lstm_wh(w.detach(), up), grid, prec) for w in whs]
    mask = mask_tm.contiguous()
    outs = [torch.empty((t, b, up), dtype=torch.float32, device=dev) for _ in range(nd)]
    hprevs = [torch.empty((t, b, up), dtype=wdt, device=dev) for _ in range(nd)] if save else []
    cprevs = [torch.empty((t, b, up), dtype=wdt, device=dev) for _ in range(nd)] if save else []
    hs = [torch.empty((b, up), dtype=torch.float32, device=dev) for _ in range(nd)]
    cs = [torch.empty((b, up), dtype=torch.float32, device=dev) for _ in range(nd)]
    stream = torch.cuda.current_stream(dev).cuda_stream
    passes = [(None, None)] if grid is None else [
        (_grid_cut(grid, r0, min(grid.rows, b - r0)),
         torch.zeros(grid_ws_bytes(grid, nd, bf16), dtype=torch.uint8, device=dev))
        for r0 in range(0, b, grid.rows)]
    for cut, ws in passes:
        err = getattr(lib, entry)(
            *_ptrs(xps), mask.data_ptr(), *_ptrs(whs), nd, _rev_bits(reverse),
            int(bf16), *_ptrs(outs), *_ptrs(hprevs), *_ptrs(cprevs),
            *_ptrs(hs), *_ptrs(cs), t, b, up, float(forget_bias),
            plan.cluster, plan.bt, plan.ksplit, _route(plan), cut, None if ws is None else ws.data_ptr(),
            None if clocks is None else clocks.data_ptr(), stream,
        )
        _build.check(err, entry)
    _launch_forward.last_plan = plan
    if up != u:
        cut = lambda ts: [x[..., :u].contiguous() for x in ts]
        outs, hprevs, cprevs, hs, cs = cut(outs), cut(hprevs), cut(cprevs), cut(hs), cut(cs)
    none = [None] * nd
    return list(zip(outs, hprevs or none, cprevs or none, hs, cs))


_launch_forward.last_plan = None  # the plan of the last launch, for reports


@functools.lru_cache(maxsize=None)
def _card_forward_plan(b: int, u: int, nd: int, prec: str, save: bool, device_index: int) -> ForwardPlan:
    """``forward_plan`` with the card's answers, once a shape and card: the
    grid layout's plan walks every layout of its kernels (a millisecond or
    two of host time, which a call would otherwise add before its first
    launch)."""
    bf16 = prec == "bf16"
    return forward_plan(b, u, nd, prec, lambda c, bt, ks: forward_kernel_info(
        kernel_units(u, c), bf16, save, c, bt, ks)["max_active_clusters"],
        sms=torch.cuda.get_device_properties(device_index).multi_processor_count)


class BackwardPlan(NamedTuple):
    """How one launch of the VJP's loop kernel cuts its work."""

    cluster: int  # C: blocks of a cluster = slices of the units
    bt: int  # batch rows of a cluster's tile
    ksplit: int  # float32: parts the k range (a block's 4·U/C gate columns) is split into
    resident: bool  # the block's slice of whᵀ lies in shared memory (else it streams from L2)
    smem: int  # dynamic shared memory bytes of a block
    units: int  # the U the kernels run at: the layer's, or wider with zero padding
    grid: Optional[GridPlan] = None  # the grid layout's cut (then cluster is its cl, bt its rows, ksplit its parts)


BWD_RING = 2  # tiles of factors, dout and mask a block keeps: one in use, one in flight


def _kernel_wht(wh: torch.Tensor, c: int, prec: str) -> torch.Tensor:
    """The slices of ``whᵀ`` as the VJP's template loop kernel reads them.
    Block s multiplies the gate gradients of its units (its 4·U/C columns,
    in ``regroup_wh``'s order) by the matching rows of ``whᵀ``: float32
    ``[C, 4·U/C, U]`` (U contiguous), or for the tensor cores bf16
    ``[C, Up, 4·U/C]`` with the contracted gate columns contiguous and the
    units zero padded to Up = U rounded up to 16 (the grid layout's:
    ``grid_wht``)."""
    wg = regroup_wh(wh.detach(), c)  # [C, U, 4·Us]
    if prec != "bf16":
        return wg.to(torch.float32).transpose(1, 2).contiguous()
    u = wg.shape[1]
    return torch.nn.functional.pad(wg.to(torch.bfloat16), (0, 0, 0, -u % 16)).contiguous()


def backward_smem_bytes(u: int, c: int, bt: int, ksplit: int, resident: bool, bf16: bool) -> int:
    """A block's dynamic shared memory in the VJP's loop kernel, as
    ``bwd_layout`` of csrc/lstm.cu lays it out: the slice of whᵀ, two
    buffers of received partial dh, this step's dgates, the k parts of the
    product, ``BWD_RING`` tiles (a step's four factors a gate column, then
    dout and two more factors a unit, then the mask) and the kept dh and
    dc; the grid layout's is ``grid_bwd_smem_bytes``'."""
    us = u // c
    nc = 4 * us
    up = -(-u // 16) * 16
    if bf16:
        w = up * (nc + 8) * 2
        dg = 16 * (nc + 8) * 2
        part = ksplit * bt * up * 4
    else:
        w = nc * u * 4
        dg = bt * nc * 4
        part = ksplit * bt * u * 4
    tile = (bt * (nc + 3 * us) + bt) * 4
    return (w if resident else 0) + 2 * bt * u * 4 + dg + part + BWD_RING * tile + 2 * bt * us * 4


def _bwd_ksplit(u: int, c: int, bt: int, bf16: bool) -> int:
    """float32: as many k parts as give every thread an item of 8 rows × 4
    of the U output columns (at most 16, at most one part per 4 k); bf16:
    the tensor-core product is not split."""
    if bf16:
        return 1
    items = (bt // 8) * (u // 4)
    return max(1, min(16, FWD_THREADS // items, u // c))


def _grid_backward_plan(b: int, u: int, nd: int, prec: str, max_active, sms: int) -> BackwardPlan:
    g = grid_bwd_plan(b, u, nd, prec, sms, None if max_active is None else (
        lambda gp: max_active(_as_backward_plan(gp, nd, prec))))
    return _as_backward_plan(g, nd, prec)


def _as_backward_plan(g: GridPlan, nd: int, prec: str) -> BackwardPlan:
    smem = grid_bwd_smem_bytes(g.us, g.cl, g.rows, g.kc, g.kp, g.nres, g.ns, prec == "bf16")
    return BackwardPlan(g.cl, g.rows, g.ks, g.nres == g.kp // g.kc, smem, g.us * g.blocks // nd, grid=g)


def backward_plan(
    b: int, u: int, nd: int, prec: str = "highest",
    max_active: Optional[Callable[[BackwardPlan], int]] = None, layout: Optional[str] = None,
    sms: int = GRID_SMS,
) -> BackwardPlan:
    """The plan of the VJP's loop kernel for a shape — a pure function, the
    companion of ``forward_plan``, over the same U (multiples of 8 from 8 to
    ``MAX_UNITS``).

    Up to the resident widths (float32 ``GRID_UNITS_BWD``, bf16
    ``RING_UNITS_BF16``) the cluster template: C is the largest of
    ``CLUSTER_SIZES`` that divides U into slices of a multiple of 8 units
    whose slice of whᵀ fits in shared memory beside the rest; if none does,
    the largest such C whose layout fits with each block streaming its
    slice of whᵀ from L2 at every step; if none does either, U is zero padded
    to a multiple of 8·C for the largest C that fits (``_plan_candidates``).
    For each tile Bt the k split is the largest that fits (halved until it
    does). Bt is then chosen as ``forward_plan`` chooses it: the smallest
    tile whose ``ceil(B/Bt)·nd`` clusters the card runs at once, as
    ``max_active(plan)`` says (on the card: ``cudaOccupancyMaxActiveClusters``);
    without that knowledge, or if no tile fits in one wave, the largest tile
    that fits in shared memory. Past those widths the grid layout
    (``grid_bwd_plan`` over ``sms`` SMs, ``BackwardPlan.grid``), its cuts in
    clusters only where ``max_active(plan)``, the blocks the card holds at
    once of that launch (0 where it refuses a cooperative launch in
    clusters), covers them. ``layout`` forces a route, for comparisons:
    "template" the template at any U it fits, "grid" the grid layout at
    any U. Raises ``ValueError`` for a U outside that range,
    or a layout that does not fit."""
    _check_prec(prec)
    _check_units(u)
    if layout not in (None, "template", "grid"):
        raise ValueError(f"layout must be None, 'template' or 'grid', got {layout!r}")
    bf16 = prec == "bf16"
    if layout == "grid" or (layout is None and u > (RING_UNITS_BF16 if bf16 else GRID_UNITS_BWD)):
        return _grid_backward_plan(b, u, nd, prec, max_active, sms)
    for c, resident, units in _plan_candidates(u):
        fits = []
        for bt in ROW_TILES:
            ks = _bwd_ksplit(units, c, bt, bf16)
            while ks > 1 and backward_smem_bytes(units, c, bt, ks, resident, bf16) > SMEM_MAX:
                ks //= 2
            smem = backward_smem_bytes(units, c, bt, ks, resident, bf16)
            if smem <= SMEM_MAX:
                fits.append(BackwardPlan(c, bt, ks, resident, smem, units))
        if fits:
            return _choose_tile(fits, b, nd, max_active)
    if layout is None:  # past the template's last layout
        return _grid_backward_plan(b, u, nd, prec, max_active, sms)
    raise ValueError(f"no plan of the VJP's loop kernel fits U={u} in shared memory")


@functools.lru_cache(maxsize=None)
def backward_kernel_info(bf16: bool, plan: BackwardPlan) -> dict:
    """What the card gives one plan of the VJP's loop kernel (built at
    first use) at the plan's kernel U, as ``forward_kernel_info``; of the
    grid layout's, ``grid_bwd_kernel_info``'s."""
    if plan.grid is not None:
        g = plan.grid
        return grid_bwd_kernel_info(plan.units, g.blocks * g.us // plan.units, bf16, g)
    from phones_las_torch.csrc import _build

    info = (ctypes.c_int * 4)()
    err = _build.library().plt_lstm_bwd_info(
        plan.units, int(bf16), plan.cluster, plan.bt, plan.ksplit, _route(plan), info
    )
    _build.check(err, "plt_lstm_bwd_info")
    return {"max_active_clusters": info[0], "smem_bytes": info[1], "registers": info[2], "static_smem_bytes": info[3]}


@functools.lru_cache(maxsize=None)
def grid_bwd_kernel_info(u: int, nd: int, bf16: bool, g: GridPlan) -> dict:
    """What the card gives a plan of the VJP's grid loop at kernel U ``u``
    (built at first use): whether it takes a cooperative launch made in
    clusters of ``g.cl``, the blocks it holds at once of that launch (0
    where it refuses it), the dynamic and static shared memory bytes and the
    registers a thread; and the plan's cut, resident share and passes."""
    from phones_las_torch.csrc import _build

    info = (ctypes.c_int * 5)()
    err = _build.library().plt_lstm_bwd_grid_info(u, nd, int(bf16), _grid_cut(g, 0, g.rows), info)
    _build.check(err, "plt_lstm_bwd_grid_info")
    return {"cooperative_clusters": bool(info[4]), "max_active_blocks": info[0] if info[4] else 0,
            "smem_bytes": info[1], "registers": info[2], "static_smem_bytes": info[3], "blocks": g.blocks,
            "cluster": g.cl, "resident_share": g.resident_share, "passes": g.passes}


@functools.lru_cache(maxsize=None)
def _card_backward_plan(b: int, u: int, nd: int, prec: str, device_index: int) -> BackwardPlan:
    """``backward_plan`` with the card's answers, once a shape and card: the
    plan walks every layout of the grid loop (milliseconds of host time,
    which a call would otherwise add before its first launch)."""
    return backward_plan(b, u, nd, prec, functools.partial(backward_held, prec == "bf16"),
                         sms=torch.cuda.get_device_properties(device_index).multi_processor_count)


def backward_held(bf16: bool, plan: BackwardPlan) -> int:
    """What the card runs at once of a plan's loop launch (``backward_plan``'s
    ``max_active``): clusters (the template), or blocks (the grid
    layout; 0 where the card refuses its cooperative launch in clusters)."""
    info = backward_kernel_info(bf16, plan)
    return info["max_active_blocks"] if plan.grid is not None else info["max_active_clusters"]


def recurrence_bwd_plain(xps, mask_tm, whs, hprevs, cprevs, douts, dhfins, dcfins,
                         forget_bias, reverse, prec="highest"):
    """Plain version of ``recurrence_bwd``: per direction (dxp [T, B, 4U],
    dwh [U, 4U]), a step loop that writes out the reference's equations
    (``phones_las_tpu/ops/lstm.py:397-403``), not autograd."""
    _check_prec(prec)
    res = []
    for xp, wh, hprev, cprev, dout, dh, dc, rev in zip(
        xps, whs, hprevs, cprevs, douts, dhfins, dcfins, reverse
    ):
        t = xp.shape[0]
        wh_d = _dot_operand(wh, prec)
        hp = hprev.float()
        gates_all = xp + torch.matmul(_dot_operand(hp, prec), wh_d)
        dh, dc = dh.float(), dc.float()
        dxp = torch.empty_like(xp, dtype=torch.float32)
        for tt in _time_order(t, not rev):  # opposite order to the forward
            m = mask_tm[tt][:, None]
            cp = cprev[tt].float()
            gi, gf, gg, go = torch.chunk(gates_all[tt], 4, dim=-1)
            si, sf = torch.sigmoid(gi), torch.sigmoid(gf + forget_bias)
            sg, so = torch.tanh(gg), torch.sigmoid(go)
            c_new = sf * cp + si * sg
            tch = torch.tanh(c_new)
            dh_tot = m * (dout[tt] + dh)
            dc_new = m * dc + dh_tot * so * (1.0 - tch * tch)
            d_o = dh_tot * tch * so * (1.0 - so)
            d_f = dc_new * cp * sf * (1.0 - sf)
            d_i = dc_new * sg * si * (1.0 - si)
            d_g = dc_new * si * (1.0 - sg * sg)
            dgates = torch.cat([d_i, d_f, d_g, d_o], dim=-1)
            dxp[tt] = dgates
            dh = (1.0 - m) * dh + torch.matmul(_dot_operand(dgates, prec), wh_d.t())
            dc = (1.0 - m) * dc + dc_new * sf
        u4 = xp.shape[-1]
        dwh = torch.matmul(
            _dot_operand(hp, prec).reshape(-1, u4 // 4).t(), _dot_operand(dxp, prec).reshape(-1, u4)
        )
        res.append((dxp, dwh))
    return res


def recurrence_bwd(
    xps: Sequence[torch.Tensor],  # per direction [T, B, 4U] float32
    mask_tm: torch.Tensor,  # [T, B]
    whs: Sequence[torch.Tensor],  # [U, 4U]
    hprevs: Sequence[torch.Tensor],  # [T, B, U] residuals of recurrence_residual
    cprevs: Sequence[torch.Tensor],
    douts: Sequence[torch.Tensor],  # [T, B, U] cotangent of out
    dhfins: Sequence[torch.Tensor],  # [B, U] cotangents of the final (h, c)
    dcfins: Sequence[torch.Tensor],
    forget_bias: float = 1.0,
    reverse: Sequence[bool] = (False,),
    prec: str = "highest",
) -> List[Tuple[torch.Tensor, torch.Tensor]]:
    """The LSTM VJP of one or two directions → per direction (dxp
    [T, B, 4U] float32, dwh [U, 4U] float32).

    Replaces ``phones_las_tpu/ops/lstm.py::_recurrence_pallas_bwd`` (the
    backward rules ``_pallas_rec_bwd`` and ``_bidir_bwd``). A CPU tensor
    runs the plain version; a CUDA tensor launches ``plt_lstm_bwd``
    (``csrc/lstm.cu``) or raises. That is four kernels on one stream: the
    gate-recompute GEMM, whose epilogue turns the gates and cprev into the
    factors of each step that do not depend on dh (the sigmoids and tanhs
    leave the serial chain); the serial reverse loop (``backward_plan``:
    up to the resident widths a cluster of C blocks per direction and tile
    of Bt rows, each block with its slice of whᵀ in shared memory or, past
    U = 256 in float32, streamed from L2; past them the grid layout, one
    cooperative launch a pass of rows with whᵀ held across the card; the
    partial dh exchanged through distributed shared memory and added in
    rank order); the split-K dWh GEMM and its ordered reduction. In
    bf16 mode the loop's product and both GEMMs run on the tensor cores.
    Repeated runs give bitwise equal results."""
    _check_prec(prec)
    nd = len(xps)
    if not (len(reverse) == len(hprevs) == len(cprevs) == len(douts) == len(dhfins) == len(dcfins) == nd):
        raise ValueError("recurrence_bwd: one of each argument per direction")
    args = (xps, mask_tm, whs, hprevs, cprevs, douts, dhfins, dcfins, forget_bias, reverse, prec)
    if not check_kernel_device(*xps, mask_tm, *whs, *hprevs, *cprevs, *douts, *dhfins, *dcfins):
        return recurrence_bwd_plain(*args)
    res = _launch_backward(*args)
    _count(recurrence_bwd, prec, _launch_backward.last_plan)
    return res


recurrence_bwd.launches = 0
recurrence_bwd.bf16_launches = 0
recurrence_bwd.grid_launches = 0
recurrence_bwd.bf16_grid_launches = 0


def _launch_backward(xps, mask_tm, whs, hprevs, cprevs, douts, dhfins, dcfins, forget_bias, reverse, prec,
                     plan: Optional[BackwardPlan] = None, clocks: Optional[torch.Tensor] = None,
                     part_ms: Optional[list] = None):
    """One call of ``plt_lstm_bwd`` (the grid layout's loop: a launch a pass
    of rows). For measurements: ``plan`` overrides ``backward_plan``;
    ``clocks``, an int64 CUDA tensor of 5 (the grid layout's:
    ``GRID_BWD_CLOCKS``), receives the SM cycles one block of the loop spent
    in the parts of a step (``chip_smoke.py``'s ``BWD_CLOCKS`` and
    ``GRID_BWD_CLOCK_NAMES``); ``part_ms``, a list, receives the milliseconds
    of the four kernels (the call then waits for the stream)."""
    t, b, u = _check_recurrence_args(xps, mask_tm, whs, "plt_lstm_bwd")
    nd = len(xps)
    bf16 = prec == "bf16"
    wdt = torch.bfloat16 if bf16 else torch.float32
    for x in (*hprevs, *cprevs):
        if x.shape != (t, b, u) or x.dtype != wdt:
            raise ValueError(f"plt_lstm_bwd: residuals must be [{t}, {b}, {u}] {wdt}, got {tuple(x.shape)} {x.dtype}")

    from phones_las_torch.csrc import _build

    lib = _build.library()
    dev = xps[0].device
    if plan is None:
        plan = _card_backward_plan(b, round_up(u, 8), nd, prec,
                                   dev.index if dev.index is not None else torch.cuda.current_device())
    up, grid = plan.units, plan.grid
    f32 = lambda ts: [pad_units(x.float(), u, up).contiguous() for x in ts]
    xps = [pad_gates(x.float(), u, up).contiguous() for x in xps]
    douts, dhfins, dcfins = f32(douts), f32(dhfins), f32(dcfins)
    whs = [pad_lstm_wh(w.detach(), up) for w in whs]
    whs_d = [w.to(wdt).contiguous() for w in whs]
    whgs = [_kernel_wht(w, plan.cluster, prec) if grid is None else grid_wht(w, grid, prec) for w in whs]
    whts = [w.t().contiguous() for w in whs_d] if bf16 else []  # the tensor-core gates GEMM reads k contiguous
    hprevs = [pad_units(x, u, up).contiguous() for x in hprevs]
    cprevs = [pad_units(x, u, up).contiguous() for x in cprevs]
    mask = mask_tm.contiguous()
    dxps = [torch.empty((t, b, 4 * up), dtype=torch.float32, device=dev) for _ in range(nd)]
    dwhs = [torch.empty((up, 4 * up), dtype=torch.float32, device=dev) for _ in range(nd)]
    facs = [torch.empty((t, b, 2 * up), dtype=torch.float32, device=dev) for _ in range(nd)]
    # split-K of the dWh product over T*B rows: enough blocks to fill the
    # card, the partials at most 2^25 floats (128 MB; U = 1024 both
    # directions: 4 parts)
    dwh_split = max(1, min(16, (t * b) // 1024, (1 << 25) // (nd * up * 4 * up)))
    partials = torch.empty((nd, dwh_split, up, 4 * up), dtype=torch.float32, device=dev)
    ms = (ctypes.c_float * 4)() if part_ms is not None else None
    npass, cuts, ws, ws_pass = 0, None, None, 0
    if grid is not None:  # a pass of rows a launch, each with its own zeroed workspace
        starts = range(0, b, grid.rows)
        npass = len(starts)
        cuts = (ctypes.c_int * (12 * npass))(*[
            v for r0 in starts for v in _grid_cut_fields(grid, r0, min(grid.rows, b - r0))])
        ws_pass = round_up(grid_bwd_ws_bytes(grid, nd, bf16), 256)
        ws = torch.zeros(npass * ws_pass, dtype=torch.uint8, device=dev)
    err = lib.plt_lstm_bwd(
        *_ptrs(xps), mask.data_ptr(), *_ptrs(whs_d), *_ptrs(whgs), *_ptrs(whts), *_ptrs(hprevs),
        *_ptrs(cprevs), *_ptrs(douts), *_ptrs(dhfins), *_ptrs(dcfins), nd,
        _rev_bits(reverse), int(bf16), *_ptrs(dxps), *_ptrs(facs), *_ptrs(dwhs),
        partials.data_ptr(), dwh_split, t, b, up, float(forget_bias),
        plan.cluster, plan.bt, plan.ksplit, _route(plan), npass, cuts, None if ws is None else ws.data_ptr(),
        ws_pass, None if clocks is None else clocks.data_ptr(), ms,
        torch.cuda.current_stream(dev).cuda_stream,
    )
    _build.check(err, "plt_lstm_bwd")
    if part_ms is not None:
        part_ms[:] = list(ms)
    _launch_backward.last_plan = plan
    if up != u:
        dxps = [slice_gates(x, u, up) for x in dxps]
        dwhs = [slice_gates(w[:u], u, up) for w in dwhs]
    return list(zip(dxps, dwhs))


_launch_backward.last_plan = None  # the plan of the last launch, for reports


class RecurrenceFunction(torch.autograd.Function):
    """Differentiable one-direction recurrence, the mirror of the custom
    VJP ``pallas_recurrence``: forward ``recurrence_residual``, backward
    ``recurrence_bwd``. → (out [T, B, U], h, c). The mask gets no
    gradient; a final-state cotangent that is not used arrives as zeros."""

    @staticmethod
    def forward(ctx, xp_tm, mask_tm, wh, forget_bias, reverse, prec):
        (out, hprev, cprev, h, c), = recurrence_residual([xp_tm], mask_tm, [wh], forget_bias, [reverse], prec)
        ctx.save_for_backward(xp_tm, mask_tm, wh, hprev, cprev)
        ctx.static = (forget_bias, reverse, prec)
        return out, h, c

    @staticmethod
    def backward(ctx, dout, dh, dc):
        xp, mask, wh, hprev, cprev = ctx.saved_tensors
        forget_bias, reverse, prec = ctx.static
        (dxp, dwh), = recurrence_bwd(
            [xp], mask, [wh], [hprev], [cprev], [dout], [dh], [dc], forget_bias, [reverse], prec
        )
        return dxp, None, dwh, None, None, None


class BidirRecurrenceFunction(torch.autograd.Function):
    """Differentiable two-direction recurrence, the mirror of the custom
    VJP ``pallas_bidir_recurrence``: forward one ``recurrence_residual``
    launch for both directions, backward one ``recurrence_bwd`` launch.
    → (out_f, out_b, hf, cf, hb, cb)."""

    @staticmethod
    def forward(ctx, xpf, xpb, mask_tm, whf, whb, forget_bias, prec):
        (of, hpf, cpf, hf, cf), (ob, hpb, cpb, hb, cb) = recurrence_residual(
            [xpf, xpb], mask_tm, [whf, whb], forget_bias, [False, True], prec
        )
        ctx.save_for_backward(xpf, xpb, mask_tm, whf, whb, hpf, cpf, hpb, cpb)
        ctx.static = (forget_bias, prec)
        return of, ob, hf, cf, hb, cb

    @staticmethod
    def backward(ctx, dof, dob, dhf, dcf, dhb, dcb):
        xpf, xpb, mask, whf, whb, hpf, cpf, hpb, cpb = ctx.saved_tensors
        forget_bias, prec = ctx.static
        (dxpf, dwhf), (dxpb, dwhb) = recurrence_bwd(
            [xpf, xpb], mask, [whf, whb], [hpf, hpb], [cpf, cpb], [dof, dob], [dhf, dhb],
            [dcf, dcb], forget_bias, [False, True], prec,
        )
        return dxpf, dxpb, None, dwhf, dwhb, None, None


@torch.library.custom_op("phones_las_torch::bidir_recurrence", mutates_args=(), device_types="cpu")
def bidir_recurrence_op(
    xpf_tm: torch.Tensor, xpb_tm: torch.Tensor, mask_tm: torch.Tensor, whf: torch.Tensor, whb: torch.Tensor,
    forget_bias: float, prec: str,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """The inference kernel of both directions as an operator → (out_f,
    out_b, hf, cf, hb, cb): the plain version on the CPU, one launch of
    ``plt_lstm_recurrence`` on CUDA, exact output shapes for tracing."""
    _check_prec(prec)
    out_f, out_b, (hf, cf), (hb, cb) = bidir_recurrence_plain(xpf_tm, xpb_tm, mask_tm, whf, whb, forget_bias, prec)
    return out_f, out_b, hf, cf, hb, cb


@bidir_recurrence_op.register_kernel("cuda")
def _(xpf_tm, xpb_tm, mask_tm, whf, whb, forget_bias, prec):
    _check_prec(prec)
    check_kernel_device(xpf_tm, xpb_tm, mask_tm, whf, whb)  # raises on mixed devices
    (out_f, _, _, hf, cf), (out_b, _, _, hb, cb) = _launch_forward(
        "plt_lstm_recurrence", [xpf_tm, xpb_tm], mask_tm, [whf, whb], forget_bias, [False, True], prec
    )
    _count(bidir_recurrence, prec, _launch_forward.last_plan)
    return out_f, out_b, hf, cf, hb, cb


@bidir_recurrence_op.register_fake
def _(xpf_tm, xpb_tm, mask_tm, whf, whb, forget_bias, prec):
    t, b, u4 = xpf_tm.shape
    new = lambda *shape: xpf_tm.new_empty(shape, dtype=torch.float32)
    return new(t, b, u4 // 4), new(t, b, u4 // 4), new(b, u4 // 4), new(b, u4 // 4), new(b, u4 // 4), new(b, u4 // 4)


def bidir_recurrence(
    xpf_tm: torch.Tensor,  # [T, B, 4U] float32, forward direction's projected input
    xpb_tm: torch.Tensor,  # [T, B, 4U] float32, backward direction's
    mask_tm: torch.Tensor,  # [T, B] float32
    whf: torch.Tensor,  # [U, 4U]
    whb: torch.Tensor,
    forget_bias: float = 1.0,
    prec: str = "highest",
):
    """Both directions of one BiLSTM layer → (out_f [T, B, U], out_b,
    (hf, cf), (hb, cb)), with ``lax.scan`` semantics for each direction,
    through the operator ``torch.ops.phones_las_torch.bidir_recurrence``.

    Replaces ``phones_las_tpu/ops/lstm.py::_recurrence_pallas_bidir``
    (reached through ``pallas_bidir_recurrence``). A CPU tensor runs the
    plain version; a CUDA tensor launches ``plt_lstm_recurrence`` of
    ``csrc/lstm.cu`` once for both directions (each direction's clusters
    run concurrently; ``forward_plan`` cuts the work) or raises. The reference's batch chunking at 64 rows (a
    VMEM limit) is dropped: the kernel takes any batch, and any U up to
    ``MAX_UNITS`` (zero padded where the plan runs a wider one).

    The kernel's bound on the H100 at the main path's first layer
    (T = 999, B = 64, U = 256): 2·2·T·B·U·4U ≈ 67 GFLOP of float32 for the
    recurrent dots, about 1.0 ms at 67 TFLOP/s, against 0.5 GB of xp read
    and 0.13 GB of output written (≈ 0.2 ms): operations bound it in
    float32; in bf16 mode the dots count at the bf16 rate and bytes bound
    it.
    """
    _check_prec(prec)
    check_kernel_device(xpf_tm, xpb_tm, mask_tm, whf, whb)
    out_f, out_b, hf, cf, hb, cb = torch.ops.phones_las_torch.bidir_recurrence(
        xpf_tm, xpb_tm, mask_tm, whf, whb, float(forget_bias), prec
    )
    return out_f, out_b, (hf, cf), (hb, cb)


bidir_recurrence.launches = 0
bidir_recurrence.bf16_launches = 0
bidir_recurrence.grid_launches = 0
bidir_recurrence.bf16_grid_launches = 0
bidir_recurrence.wgmma_grid_launches = 0


def _project_tm(p: LSTMParams, x: torch.Tensor) -> torch.Tensor:
    """[B, T, D] → time-major [T, B, 4U] projected input, bias included."""
    return (torch.matmul(x, p.wx) + p.b).transpose(0, 1).contiguous()


def _needs_grad(*tensors: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def lstm_layer(
    params: LSTMParams,
    x: torch.Tensor,  # [B, T, D]
    lengths: torch.Tensor,  # [B]
    *,
    reverse: bool = False,
    forget_bias: float = 1.0,
    prec: str = "highest",
) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """Unidirectional LSTM over a padded batch → (outputs [B, T, U] with
    zeros past each length, (h, c) final state). Without gradients the
    recurrence is ``recurrence``; under gradients ``RecurrenceFunction``."""
    mask_tm = length_mask(lengths, x.shape[1]).transpose(0, 1).contiguous()
    xp_tm = _project_tm(params, x)
    if _needs_grad(xp_tm, params.wh):
        out_tm, h, c = RecurrenceFunction.apply(xp_tm, mask_tm, params.wh, forget_bias, reverse, prec)
        state = (h, c)
    else:
        out_tm, state = recurrence(xp_tm, mask_tm, params.wh, forget_bias, reverse, prec)
    return out_tm.transpose(0, 1), state


def bilstm_layer(
    fwd: LSTMParams,
    bwd: LSTMParams,
    x: torch.Tensor,  # [B, T, D]
    lengths: torch.Tensor,  # [B]
    *,
    forget_bias: float = 1.0,
    prec: str = "highest",
) -> Tuple[torch.Tensor, Tuple]:
    """Bidirectional LSTM: concat(fwd, bwd) over the feature axis
    (``tf.nn.bidirectional_dynamic_rnn`` layout). Without gradients both
    recurrences are one ``bidir_recurrence`` call; under gradients one
    ``BidirRecurrenceFunction``. → (out [B, T, 2U], ((hf, cf), (hb, cb)))."""
    mask_tm = length_mask(lengths, x.shape[1]).transpose(0, 1).contiguous()
    xpf, xpb = _project_tm(fwd, x), _project_tm(bwd, x)
    if _needs_grad(xpf, xpb, fwd.wh, bwd.wh):
        out_f, out_b, hf, cf, hb, cb = BidirRecurrenceFunction.apply(
            xpf, xpb, mask_tm, fwd.wh, bwd.wh, forget_bias, prec
        )
        st_f, st_b = (hf, cf), (hb, cb)
    else:
        out_f, out_b, st_f, st_b = bidir_recurrence(xpf, xpb, mask_tm, fwd.wh, bwd.wh, forget_bias, prec)
    return torch.cat([out_f, out_b], dim=-1).transpose(0, 1), (st_f, st_b)
