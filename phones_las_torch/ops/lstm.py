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
  BiLSTM layer and ``recurrence`` one direction of ``lstm_layer``, each
  one launch of the same primal kernel;
* under gradients, ``RecurrenceFunction`` and ``BidirRecurrenceFunction``
  (the reference's custom VJPs ``pallas_recurrence`` and
  ``pallas_bidir_recurrence``) run ``recurrence_residual`` forward, which
  also saves the carried state before each step, and ``recurrence_bwd``
  backward.

The forward kernel is one template launched as thread-block clusters: a
cluster of C blocks runs one direction for a tile of Bt batch rows over
all T steps, block c owning units ``[c·U/C, (c+1)·U/C)`` with their four
gate columns and holding that slice of ``wh`` in shared memory for the
whole time loop; each step the blocks exchange their h slices through
distributed shared memory (``st.async`` onto transaction barriers). The
VJP's serial loop is the same design run backwards in time: block c
multiplies the gate gradients of its own units by its resident slice of
``whᵀ`` into a partial dh of every unit, the blocks send each other the
parts they own and add them in rank order (so repeated runs are bitwise
equal). What of this is layout and choice lives here, where the CPU tests
reach it: ``regroup_wh``/``ungroup_wh`` (``wh`` by unit slice),
``forward_plan`` and ``backward_plan`` (C, Bt, the k split and the
shared-memory bytes from the shape, pure functions);
``tests/test_torch_cluster_layout.py`` and
``tests/test_torch_lstm_bwd_layout.py`` emulate the two decompositions in
plain PyTorch on them.

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
    if four_u % 32 or four_u > 1024:
        raise ValueError(f"{name}: the kernel takes 4U a multiple of 32 up to 1024, got 4U={four_u}")
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
    recurrence.launches += 1
    return out, (h, c)


recurrence.launches = 0


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
    recurrence_residual.launches += 1
    return res


recurrence_residual.launches = 0


# the forward kernel's constants, as csrc/lstm.cu has them
FWD_THREADS = 256
SMEM_MAX = 232448  # dynamic shared memory a block may use on the H100
CLUSTER_SIZES = (8, 4, 2, 1)  # tried in this order; 8 is the portable maximum
ROW_TILES = (8, 16)
XP_RING = 3  # xp tiles a block keeps in flight


class ForwardPlan(NamedTuple):
    """How one launch of the forward kernel cuts its work."""

    cluster: int  # C: blocks of a cluster = slices of the units
    bt: int  # batch rows of a cluster's tile
    ksplit: int  # float32: parts the k range is split into among the warps
    resident: bool  # the block's wh slice lies in shared memory
    smem: int  # dynamic shared memory bytes of a block


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
    """``wh`` as the forward kernel reads it: float32 ``[C, U, 4·U/C]``, or
    for the tensor cores bf16 ``[C, 4·U/C, K]`` with k contiguous and zero
    padded to K = U rounded up to 16."""
    wg = regroup_wh(wh.detach(), c)
    if prec != "bf16":
        return wg.to(torch.float32).contiguous()
    u = wg.shape[1]
    wt = wg.to(torch.bfloat16).transpose(1, 2)
    return torch.nn.functional.pad(wt, (0, -u % 16)).contiguous()


def forward_smem_bytes(u: int, c: int, bt: int, ksplit: int, resident: bool, bf16: bool) -> int:
    """A block's dynamic shared memory, as ``fwd_layout`` of csrc/lstm.cu
    lays it out: the wh slice, two h buffers, the partial sums, three xp
    tiles (gates and mask) and the state (c, h, out)."""
    us = u // c
    nc = 4 * us
    kp = -(-u // 16) * 16
    if bf16:
        w = nc * (kp + 8) * 2
        h = 2 * 16 * (kp + 8) * 2
    else:
        w = u * nc * 4
        h = 2 * bt * u * 4
    return (w if resident else 0) + h + ksplit * bt * nc * 4 + XP_RING * (bt * nc + bt) * 4 + 3 * bt * us * 4


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


def forward_plan(
    b: int, u: int, nd: int, prec: str = "highest",
    max_active: Optional[Callable[[int, int, int, bool], int]] = None,
) -> ForwardPlan:
    """The forward kernel's (C, Bt, k split) for a shape — a pure function.

    C is the largest of ``CLUSTER_SIZES`` that divides U into slices of a
    multiple of 8 units whose wh slice fits in shared memory beside the
    rest; if none does, C = 1 streams wh from L2. Bt is the smallest tile
    (the shortest step) whose ``ceil(B/Bt)·nd`` clusters the card runs at
    once, as ``max_active(C, Bt, ksplit, resident)`` says (on the card:
    ``cudaOccupancyMaxActiveClusters``); without that knowledge, or if no
    tile fits in one wave, the largest tile that fits in shared memory.
    Raises for a U the kernel does not take."""
    _check_prec(prec)
    if u % 8 or not 0 < 4 * u <= 1024:
        raise ValueError(f"the kernel takes 4U a multiple of 32 up to 1024, got 4U={4 * u}")
    bf16 = prec == "bf16"
    for c, resident in [(c, True) for c in CLUSTER_SIZES] + [(1, False)]:
        if u % c or (u // c) % 8:
            continue
        fits = []
        for bt in ROW_TILES:
            ks = _ksplit(u, c, bt, bf16)
            smem = forward_smem_bytes(u, c, bt, ks, resident, bf16)
            if smem <= SMEM_MAX:
                fits.append(ForwardPlan(c, bt, ks, resident, smem))
        if fits:
            active = None if max_active is None else (lambda p: max_active(p.cluster, p.bt, p.ksplit, p.resident))
            return _choose_tile(fits, b, nd, active)
    raise ValueError(f"no plan of the forward kernel fits U={u} in shared memory")


@functools.lru_cache(maxsize=None)
def forward_kernel_info(u: int, bf16: bool, save_res: bool, c: int, bt: int, ksplit: int, resident: bool) -> dict:
    """What the card gives one plan of the forward kernel (built at first
    use): the clusters it runs at once, its dynamic and static shared
    memory bytes and its registers a thread."""
    from phones_las_torch.csrc import _build

    info = (ctypes.c_int * 4)()
    err = _build.library().plt_lstm_fwd_info(u, int(bf16), int(save_res), c, bt, ksplit, int(resident), info)
    _build.check(err, "plt_lstm_fwd_info")
    return {"max_active_clusters": info[0], "smem_bytes": info[1], "registers": info[2], "static_smem_bytes": info[3]}


def _launch_forward(entry, xps, mask_tm, whs, forget_bias, reverse, prec, plan: Optional[ForwardPlan] = None,
                    clocks: Optional[torch.Tensor] = None):
    """One launch of the forward kernel. ``plan`` overrides ``forward_plan``
    (measurements only); ``clocks``, an int64 CUDA tensor of 4, receives the
    SM cycles one block spent in the product, the cell update, the output
    stores and the wait for the peers' h."""
    t, b, u = _check_recurrence_args(xps, mask_tm, whs, entry)
    from phones_las_torch.csrc import _build

    lib = _build.library()
    bf16 = prec == "bf16"
    save = entry == "plt_lstm_residual"
    nd = len(xps)
    if plan is None:
        plan = forward_plan(
            b, u, nd, prec,
            lambda c, bt, ks, res: forward_kernel_info(u, bf16, save, c, bt, ks, res)["max_active_clusters"],
        )
    wdt = torch.bfloat16 if bf16 else torch.float32
    xps = [x.contiguous() for x in xps]
    whs = [_kernel_wh(w, plan.cluster, prec) for w in whs]
    mask = mask_tm.contiguous()
    dev = xps[0].device
    outs = [torch.empty((t, b, u), dtype=torch.float32, device=dev) for _ in range(nd)]
    hprevs = [torch.empty((t, b, u), dtype=wdt, device=dev) for _ in range(nd)] if save else []
    cprevs = [torch.empty((t, b, u), dtype=wdt, device=dev) for _ in range(nd)] if save else []
    hs = [torch.empty((b, u), dtype=torch.float32, device=dev) for _ in range(nd)]
    cs = [torch.empty((b, u), dtype=torch.float32, device=dev) for _ in range(nd)]
    err = getattr(lib, entry)(
        *_ptrs(xps), mask.data_ptr(), *_ptrs(whs), nd, _rev_bits(reverse),
        int(bf16), *_ptrs(outs), *_ptrs(hprevs), *_ptrs(cprevs),
        *_ptrs(hs), *_ptrs(cs), t, b, u, float(forget_bias),
        plan.cluster, plan.bt, plan.ksplit, int(plan.resident),
        None if clocks is None else clocks.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    _build.check(err, entry)
    _launch_forward.last_plan = plan
    none = [None] * nd
    return list(zip(outs, hprevs or none, cprevs or none, hs, cs))


_launch_forward.last_plan = None  # the plan of the last launch, for reports


class BackwardPlan(NamedTuple):
    """How one launch of the VJP's loop kernel cuts its work."""

    cluster: int  # C: blocks of a cluster = slices of the units
    bt: int  # batch rows of a cluster's tile
    ksplit: int  # float32: parts the k range (a block's 4·U/C gate columns) is split into
    resident: bool  # the block's slice of whᵀ lies in shared memory
    smem: int  # dynamic shared memory bytes of a block


BWD_RING = 2  # tiles of factors, dout and mask a block keeps: one in use, one in flight


def _kernel_wht(wh: torch.Tensor, c: int, prec: str) -> torch.Tensor:
    """The slices of ``whᵀ`` as the VJP's loop kernel reads them. Block s
    multiplies the gate gradients of its units (its 4·U/C columns, in
    ``regroup_wh``'s order) by the matching rows of ``whᵀ``: float32
    ``[C, 4·U/C, U]`` (U contiguous), or for the tensor cores bf16
    ``[C, Up, 4·U/C]`` with the contracted gate columns contiguous and the
    units zero padded to Up = U rounded up to 16."""
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
    dout and two more factors a unit, then the mask) and the kept dh and dc."""
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


def backward_plan(
    b: int, u: int, nd: int, prec: str = "highest",
    max_active: Optional[Callable[[BackwardPlan], int]] = None,
) -> BackwardPlan:
    """The (C, Bt, k split) of the VJP's loop kernel for a shape — a pure
    function, the companion of ``forward_plan``.

    C is the largest of ``CLUSTER_SIZES`` that divides U into slices of a
    multiple of 8 units whose slice of whᵀ fits in shared memory beside the
    rest; if none does, C = 1 streams it from L2. For each tile Bt the k
    split is the largest that fits (halved until it does). Bt is then chosen as ``forward_plan`` chooses
    it: the smallest tile whose ``ceil(B/Bt)·nd`` clusters the card runs at
    once, as ``max_active(plan)`` says (on the card:
    ``cudaOccupancyMaxActiveClusters``); without that knowledge, or if no
    tile fits in one wave, the largest tile that fits in shared memory.
    Raises for a U the kernel does not take."""
    _check_prec(prec)
    if u % 8 or not 0 < 4 * u <= 1024:
        raise ValueError(f"the kernel takes 4U a multiple of 32 up to 1024, got 4U={4 * u}")
    bf16 = prec == "bf16"
    for c, resident in [(c, True) for c in CLUSTER_SIZES] + [(1, False)]:
        if u % c or (u // c) % 8:
            continue
        fits = []
        for bt in ROW_TILES:
            ks = _bwd_ksplit(u, c, bt, bf16)
            while ks > 1 and backward_smem_bytes(u, c, bt, ks, resident, bf16) > SMEM_MAX:
                ks //= 2
            smem = backward_smem_bytes(u, c, bt, ks, resident, bf16)
            if smem <= SMEM_MAX:
                fits.append(BackwardPlan(c, bt, ks, resident, smem))
        if fits:
            return _choose_tile(fits, b, nd, max_active)
    raise ValueError(f"no plan of the VJP's loop kernel fits U={u} in shared memory")


@functools.lru_cache(maxsize=None)
def backward_kernel_info(u: int, bf16: bool, plan: BackwardPlan) -> dict:
    """What the card gives one plan of the VJP's loop kernel (built at
    first use), as ``forward_kernel_info``."""
    from phones_las_torch.csrc import _build

    info = (ctypes.c_int * 4)()
    err = _build.library().plt_lstm_bwd_info(
        u, int(bf16), plan.cluster, plan.bt, plan.ksplit, int(plan.resident), info
    )
    _build.check(err, "plt_lstm_bwd_info")
    return {"max_active_clusters": info[0], "smem_bytes": info[1], "registers": info[2], "static_smem_bytes": info[3]}


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
    leave the serial chain); the serial reverse loop as thread-block
    clusters (``backward_plan``: a cluster of C blocks per direction and
    tile of Bt rows, each block with its slice of whᵀ in shared memory,
    the partial dh exchanged through distributed shared memory and added
    in rank order); the split-K dWh GEMM and its ordered reduction. In
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
    recurrence_bwd.launches += 1
    return res


recurrence_bwd.launches = 0


def _launch_backward(xps, mask_tm, whs, hprevs, cprevs, douts, dhfins, dcfins, forget_bias, reverse, prec,
                     plan: Optional[BackwardPlan] = None, clocks: Optional[torch.Tensor] = None,
                     part_ms: Optional[list] = None):
    """One launch of ``plt_lstm_bwd``. For measurements: ``plan`` overrides
    ``backward_plan``; ``clocks``, an int64 CUDA tensor of 5, receives the SM
    cycles one block of the loop spent forming dgates, in the product,
    sending the partials, requesting a later tile, and waiting for the
    peers; ``part_ms``, a list, receives the milliseconds of the four
    kernels (the call then waits for the stream)."""
    t, b, u = _check_recurrence_args(xps, mask_tm, whs, "plt_lstm_bwd")
    nd = len(xps)
    bf16 = prec == "bf16"
    wdt = torch.bfloat16 if bf16 else torch.float32
    for x in (*hprevs, *cprevs):
        if x.shape != (t, b, u) or x.dtype != wdt:
            raise ValueError(f"plt_lstm_bwd: residuals must be [{t}, {b}, {u}] {wdt}, got {tuple(x.shape)} {x.dtype}")

    from phones_las_torch.csrc import _build

    lib = _build.library()
    if plan is None:
        plan = backward_plan(b, u, nd, prec, lambda p: backward_kernel_info(u, bf16, p)["max_active_clusters"])
    f32 = lambda ts: [x.float().contiguous() for x in ts]
    xps, douts, dhfins, dcfins = f32(xps), f32(douts), f32(dhfins), f32(dcfins)
    whs_d = [w.detach().to(wdt).contiguous() for w in whs]
    whgs = [_kernel_wht(w, plan.cluster, prec) for w in whs]
    whts = [w.t().contiguous() for w in whs_d] if bf16 else []  # the tensor-core gates GEMM reads k contiguous
    hprevs = [x.contiguous() for x in hprevs]
    cprevs = [x.contiguous() for x in cprevs]
    mask = mask_tm.contiguous()
    dev = xps[0].device
    dxps = [torch.empty((t, b, 4 * u), dtype=torch.float32, device=dev) for _ in range(nd)]
    dwhs = [torch.empty((u, 4 * u), dtype=torch.float32, device=dev) for _ in range(nd)]
    facs = [torch.empty((t, b, 2 * u), dtype=torch.float32, device=dev) for _ in range(nd)]
    # split-K of the dWh product over T*B rows: enough blocks to fill the card
    dwh_split = max(1, min(16, (t * b) // 1024))
    partials = torch.empty((nd, dwh_split, u, 4 * u), dtype=torch.float32, device=dev)
    ms = (ctypes.c_float * 4)() if part_ms is not None else None
    err = lib.plt_lstm_bwd(
        *_ptrs(xps), mask.data_ptr(), *_ptrs(whs_d), *_ptrs(whgs), *_ptrs(whts), *_ptrs(hprevs),
        *_ptrs(cprevs), *_ptrs(douts), *_ptrs(dhfins), *_ptrs(dcfins), nd,
        _rev_bits(reverse), int(bf16), *_ptrs(dxps), *_ptrs(facs), *_ptrs(dwhs),
        partials.data_ptr(), dwh_split, t, b, u, float(forget_bias),
        plan.cluster, plan.bt, plan.ksplit, int(plan.resident),
        None if clocks is None else clocks.data_ptr(), ms,
        torch.cuda.current_stream(dev).cuda_stream,
    )
    _build.check(err, "plt_lstm_bwd")
    if part_ms is not None:
        part_ms[:] = list(ms)
    _launch_backward.last_plan = plan
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
    (hf, cf), (hb, cb)), with ``lax.scan`` semantics for each direction.

    Replaces ``phones_las_tpu/ops/lstm.py::_recurrence_pallas_bidir``
    (reached through ``pallas_bidir_recurrence``). A CPU tensor runs the
    plain version; a CUDA tensor launches ``plt_lstm_recurrence`` of
    ``csrc/lstm.cu`` once for both directions (each direction's clusters
    run concurrently; ``forward_plan`` cuts the work) or raises. The reference's batch chunking at 64 rows (a
    VMEM limit) is dropped: the kernel takes any batch.

    The kernel's bound on the H100 at the main path's first layer
    (T = 999, B = 64, U = 256): 2·2·T·B·U·4U ≈ 67 GFLOP of float32 for the
    recurrent dots, about 1.0 ms at 67 TFLOP/s, against 0.5 GB of xp read
    and 0.13 GB of output written (≈ 0.2 ms): operations bound it in
    float32; in bf16 mode the dots count at the bf16 rate and bytes bound
    it.
    """
    _check_prec(prec)
    if not check_kernel_device(xpf_tm, xpb_tm, mask_tm, whf, whb):
        return bidir_recurrence_plain(xpf_tm, xpb_tm, mask_tm, whf, whb, forget_bias, prec)
    (out_f, _, _, hf, cf), (out_b, _, _, hb, cb) = _launch_forward(
        "plt_lstm_recurrence", [xpf_tm, xpb_tm], mask_tm, [whf, whb], forget_bias, [False, True], prec
    )
    bidir_recurrence.launches += 1
    return out_f, out_b, (hf, cf), (hb, cb)


bidir_recurrence.launches = 0


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
