"""LSTM layers (port of ``phones_las_tpu/ops/lstm.py``).

Cell semantics as the reference (TF1 ``BasicLSTMCell``): parameters
``wx [D, 4U]``, ``wh [U, 4U]`` and one bias ``b [4U]``, gate order
(i, f, g, o), and ``forget_bias`` added to the forget preactivation at
run time, not folded into the stored bias. Per-step masking reproduces
``dynamic_rnn(sequence_length=...)``: the state freezes and the output
is zero past each row's length. ``torch.nn.LSTM`` is not used.

The input projection ``x @ wx + b`` for all steps is one matrix product;
the serial recurrence ``gates = xp[t] + h @ wh`` runs either as the plain
PyTorch loop ``recurrence_plain`` (the mirror of ``_recurrence_xla``) or,
for both directions of a BiLSTM layer on a CUDA tensor, as the CUDA
kernel ``csrc/bilstm.cu`` behind ``bidir_recurrence``.

Recurrent-dot precision is an explicit argument ``prec`` (the reference
reads it from the ambient ``jax.default_matmul_precision`` scope):
'highest' is float32; 'bf16' rounds h and wh to bf16 and accumulates in
float32, with the gate math and the cell state in float32.
"""

from __future__ import annotations

from typing import Tuple

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


def rec_dot(h: torch.Tensor, wh: torch.Tensor, prec: str) -> torch.Tensor:
    """h @ wh at the recurrent-dot precision: float32, or bf16 operands
    with float32 accumulation (a product of two bf16 values is exact in
    float32, so rounding the operands and multiplying in float32 is the
    bf16×bf16→f32 dot)."""
    if prec == "bf16":
        return torch.matmul(_bf16_round(h), _bf16_round(wh))
    return torch.matmul(h, wh)


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
    _check_prec(prec)
    t, b, four_u = xp_tm.shape
    u = four_u // 4
    h = torch.zeros((b, u), dtype=torch.float32, device=xp_tm.device)
    c = torch.zeros_like(h)
    out = torch.empty((t, b, u), dtype=torch.float32, device=xp_tm.device)
    for tt in (range(t - 1, -1, -1) if reverse else range(t)):
        gates = xp_tm[tt] + rec_dot(h, wh, prec)
        h_new, c_new = _cell_math(gates, c, forget_bias)
        m = mask_tm[tt][:, None]
        h = m * h_new + (1.0 - m) * h
        c = m * c_new + (1.0 - m) * c
        out[tt] = m * h_new
    return out, (h, c)


def bidir_recurrence_plain(xpf_tm, xpb_tm, mask_tm, whf, whb, forget_bias=1.0, prec="highest"):
    """Plain version of the BiLSTM kernel: → (out_f, out_b, (hf, cf), (hb, cb))."""
    out_f, st_f = recurrence_plain(xpf_tm, mask_tm, whf, forget_bias, False, prec)
    out_b, st_b = recurrence_plain(xpb_tm, mask_tm, whb, forget_bias, True, prec)
    return out_f, out_b, st_f, st_b


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
    plain version; a CUDA tensor launches ``csrc/bilstm.cu`` or raises.

    The kernel's bound on the H100 at the main path's first layer
    (T = 999, B = 64, U = 256): 2·2·T·B·U·4U ≈ 67 GFLOP of float32 for the
    recurrent dots, about 1.0 ms at 67 TFLOP/s, against 0.5 GB of xp read
    and 0.13 GB of output written (≈ 0.2 ms): operations bound it in
    float32; in bf16 mode the dots count at the bf16 rate and bytes bound
    it. Each block runs one direction for 4 rows and reads wh (1 MB in
    float32, 512 KB in bf16 — more than a block's 227 KB of shared memory)
    from L2 at every step, one thread per gate column; h and c stay in
    shared memory and registers. The reference's batch chunking at 64
    rows (a VMEM limit) is dropped: the kernel takes any batch.
    """
    _check_prec(prec)
    if not check_kernel_device(xpf_tm, xpb_tm, mask_tm, whf, whb):
        return bidir_recurrence_plain(xpf_tm, xpb_tm, mask_tm, whf, whb, forget_bias, prec)

    t, b, four_u = xpf_tm.shape
    u = four_u // 4
    if xpb_tm.shape != xpf_tm.shape or mask_tm.shape != (t, b):
        raise ValueError(f"shape mismatch: {tuple(xpf_tm.shape)} {tuple(xpb_tm.shape)} {tuple(mask_tm.shape)}")
    if whf.shape != (u, four_u) or whb.shape != (u, four_u):
        raise ValueError(f"wh must be [{u}, {four_u}], got {tuple(whf.shape)} {tuple(whb.shape)}")
    if four_u % 32 or four_u > 1024:
        raise ValueError(f"the BiLSTM kernel takes 4U a multiple of 32 up to 1024, got 4U={four_u}")
    for x in (xpf_tm, xpb_tm, mask_tm):
        if x.dtype != torch.float32:
            raise ValueError(f"expected float32 inputs, got {x.dtype}")

    from phones_las_torch.csrc import _build

    lib = _build.library()
    wdt = torch.bfloat16 if prec == "bf16" else torch.float32
    xpf, xpb, mask = xpf_tm.contiguous(), xpb_tm.contiguous(), mask_tm.contiguous()
    whf_k = whf.to(wdt).contiguous()
    whb_k = whb.to(wdt).contiguous()
    dev = xpf.device
    out_f = torch.empty((t, b, u), dtype=torch.float32, device=dev)
    out_b = torch.empty_like(out_f)
    hf, cf, hb, cb = (torch.empty((b, u), dtype=torch.float32, device=dev) for _ in range(4))
    err = lib.plt_bilstm(
        xpf.data_ptr(), xpb.data_ptr(), mask.data_ptr(), whf_k.data_ptr(),
        whb_k.data_ptr(), int(prec == "bf16"), out_f.data_ptr(),
        out_b.data_ptr(), hf.data_ptr(), cf.data_ptr(), hb.data_ptr(),
        cb.data_ptr(), t, b, u, float(forget_bias),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    _build.check(err, "plt_bilstm")
    bidir_recurrence.launches += 1
    return out_f, out_b, (hf, cf), (hb, cb)


bidir_recurrence.launches = 0


def _project_tm(p: LSTMParams, x: torch.Tensor) -> torch.Tensor:
    """[B, T, D] → time-major [T, B, 4U] projected input, bias included."""
    return (torch.matmul(x, p.wx) + p.b).transpose(0, 1).contiguous()


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
    zeros past each length, (h, c) final state). Runs the plain
    recurrence on every device: its kernel (the reference's
    ``_recurrence_pallas``) is not ported yet."""
    mask_tm = length_mask(lengths, x.shape[1]).transpose(0, 1)
    out_tm, state = recurrence_plain(
        _project_tm(params, x), mask_tm, params.wh, forget_bias, reverse, prec
    )
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
    (``tf.nn.bidirectional_dynamic_rnn`` layout), both recurrences in one
    ``bidir_recurrence`` call. → (out [B, T, 2U], ((hf, cf), (hb, cb)))."""
    mask_tm = length_mask(lengths, x.shape[1]).transpose(0, 1).contiguous()
    out_f, out_b, st_f, st_b = bidir_recurrence(
        _project_tm(fwd, x), _project_tm(bwd, x), mask_tm, fwd.wh, bwd.wh,
        forget_bias, prec,
    )
    return torch.cat([out_f, out_b], dim=-1).transpose(0, 1), (st_f, st_b)
