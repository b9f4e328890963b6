"""Fused greedy decoder: the CUDA kernel ``csrc/greedy.cu`` and its plain
PyTorch version.

Replaces the Pallas kernel ``phones_las_tpu/decode/pallas_greedy.py::
greedy_decode_fused``. One CUDA block decodes one batch row and loops
over the steps inside the block, with the token, finished flag, attention
vector and every cell's h/c in shared memory, and the row's keys and
memory staged there when they fit. The reference runs 8-row groups one
after another on its single core, which confined it to batch ≤ 8; on the
H100 blocks run in parallel, so the kernel serves every batch size.

Bound on the H100 at the main path's shape (B = 64, T = 250, 200 steps,
2 × 256 cells): about 3.3 MFLOP of float32 per row and step, so
operations bound it (≈ 0.6 ms at 67 TFLOP/s when every row runs to the
cap; a row that emits <eos> stops), against 49 MB of keys and memory.
The kernel re-reads the speller weights (≈ 5.5 MB) from L2 at every step.

Reproduced exactly from the reference kernel: the forget bias
hard-coded to 1.0, float32 dots, and the masked softmax
``exp(s − max)·mask / max(Σ, 1e-30)``, which differs from
``attention_scores``'s for a row with no valid position.
"""

from __future__ import annotations

from typing import Tuple

import torch

from phones_las_torch.models.speller import SpellerConfig, SpellerParams
from phones_las_torch.ops.attention import precompute_keys
from phones_las_torch.utils.device import check_kernel_device

_NEG = -1e9


def supports(cfg: SpellerConfig) -> bool:
    return (
        cfg.attention_type == "bahdanau"
        and cfg.attention_layer_size > 0
        and cfg.binf_mode in ("none", "head")
    )


def decoded_lengths(tokens: torch.Tensor, eos_id: int) -> torch.Tensor:
    """[B, S] tokens → [B] count before the first <eos>."""
    return torch.sum(torch.cumsum(tokens == eos_id, dim=1) == 0, dim=1).to(torch.int32)


def greedy_decode_fused_plain(
    params: SpellerParams,
    cfg: SpellerConfig,
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


def greedy_decode_fused(
    params: SpellerParams,
    cfg: SpellerConfig,
    memory: torch.Tensor,  # [B, T, M] float32
    enc_mask: torch.Tensor,  # [B, T]
    max_steps: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """→ (tokens [B, max_steps] <eos>-padded, lengths [B]).

    A CPU tensor runs the plain version; a CUDA tensor launches the
    kernel (built at first use) or raises."""
    if not supports(cfg):
        raise ValueError("the fused greedy decoder takes bahdanau attention with an attention layer")
    if memory.ndim != 3 or memory.dtype != torch.float32:
        raise ValueError(f"memory must be [B, T, M] float32, got {tuple(memory.shape)} {memory.dtype}")
    b, t, m = memory.shape
    if enc_mask.shape != (b, t) or m != cfg.memory_dim:
        raise ValueError(f"enc_mask {tuple(enc_mask.shape)} / memory {tuple(memory.shape)} do not match the config")
    weights = [
        params.embedding, params.attention.wq, params.attention.v,
        params.attention_layer, params.out_w, params.out_b,
    ]
    for cell in params.cells:
        weights += [cell.wx, cell.wh, cell.b]
    if not check_kernel_device(memory, enc_mask, *weights):
        return greedy_decode_fused_plain(params, cfg, memory, enc_mask, max_steps)

    from phones_las_torch.csrc import _build

    lib = _build.library()
    dev = memory.device
    keys = precompute_keys(params.attention, memory).contiguous()
    mem = memory.contiguous()
    mask = enc_mask.to(torch.float32).contiguous()
    w = [x.detach().to(torch.float32).contiguous() for x in weights]
    emb, wq, v, attn_w, out_w, out_b = w[:6]
    cell_ptrs = torch.tensor([x.data_ptr() for x in w[6:]], dtype=torch.int64, device=dev)
    tokens = torch.empty((b, max_steps), dtype=torch.int32, device=dev)
    err = lib.plt_greedy_decode(
        keys.data_ptr(), mem.data_ptr(), mask.data_ptr(), b, t,
        cfg.attention_units, m, emb.data_ptr(), cfg.vocab_size,
        cfg.embedding_dim, wq.data_ptr(), v.data_ptr(), attn_w.data_ptr(),
        cfg.attention_layer_size, out_w.data_ptr(), out_b.data_ptr(),
        cell_ptrs.data_ptr(), len(params.cells), cfg.units, cfg.bos_id,
        cfg.eos_id, max_steps, tokens.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    _build.check(err, "plt_greedy_decode")
    greedy_decode_fused.launches += 1
    return tokens, decoded_lengths(tokens, cfg.eos_id)


greedy_decode_fused.launches = 0
