"""Exact zero padding of widths for the kernels, as pure functions on tensors.

The CUDA kernels cut their widths into slices of a fixed granularity (the
LSTM kernels U in multiples of 8 units a block, the greedy decoder its
widths in multiples of 4, the attention layer of 8, and of 4·C for a cut
over C blocks). A width that is no such multiple runs at the next one,
with the weights, inputs and memory padded with zeros, and the results
sliced back. Why that is exact:

* An LSTM unit whose gate columns (of ``wx``, ``wh``, ``b`` and so of the
  projected input ``xp``) are all zero has gates 0, so g = tanh(0) = 0 and
  ``c' = σ(0 + forget_bias)·c + σ(0)·0``: from c₀ = 0 its cell stays 0 at
  every step, and ``h = σ(0)·tanh(0) = 0``. Its row of ``wh`` (and of every
  weight that reads h) is zero too, so the real units see the same sums
  with zeros added. Backwards, its dh is a sum over zero rows of ``wh``, its
  dc starts at 0 and stays 0, so its gate gradients are 0 and it adds
  nothing to the real units' dh; its rows and columns of dWh are 0.
* A padded attention unit has a zero column of ``wk`` and ``wq`` and a zero
  entry of ``v``: its term of the score is tanh(0 + 0)·0 = 0.
* A padded memory column is zero, so the context's entry there is 0, and
  the attention layer's row for it is zero.
* A padded attention-layer column is zero, so that entry of the attention
  vector is 0; the rows of ``out_w`` and of the first cell's ``wx`` that
  read it are zero.
* A padded embedding column is zero, and the first cell's row for it too.

The sums of the real entries gain only exact zeros; a kernel may still
split them in another order than the unpadded run would.
"""

from __future__ import annotations

from typing import Sequence

import torch


def round_up(n: int, k: int) -> int:
    return -(-n // k) * k


def pad_blocks(x: torch.Tensor, dim: int, sizes: Sequence[int], padded: Sequence[int]) -> torch.Tensor:
    """``x`` cut along ``dim`` into consecutive blocks of ``sizes``, each
    block zero padded at its end to the matching entry of ``padded``, the
    blocks put back together. ``x`` itself when nothing grows."""
    if x.shape[dim] != sum(sizes) or any(p < s for s, p in zip(sizes, padded)):
        raise ValueError(f"pad_blocks: dim {dim} of {tuple(x.shape)} is not blocks {list(sizes)} <= {list(padded)}")
    if list(sizes) == list(padded):
        return x
    parts = []
    for blk, s, p in zip(torch.split(x, list(sizes), dim=dim), sizes, padded):
        parts.append(blk)
        if p > s:
            shape = list(x.shape)
            shape[dim] = p - s
            parts.append(x.new_zeros(shape))
    return torch.cat(parts, dim=dim)


def slice_blocks(x: torch.Tensor, dim: int, sizes: Sequence[int], padded: Sequence[int]) -> torch.Tensor:
    """The inverse of ``pad_blocks``: the first ``sizes[i]`` entries of each
    block of ``padded``, contiguous. ``x`` itself when nothing shrinks."""
    if x.shape[dim] != sum(padded):
        raise ValueError(f"slice_blocks: dim {dim} of {tuple(x.shape)} is not blocks {list(padded)}")
    if list(sizes) == list(padded):
        return x
    blocks = torch.split(x, list(padded), dim=dim)
    return torch.cat([b.narrow(dim, 0, s) for b, s in zip(blocks, sizes)], dim=dim).contiguous()


def pad_gates(x: torch.Tensor, u: int, up: int) -> torch.Tensor:
    """``[..., 4U]`` (gate-major columns i|f|g|o) → ``[..., 4Up]``, each gate's block zero padded."""
    return pad_blocks(x, -1, [u] * 4, [up] * 4)


def slice_gates(x: torch.Tensor, u: int, up: int) -> torch.Tensor:
    """``[..., 4Up]`` → ``[..., 4U]``, the inverse of ``pad_gates``."""
    return slice_blocks(x, -1, [u] * 4, [up] * 4)


def pad_units(x: torch.Tensor, u: int, up: int) -> torch.Tensor:
    """``[..., U]`` → ``[..., Up]`` with zeros (a state, an output, a residual)."""
    return pad_blocks(x, -1, [u], [up])


def pad_lstm_wh(wh: torch.Tensor, up: int) -> torch.Tensor:
    """``wh [U, 4U]`` → ``[Up, 4Up]``: zero rows for the padded units' h and
    zero columns in each gate's block."""
    u = wh.shape[0]
    return pad_blocks(pad_gates(wh, u, up), 0, [u], [up])
