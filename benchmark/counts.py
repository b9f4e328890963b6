"""Operations and bytes a call needs, from its shapes alone.

What the algorithm needs, whatever implements it: a frame's spectrum is a
real FFT (2.5 N log2 N operations), not a dense DFT product; a mel
channel multiplies only its filter's non-zero bins; a recurrence reads
each input byte once; every count runs to each utterance's own length
(padding needs no work), and the decoder over the steps it ran. A
product counts 2 operations a multiply-add; each elementwise operation,
transcendental or not, counts 1. Bytes are float32 (4 bytes) where the
model stores float32.

Generalised from the port's ``bench.py::flagship_flops_per_utt``: any
configuration, any lengths, any number of steps.
"""

from __future__ import annotations

import math
from typing import Dict, Sequence

import numpy as np

from benchmark.reference import frame_count, mel_filterbank

F32 = 4


def _win_hop(fe: dict):
    rate = fe["sample_rate"]
    return (int(math.floor(fe["win_ms"] * rate / 1000.0 + 0.5)),
            int(math.floor(fe["hop_ms"] * rate / 1000.0 + 0.5)))


def frames(samples: int, fe: dict) -> int:
    win, hop = _win_hop(fe)
    return frame_count(int(samples), win, hop)


def layer_lengths(t: int, layers: int) -> list:
    """Frames each listener layer runs over: halved (rounded up) before
    every layer but the first."""
    out = [t]
    for _ in range(layers - 1):
        out.append((out[-1] + 1) // 2)
    return out


def frontend(samples: Sequence[int], fe: dict) -> Dict[str, float]:
    """The log-mel: framing, a real FFT a frame, power, the mel filters'
    non-zeros, the log; reads the signal once (float32), writes log-mel
    and energy."""
    nfft, nmel = fe["nfft"], fe["num_mel"]
    bins = nfft // 2 + 1
    high = fe.get("high_hz") or fe["sample_rate"] / 2.0
    nnz = int(np.count_nonzero(mel_filterbank(nfft, nmel, fe["sample_rate"], float(fe.get("low_hz", 0.0)),
                                              float(high))))
    per_frame = 2.5 * nfft * math.log2(nfft) + 3 * bins + 2 * nnz + nmel
    t = sum(frames(n, fe) for n in samples)
    return {"flops": t * per_frame, "bytes": F32 * (sum(samples) + t * (nmel + 1))}


def deltas_cmvn(samples: Sequence[int], fe: dict) -> Dict[str, float]:
    """Δ, ΔΔ and CMVN on the log-mel (outside the front-end kernel)."""
    nmel, n = fe["num_mel"], fe["delta_width"]
    t = sum(frames(s, fe) for s in samples)
    return {"flops": t * (2 * nmel * (3 * n + 1) + 2 * 3 * nmel), "bytes": F32 * t * (nmel + 2 * 3 * nmel)}


def listener(samples: Sequence[int], cfg: dict) -> Dict[str, Dict[str, float]]:
    """The recurrences (h @ wh, the gates, the cell) and, apart, the input
    projections (x @ wx + b), both directions of every layer."""
    li, fe = cfg["listener"], cfg["frontend"]
    u, layers = li["units"], li["num_layers"]
    rec_f = rec_b = proj_f = proj_b = 0.0
    for l in range(layers):
        d = li["input_dim"] if l == 0 else 4 * u
        steps = sum(layer_lengths(frames(n, fe), layers)[l] for n in samples)
        rec_f += 2 * steps * (2 * u * 4 * u + 4 * u + 10 * u)
        rec_b += 2 * (steps * F32 * (4 * u + u) + F32 * u * 4 * u)
        proj_f += 2 * steps * (2 * d * 4 * u + 4 * u)
        proj_b += 2 * F32 * (steps * (d + 4 * u) + d * 4 * u + 4 * u)
    return {"recurrence": {"flops": rec_f, "bytes": rec_b}, "projection": {"flops": proj_f, "bytes": proj_b}}


def encoder_frames(samples: Sequence[int], cfg: dict) -> list:
    layers = cfg["listener"]["num_layers"]
    return [layer_lengths(frames(n, cfg["frontend"]), layers)[-1] for n in samples]


def decoder(samples: Sequence[int], steps: Sequence[int], cfg: dict) -> Dict[str, Dict[str, float]]:
    """The greedy decoder's steps (cells, attention over the row's own
    encoder frames, attention layer, logits, argmax) and, apart, the
    attention keys (memory @ wk, once a call)."""
    sp = cfg["speller"]
    u, e, a, m, al, v, nl = (sp[k] for k in ("units", "embedding_dim", "attention_units", "memory_dim",
                                             "attention_layer_size", "vocab_size", "num_layers"))
    cell = lambda din: 2 * (din + u) * 4 * u + 4 * u + 10 * u
    weights = (v * e + (e + al + u) * 4 * u + 4 * u + (nl - 1) * (2 * u * 4 * u + 4 * u)
               + u * a + a + (u + m) * al + al * v + v)
    flops = nbytes = keys_f = keys_b = 0.0
    for t, s in zip(encoder_frames(samples, cfg), steps):
        step = (cell(e + al) + (nl - 1) * cell(u) + 2 * u * a + 4 * t * a + 3 * t + 2 * t * m
                + 2 * (u + m) * al + 2 * al * v + 2 * v)
        flops += s * step
        nbytes += F32 * (t * (m + a)) + 4 * s
        keys_f += 2 * t * m * a
        keys_b += F32 * t * (m + a)
    nbytes += F32 * weights
    keys_b += F32 * m * a
    return {"steps": {"flops": flops, "bytes": nbytes}, "keys": {"flops": keys_f, "bytes": keys_b}}


def call(samples: Sequence[int], steps: Sequence[int], cfg: dict) -> Dict[str, Dict[str, float]]:
    """Every part of one ``transcribe_batch`` call, by layer, and 'model'
    the whole: the operations an MFU counts."""
    fe = cfg["frontend"]
    lis = listener(samples, cfg)
    dec = decoder(samples, steps, cfg)
    parts = {
        "frontend": frontend(samples, fe), "deltas_cmvn": deltas_cmvn(samples, fe),
        "listener": lis["recurrence"], "projection": lis["projection"],
        "decoder": dec["steps"], "keys": dec["keys"],
    }
    parts["model"] = {k: sum(p[k] for p in parts.values()) for k in ("flops", "bytes")}
    return parts


def add(into: Dict[str, Dict[str, float]], parts: Dict[str, Dict[str, float]]) -> None:
    for name, p in parts.items():
        acc = into.setdefault(name, {"flops": 0.0, "bytes": 0.0})
        acc["flops"] += p["flops"]
        acc["bytes"] += p["bytes"]


def roofline_s(work: Dict[str, float], flops_per_s: float, bytes_per_s: float) -> float:
    """The least time the card could take: the larger of the two bounds."""
    return max(work["flops"] / flops_per_s, work["bytes"] / bytes_per_s)
