"""The plain reference: the LAS forward pass in float32 PyTorch.

A frozen copy of the model's mathematics, written out here so that it
depends on nothing of the program under test: the front-end
(python_speech_features semantics: pre-emphasis 0.97, 25 ms frames every
10 ms, |DFT|² / NFFT, the HTK mel filterbank on integer FFT-bin edges,
log floored at float64's eps, edge-padded Δ and ΔΔ, each utterance's tail
clamped to its last frame), global CMVN, the pyramidal BiLSTM listener
(TF1 ``BasicLSTMCell``: gates i, f, g, o, forget bias 1 added at run
time, the state frozen and the output zero past each row's length;
adjacent frame pairs concatenated before every layer but the first) and
the Bahdanau speller (TF1 ``AttentionWrapper``: the cell input is the
token's embedding and the previous attention vector, the query is the
top cell's output, the attention vector a projection of the output and
the context), teacher-forced on given tokens.

Every product goes through ``Numerics.mm``: exact float32 with TF32 off
(the reference), or with its operands rounded to a lower precision first
(the controls: TF32, bfloat16 or fp8 e4m3 with a per-tensor scale), which
is the same product on every device.

Weights are a dict keyed by the artifact's leaf paths (``weights.py``).
"""

from __future__ import annotations

import contextlib
import functools
import math
from typing import Dict, Optional, Sequence

import numpy as np
import torch

LOG_FLOOR = float(np.finfo(np.float64).eps)
NEG = -1e9
ROLES = ("frontend", "proj", "rec", "dec")


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 → the nearest TF32 value (10 mantissa bits, ties away)."""
    i = x.contiguous().view(torch.int32)
    return ((i + 0x1000) & ~0x1FFF).view(torch.float32)


def round_bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).to(torch.float32)


def round_fp8(x: torch.Tensor) -> torch.Tensor:
    """fp8 e4m3 with one scale for the tensor (its largest magnitude
    mapped to 448), as fp8 products are run."""
    amax = x.abs().max().clamp_min(1e-30)
    s = 448.0 / amax
    return (x * s).to(torch.float8_e4m3fn).to(torch.float32) / s


ROUNDERS = {"tf32": round_tf32, "bf16": round_bf16, "fp8": round_fp8}


class Numerics:
    """Which precision each kind of product runs at: ``frontend`` (the
    DFT and mel products), ``proj`` (the listener's input projections),
    ``rec`` (the recurrent dots, listener and speller) and ``dec`` (the
    speller's other products). None is exact float32."""

    def __init__(self, **roles: Optional[str]):
        unknown = set(roles) - set(ROLES)
        if unknown:
            raise ValueError(f"unknown product kinds {sorted(unknown)}")
        self.roles = {r: roles.get(r) for r in ROLES}

    def mm(self, a: torch.Tensor, b: torch.Tensor, role: str) -> torch.Tensor:
        kind = self.roles[role]
        if kind is not None:
            f = ROUNDERS[kind]
            a, b = f(a), f(b)
        return torch.matmul(a, b)


EXACT = Numerics()


@contextlib.contextmanager
def no_tf32():
    """float32 products in float32: TF32 off for the scope."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


# ---------------------------------------------------------------- front-end


def frame_count(n, win: int, hop: int):
    """psf's frame count: 1 + ceil((n - win) / hop) past one window, else 1
    (ints or integer tensors)."""
    if isinstance(n, (int, np.integer)):
        return 1 if n <= win else 1 + int(math.ceil((n - win) / hop))
    extra = torch.clamp(n - win, min=0)
    return 1 + torch.div(extra + hop - 1, hop, rounding_mode="floor")


@functools.lru_cache(maxsize=None)
def mel_filterbank(nfft: int, num_mel: int, rate: int, low_hz: float, high_hz: float) -> np.ndarray:
    """[nfft/2 + 1, num_mel] triangles on integer FFT-bin edges."""
    hz2mel = lambda hz: 2595.0 * np.log10(1.0 + np.asarray(hz, np.float64) / 700.0)
    mel2hz = lambda m: 700.0 * (10.0 ** (np.asarray(m, np.float64) / 2595.0) - 1.0)
    pts = np.linspace(hz2mel(low_hz), hz2mel(high_hz), num_mel + 2)
    bins = np.floor((nfft + 1) * mel2hz(pts) / rate).astype(np.int64)
    fb = np.zeros((num_mel, nfft // 2 + 1))
    for j in range(num_mel):
        for i in range(bins[j], bins[j + 1]):
            fb[j, i] = (i - bins[j]) / max(bins[j + 1] - bins[j], 1)
        for i in range(bins[j + 1], bins[j + 2]):
            fb[j, i] = (bins[j + 2] - i) / max(bins[j + 2] - bins[j + 1], 1)
    return fb.T.copy()


@functools.lru_cache(maxsize=None)
def dft_basis(win: int, nfft: int) -> np.ndarray:
    """[win, 2 (nfft/2 + 1)]: cos | -sin (a rectangular window)."""
    ang = 2.0 * np.pi * np.outer(np.arange(win, dtype=np.float64), np.arange(nfft // 2 + 1)) / nfft
    return np.concatenate([np.cos(ang), -np.sin(ang)], axis=1)


def _deltas(f: torch.Tensor, n: int) -> torch.Tensor:
    t = f.shape[-2]
    idx = torch.clamp(torch.arange(-n, t + n, device=f.device), 0, t - 1)
    p = f[..., idx, :]
    out = torch.zeros_like(f)
    for d in range(1, n + 1):
        out = out + d * (p[..., n + d: n + d + t, :] - p[..., n - d: n - d + t, :])
    return out / (2.0 * sum(d * d for d in range(1, n + 1)))


def _clamp_tail(f: torch.Tensor, flens: torch.Tensor) -> torch.Tensor:
    """Frames past each row's length replaced by its last frame."""
    pos = torch.arange(f.shape[-2], device=f.device)
    idx = torch.minimum(pos[None, :], torch.clamp(flens - 1, min=0)[:, None])
    return torch.gather(f, 1, idx[..., None].expand(-1, -1, f.shape[-1]))


def features(pcm: torch.Tensor, lengths: torch.Tensor, fe: dict, num: Numerics = EXACT):
    """PCM [B, S] (any number type) and sample lengths [B] → (log-mel
    + Δ + ΔΔ [B, T, 3·num_mel], frame lengths [B])."""
    rate, nfft, nmel = fe["sample_rate"], fe["nfft"], fe["num_mel"]
    win = int(math.floor(fe["win_ms"] * rate / 1000.0 + 0.5))
    hop = int(math.floor(fe["hop_ms"] * rate / 1000.0 + 0.5))
    dev = pcm.device
    x = pcm.to(torch.float32)
    x = torch.cat([x[:, :1], x[:, 1:] - fe["preemphasis"] * x[:, :-1]], dim=1)
    pos = torch.arange(x.shape[1], device=dev)
    x = torch.where(pos[None, :] < lengths[:, None], x, torch.zeros((), device=dev))
    t = frame_count(int(x.shape[1]), win, hop)
    need = (t - 1) * hop + win
    if need > x.shape[1]:
        x = torch.nn.functional.pad(x, (0, need - x.shape[1]))
    frames = x[:, :need].unfold(1, win, hop)  # [B, T, win]
    basis = torch.as_tensor(dft_basis(win, nfft), dtype=torch.float32, device=dev)
    proj = num.mm(frames, basis, "frontend")
    re, im = proj[..., : nfft // 2 + 1], proj[..., nfft // 2 + 1:]
    power = (re * re + im * im) / nfft
    high = fe.get("high_hz") or rate / 2.0
    mel = torch.as_tensor(mel_filterbank(nfft, nmel, rate, float(fe.get("low_hz", 0.0)), float(high)),
                          dtype=torch.float32, device=dev)
    logmel = torch.log(torch.clamp_min(num.mm(power, mel, "frontend"), LOG_FLOOR))
    flens = frame_count(lengths, win, hop)
    base = _clamp_tail(logmel, flens)
    n = fe["delta_width"]
    d1 = _clamp_tail(_deltas(base, n), flens)
    d2 = _deltas(d1, n)
    return torch.cat([base, d1, d2], dim=-1), flens


# ----------------------------------------------------------------- listener


def _cell(gates: torch.Tensor, c: torch.Tensor, forget_bias: float):
    i, f, g, o = torch.chunk(gates, 4, dim=-1)
    c = torch.sigmoid(f + forget_bias) * c + torch.sigmoid(i) * torch.tanh(g)
    return torch.sigmoid(o) * torch.tanh(c), c


def bilstm(x: torch.Tensor, lens: torch.Tensor, w: Dict[str, torch.Tensor], prefix: str,
           forget_bias: float, num: Numerics) -> torch.Tensor:
    """[B, T, D] → [B, T, 2U]: the forward direction over t = 0 … T-1 and
    the backward one over T-1 … 0, each state frozen past the row's length."""
    b, t, _ = x.shape
    outs = []
    for d, reverse in ((0, False), (1, True)):
        wx, wh, bias = (w[f"{prefix}[{d}].{k}"] for k in ("wx", "wh", "b"))
        u = wh.shape[0]
        xp = num.mm(x, wx, "proj") + bias  # [B, T, 4U]
        h = torch.zeros((b, u), device=x.device)
        c = torch.zeros_like(h)
        out = torch.zeros((b, t, u), device=x.device)
        for s in (range(t - 1, -1, -1) if reverse else range(t)):
            hn, cn = _cell(xp[:, s] + num.mm(h, wh, "rec"), c, forget_bias)
            m = (s < lens).to(torch.float32)[:, None]
            h = m * hn + (1.0 - m) * h
            c = m * cn + (1.0 - m) * c
            out[:, s] = m * hn
        outs.append(out)
    return torch.cat(outs, dim=-1)


def listen(feats: torch.Tensor, flens: torch.Tensor, w: Dict[str, torch.Tensor], layers: int,
           forget_bias: float, num: Numerics):
    """→ (memory [B, T', 2U], encoder lengths [B])."""
    x, lens = feats, flens
    for l in range(layers):
        if l > 0:
            if x.shape[1] % 2:
                x = torch.nn.functional.pad(x, (0, 0, 0, 1))
            x = x.reshape(x.shape[0], x.shape[1] // 2, 2 * x.shape[2])
            lens = torch.div(lens + 1, 2, rounding_mode="floor")
        x = bilstm(x, lens, w, f".listener.layers[{l}]", forget_bias, num)
    return x, lens


# ------------------------------------------------------------------ speller


def speller_logits(memory: torch.Tensor, enc_lens: torch.Tensor, inputs: torch.Tensor,
                   w: Dict[str, torch.Tensor], sp: dict, forget_bias: float, num: Numerics) -> torch.Tensor:
    """Teacher-forced: ``inputs`` [B, S] (column 0 the start token) →
    logits [B, S, V], the step s logits computed after reading inputs[:, s]."""
    b, s_len = inputs.shape
    dev = memory.device
    p = ".speller"
    mask = (torch.arange(memory.shape[1], device=dev)[None, :] < enc_lens[:, None])
    keys = num.mm(memory, w[f"{p}.attention.wk"], "dec")
    wq, v = w[f"{p}.attention.wq"], w[f"{p}.attention.v"]
    layers = sp["num_layers"]
    u = sp["units"]
    states = [(torch.zeros((b, u), device=dev), torch.zeros((b, u), device=dev)) for _ in range(layers)]
    attn_vec = torch.zeros((b, w[f"{p}.attention_layer"].shape[1]), device=dev)
    emb = w[f"{p}.embedding"]
    logits = []
    for s in range(s_len):
        x = torch.cat([emb[inputs[:, s].long()], attn_vec], dim=-1)
        for l in range(layers):
            cw = f"{p}.cells[{l}]"
            gates = num.mm(x, w[f"{cw}.wx"], "dec") + w[f"{cw}.b"] + num.mm(states[l][0], w[f"{cw}.wh"], "rec")
            states[l] = _cell(gates, states[l][1], forget_bias)
            x = states[l][0]
        q = num.mm(x, wq, "dec")
        scores = num.mm(torch.tanh(keys + q[:, None, :]), v[:, None], "dec")[..., 0]
        scores = torch.where(mask, scores, torch.full_like(scores, NEG))
        probs = torch.softmax(scores, dim=-1)
        ctx = num.mm(probs[:, None, :], memory, "dec")[:, 0]
        attn_vec = num.mm(torch.cat([x, ctx], dim=-1), w[f"{p}.attention_layer"], "dec")
        logits.append(num.mm(attn_vec, w[f"{p}.out_w"], "dec") + w[f"{p}.out_b"])
    return torch.stack(logits, dim=1)


def forward(pcm: torch.Tensor, lengths: torch.Tensor, tokens: torch.Tensor, w: Dict[str, torch.Tensor],
            cfg: dict, num: Numerics = EXACT) -> torch.Tensor:
    """PCM [B, S], sample lengths [B] and the tokens served [B, N] →
    the logits [B, N, V] at each served position, the speller fed the
    start token and then the tokens served."""
    forget_bias = float(cfg.get("forget_bias", 1.0))
    with torch.no_grad(), no_tf32():
        feats, flens = features(pcm, lengths, cfg["frontend"], num)
        if cfg.get("cmvn", True):
            feats = (feats - w[".cmvn_mean"]) / w[".cmvn_std"]
        memory, enc_lens = listen(feats, flens, w, cfg["listener"]["num_layers"], forget_bias, num)
        sp = cfg["speller"]
        inputs = torch.cat([torch.full_like(tokens[:, :1], sp["bos_id"]), tokens[:, :-1]], dim=1)
        return speller_logits(memory, enc_lens, inputs, w, sp, forget_bias, num)


def feature_stats(pcm: torch.Tensor, lengths: torch.Tensor, fe: dict):
    """Per-dimension mean and std of the features over every valid frame
    (float64 sums): the CMVN a corpus would give."""
    with torch.no_grad(), no_tf32():
        f, flens = features(pcm, lengths, fe)
    m = (torch.arange(f.shape[1], device=f.device)[None, :] < flens[:, None]).to(torch.float64)[..., None]
    f = f.to(torch.float64)
    n = m.sum()
    mean = (f * m).sum((0, 1)) / n
    var = (f * f * m).sum((0, 1)) / n - mean * mean
    return mean.to(torch.float32), torch.sqrt(torch.clamp_min(var, 1e-6)).to(torch.float32)


def served_gaps(logits: torch.Tensor, tokens: torch.Tensor, lengths: Sequence[int], eos_id: int) -> torch.Tensor:
    """Per row, the widest gap by which a served token's logit lies below
    the best logit at its position. A row shorter than the cap ended on
    <eos> at its length, which is judged too."""
    b, n, _ = logits.shape
    best = logits.max(dim=-1).values
    tok = tokens.long().clone()
    valid = torch.zeros((b, n), dtype=torch.bool, device=logits.device)
    for r, ln in enumerate(lengths):
        valid[r, : min(ln + 1, n)] = True
        if ln < n:
            tok[r, ln] = eos_id
    got = torch.gather(logits, -1, tok[..., None])[..., 0]
    return torch.where(valid, best - got, torch.zeros_like(best)).max(dim=1).values

