"""Benchmark of the port (counterpart of the repository's ``bench.py``):
offline inference throughput (utterances/sec/card) of the flagship
LibriSpeech-class char LAS (``entry.flagship_cfg``, random init, vocab
34) on one NVIDIA card, its RTF, beam-8 rows, the training step, the
accuracy row of the committed checkpoint, against a reference-equivalent
CPU pipeline.

    python -m phones_las_torch.bench                 # the rows on CUDA
    PLU_BENCH_TINY=1 python -m phones_las_torch.bench --device cpu

Each row builds the same work as the reference's row: greedy at B = 64 ×
10 s, 200 steps (parity and production); beam-8 at B = 32 (parity,
production, production with a joint CTC head, production with Luong
attention); the training step (loss, gradients, masked, clipped Adam) at
B = 32 with 200-token targets in both modes; greedy and beam-8 PER of the
committed checkpoint on the committed eval set. Parity is float32 with
TF32 off; production is bf16 recurrent dots with TF32 in the other
GEMMs and the front-end at ``precision='high'``. The greedy rows run the
fused decoder kernel, the port's serving path, where the reference's rows
run the XLA loop; the kernel ends a group of rows once all of them have
emitted <eos>, so each greedy row also reports the steps it decoded.

Fault tolerance as the reference's: the CPU baseline runs first in this
process; the card's rows run in a worker subprocess (``--gpu-worker``)
that prints ``BEGIN <row>`` / ``ROW {json}`` / ``ROWERR {json}`` lines, so
finished rows survive a crash; the parent retries the worker
(``PLU_BENCH_ATTEMPTS``, ``PLU_BENCH_BACKOFF``, ``PLU_BENCH_ROW_TIMEOUT``),
skips captured rows and ALWAYS prints the one JSON line with what it
captured (and an ``errors`` field), exiting 0.

The rows run on CUDA. Without a card every row errors unless the worker
is given ``--device cpu`` (the tiny mode and the tests); no row falls back
to the CPU. ``mfu*`` divide the analytic FLOPs by the H100 SXM's dense
bf16 peak. ``--prewarm`` builds the kernels and runs every row once.

Prints exactly ONE JSON line on stdout; progress goes to stderr.

Self-test of the failure path:
    PLU_BENCH_FORCE_FAIL=beam8_parity PLU_BENCH_TINY=1 \\
        python -m phones_las_torch.bench --device cpu
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import threading
import time
from typing import Dict, Optional

import numpy as np

from phones_las_torch.utils.device import DeviceLike

SECONDS = 10.0
SAMPLE_RATE = 16000
N_SAMPLES = int(SECONDS * SAMPLE_RATE)
DECODE_STEPS = 200
VOCAB = 34

TINY = bool(os.environ.get("PLU_BENCH_TINY"))
if TINY:  # fast smoke (CPU-runnable): tiny shapes, same code paths
    SECONDS = 1.0
    N_SAMPLES = int(SECONDS * SAMPLE_RATE)
    DECODE_STEPS = 10

# `--prewarm`: every row once (iters = 1), its kernels built on the way
PREWARM = bool(os.environ.get("PLU_BENCH_PREWARM"))

# NVIDIA H100 SXM, dense bf16 tensor-core peak (datasheet, without sparsity)
H100_SXM_PEAK_FLOPS = 989e12

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ASSETS = os.path.join(REPO, "phones_las_tpu", "assets", "bench")


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def make_audio(b, seed=0):
    rs = np.random.RandomState(seed)
    return (rs.randn(b, N_SAMPLES) * 2000).astype(np.float32)


def card_info() -> Dict[str, Optional[str]]:
    """The card's name and power limit as ``nvidia-smi`` prints them
    (None where it cannot be asked)."""
    try:
        line = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, check=True, timeout=60,
        ).stdout.strip().splitlines()[0]
        name, power = (s.strip() for s in line.rsplit(",", 1))
        return {"card": name, "power_limit": power}
    except (OSError, subprocess.SubprocessError, IndexError, ValueError):
        return {"card": None, "power_limit": None}


# ---------------------------------------------------------------------------
# Ours: the port on the card
# ---------------------------------------------------------------------------


def row_cfg(precision="parity", ctc_joint=False, attention=None, tiny=None):
    """The row's configuration, as the reference's rows build it: the
    flagship (or tiny) config; ``attention`` overrides the family;
    ``ctc_joint`` adds the CTC head (weight 0.3); production sets the
    front-end to precision 'high' and the model to 'default'."""
    from phones_las_torch.entry import flagship_cfg

    cfg = flagship_cfg(tiny=TINY if tiny is None else tiny)
    if attention:
        cfg = dataclasses.replace(cfg, speller=dataclasses.replace(cfg.speller, attention_type=attention))
    if ctc_joint:
        cfg = dataclasses.replace(cfg, ctc_weight=0.3)
    if precision == "production":
        cfg = dataclasses.replace(
            cfg, matmul_precision="default", frontend=dataclasses.replace(cfg.frontend, precision="high")
        )
    elif precision != "parity":
        raise ValueError(f"precision must be 'parity' or 'production', got {precision!r}")
    return cfg


def make_infer(cfg, params, steps=None, beam_width=None, ctc_joint=False):
    """→ ``infer(audio, lengths)`` → (tokens, lengths): encode + greedy
    decode (the fused kernel on a card), or beam search of ``beam_width``
    with, under ``ctc_joint``, one-pass joint CTC on the CTC head's
    log-softmax, at ``cfg.matmul_precision``'s numerics."""
    import torch

    from phones_las_torch.decode.beam import beam_decode
    from phones_las_torch.decode.greedy import greedy_decode
    from phones_las_torch.models.las import ctc_logp, encode
    from phones_las_torch.ops.lstm import resolve_rnn_precision
    from phones_las_torch.utils.device import matmul_precision_scope

    steps = DECODE_STEPS if steps is None else steps
    prec = resolve_rnn_precision(cfg.matmul_precision)

    def infer(audio, lengths):
        with torch.no_grad(), matmul_precision_scope(cfg.matmul_precision):
            memory, _, enc_mask = encode(params, cfg, audio, lengths, prec=prec)
            if not beam_width:
                tokens, lens, _ = greedy_decode(params.speller, cfg.speller, memory, enc_mask, steps, prec=prec)
                return tokens, lens
            res = beam_decode(
                params.speller, cfg.speller, memory, enc_mask, steps, beam_width=beam_width,
                ctc_logp=ctc_logp(params, memory) if ctc_joint else None, prec=prec,
            )
        return res.tokens, res.lengths

    return infer


def make_train_step(cfg, state, train_cfg=None):
    """→ ``step(batch)`` → the loss (a detached tensor): the reference's
    step, ``compute_loss(train=True)`` with the state's generator, its
    gradients, ``mask_grads``, the clipped Adam of ``train/state.py``
    applied to ``state`` in place, at ``cfg.matmul_precision``'s numerics."""
    import torch

    from phones_las_torch.models.las import compute_loss
    from phones_las_torch.ops.lstm import resolve_rnn_precision
    from phones_las_torch.train.state import Optimizer, TrainConfig, apply_updates, mask_grads
    from phones_las_torch.utils.device import matmul_precision_scope
    from phones_las_torch.utils.param_io import named_leaves

    tx = Optimizer(train_cfg or TrainConfig())
    prec = resolve_rnn_precision(cfg.matmul_precision)
    leaves = list(named_leaves(state.params))

    def step(batch):
        for _, t in leaves:
            t.grad = None
        with torch.enable_grad(), matmul_precision_scope(cfg.matmul_precision):
            loss, _ = compute_loss(state.params, cfg, batch, train=True, generator=state.generator, prec=prec)
            loss.backward()
            grads = mask_grads({k: t.grad for k, t in leaves}, state.params)
            updates, state.opt_state = tx.update([grads[k] for k, _ in leaves], state.opt_state)
            apply_updates([t for _, t in leaves], updates)
        state.step += 1
        return loss.detach()

    return step


def train_batch(batch_size, vocab=VOCAB, steps=None, samples=None):
    """The training row's host batch: ``samples`` (N_SAMPLES) of random
    PCM a row and ``steps`` (DECODE_STEPS) random target tokens, drawn
    from RandomState(0) as the reference's."""
    steps = DECODE_STEPS if steps is None else steps
    samples = N_SAMPLES if samples is None else samples
    rs = np.random.RandomState(0)
    return {
        "audio": (rs.randn(batch_size, samples) * 2000).astype(np.float32),
        "audio_lengths": np.full((batch_size,), samples, np.int32),
        "targets": rs.randint(4, vocab, (batch_size, steps)).astype(np.int32),
        "target_lengths": np.full((batch_size,), steps, np.int32),
    }


def _fetch(x):
    """A host fetch: waits for the device's queued work."""
    return x.cpu().numpy()


def bench_gpu(batch_size=64, iters=20, precision="parity", wave=None, device: DeviceLike = None):
    """Greedy serving throughput → (utt/s, RTFx, decode steps run).
    'parity' is float32 with TF32 off (the CLI default); 'production'
    bf16 recurrent dots and TF32 elsewhere. ``wave`` dispatches each
    logical batch as back-to-back calls of that size (the Transcriber's
    large-batch strategy)."""
    import torch

    from phones_las_torch.models.las import init_las
    from phones_las_torch.utils.device import resolve_device

    dev = resolve_device(device)
    if TINY:
        batch_size, iters = 4, 2
    if PREWARM:
        iters = 1
    cfg = row_cfg(precision)
    params = init_las(cfg, seed=0, device=dev)
    infer = make_infer(cfg, params)

    w = wave or batch_size
    if batch_size % w:
        raise ValueError(f"wave {w} does not divide the batch {batch_size}")
    calls = batch_size // w
    audio = torch.from_numpy(make_audio(w)).to(dev)
    lengths = torch.full((w,), N_SAMPLES, dtype=torch.int32, device=dev)

    # the reference's semantics: queue ``iters`` calls, fetch once at the end
    t0 = time.time()
    _, lens = infer(audio, lengths)
    steps = min(DECODE_STEPS, int(_fetch(lens).max()) + 1)
    log(f"gpu[{precision}]: build+warmup {time.time()-t0:.1f}s, {steps} of {DECODE_STEPS} decode steps run")

    t0 = time.time()
    outs = [infer(audio, lengths) for _ in range(iters * calls)]
    _fetch(outs[-1][0])
    dt = time.time() - t0
    utts = batch_size * iters
    rate = utts / dt
    rtf = (utts * SECONDS) / dt  # seconds of audio per wall second
    log(f"gpu[{precision}]: {rate:.1f} utt/s, RTFx {rtf:.0f}, {dt:.2f}s for {utts} utts")
    return rate, rtf, steps


def bench_gpu_beam(batch_size=32, iters=5, precision="parity", beam_width=8, ctc_joint=False, attention=None,
                   device: DeviceLike = None):
    """Beam-search throughput (utt/s) of the flagship at ``beam_width``;
    ``ctc_joint`` adds the one-pass joint CTC prefix scores of a CTC head,
    ``attention`` overrides the attention family."""
    import torch

    from phones_las_torch.models.las import init_las
    from phones_las_torch.utils.device import resolve_device

    dev = resolve_device(device)
    if TINY:
        batch_size, iters, beam_width = 2, 1, 2
    if PREWARM:
        iters = 1
    cfg = row_cfg(precision, ctc_joint=ctc_joint, attention=attention)
    params = init_las(cfg, seed=0, device=dev)
    infer = make_infer(cfg, params, beam_width=beam_width, ctc_joint=ctc_joint)
    audio = torch.from_numpy(make_audio(batch_size)).to(dev)
    lengths = torch.full((batch_size,), N_SAMPLES, dtype=torch.int32, device=dev)

    tag = f"beam{beam_width}{'+ctc' if ctc_joint else ''}" + (f"[{attention}]" if attention else "")
    t0 = time.time()
    _fetch(infer(audio, lengths)[0])
    log(f"gpu[{precision}][{tag}]: build+warmup {time.time()-t0:.1f}s")

    t0 = time.time()
    outs = [infer(audio, lengths) for _ in range(iters)]
    _fetch(outs[-1][0])
    dt = time.time() - t0
    rate = batch_size * iters / dt
    log(f"gpu[{precision}][{tag}]: {rate:.1f} utt/s")
    return rate


def bench_train(batch_size=32, iters=30, precision="production", device: DeviceLike = None):
    """Milliseconds per optimizer step (loss + gradients + Adam) of the
    flagship at ``batch_size`` 10 s utterances with DECODE_STEPS-token
    targets."""
    import torch

    from phones_las_torch.train.state import TrainConfig, create_train_state
    from phones_las_torch.utils.device import resolve_device

    dev = resolve_device(device)
    if TINY:
        batch_size, iters = 4, 2
    if PREWARM:
        iters = 1
    cfg = row_cfg(precision)
    state = create_train_state(cfg, TrainConfig(), device=dev)
    step = make_train_step(cfg, state)
    batch = {k: torch.from_numpy(v).to(dev) for k, v in train_batch(batch_size).items()}

    t0 = time.time()
    float(step(batch))
    log(f"train[{precision}]: build+warmup {time.time()-t0:.1f}s")

    t0 = time.time()
    for _ in range(iters):
        loss = step(batch)
    float(loss)  # host fetch
    ms = (time.time() - t0) / iters * 1000
    log(f"train[{precision}]: {ms:.2f} ms/step @B={batch_size}")
    return ms


def train_mfu(step_ms: float, batch_size: int = 32) -> float:
    """Fraction of the H100 SXM's dense bf16 peak achieved by the measured
    train step (algorithmic fwd+bwd FLOPs; see train_flops_per_utt)."""
    return batch_size * train_flops_per_utt() / (step_ms / 1000.0) / H100_SXM_PEAK_FLOPS


def eval_set_per(ckpt: str, evalset: str, device: DeviceLike = None, n: Optional[int] = None):
    """Greedy and beam-8 PER of the artifact ``ckpt`` on the padded eval
    set ``evalset`` (its first ``n`` utterances), decoded to its
    ``decode_cap`` on ``device`` → (greedy PER, beam-8 PER)."""
    import torch

    from phones_las_torch.decode.beam import beam_decode
    from phones_las_torch.decode.greedy import greedy_decode
    from phones_las_torch.models.las import encode
    from phones_las_torch.ops.lstm import resolve_rnn_precision
    from phones_las_torch.utils.device import matmul_precision_scope, resolve_device
    from phones_las_torch.utils.metrics import edit_distance_stats
    from phones_las_torch.utils.param_io import load_artifact

    dev = resolve_device(device)
    params, cfg, _ = load_artifact(ckpt, device=dev)
    with np.load(evalset, allow_pickle=False) as data:
        audio = data["audio"][:n].astype(np.float32)  # [B, S] int16-scaled PCM
        lengths = data["lengths"][:n].astype(np.int32)
        refs = data["refs"][:n]  # [B, L] padded with -1
        cap = int(data["decode_cap"][0]) if "decode_cap" in data else DECODE_STEPS
    prec = resolve_rnn_precision(cfg.matmul_precision)
    with torch.no_grad(), matmul_precision_scope(cfg.matmul_precision):
        memory, _, enc_mask = encode(params, cfg, torch.from_numpy(audio).to(dev),
                                     torch.from_numpy(lengths).to(dev), prec=prec)
        g_tok, g_len, _ = greedy_decode(params.speller, cfg.speller, memory, enc_mask, cap, prec=prec)
        res = beam_decode(params.speller, cfg.speller, memory, enc_mask, cap, beam_width=8, prec=prec)
    ref_lens = (refs >= 0).sum(axis=1).astype(np.int32)
    ref_ids = np.where(refs >= 0, refs, 0).astype(np.int32)

    def per(tok, tlen):
        errs, total = edit_distance_stats(_fetch(tok), _fetch(tlen), ref_ids, ref_lens)
        return errs / max(total, 1)

    return per(g_tok, g_len), per(res.tokens, res.lengths)


def bench_accuracy(device: DeviceLike = None):
    """The correctness-bearing row: the committed checkpoint decoded on
    the committed eval set (or ``PLU_BENCH_ASSETS_DIR``'s), greedy and
    beam-8 PER. → a dict of fields, or None when the assets are absent."""
    from phones_las_torch.utils.device import resolve_device

    device = resolve_device(device)  # no card: the row errors, skipped or not
    adir = os.environ.get("PLU_BENCH_ASSETS_DIR")
    if TINY and not adir:
        log("accuracy row: skipped in PLU_BENCH_TINY mode (full-size "
            "checkpoint decode is not a smoke-scale computation)")
        return None
    adir = adir or ASSETS
    ckpt = os.path.join(adir, "ckpt.npz")
    evalset = os.path.join(adir, "eval_set.npz")
    if not (os.path.exists(ckpt) and os.path.exists(evalset)):
        log(f"accuracy row: {adir}/{{ckpt,eval_set}}.npz absent; skipped")
        return None
    g, b = eval_set_per(ckpt, evalset, device)
    log(f"accuracy row: greedy PER {g:.4f}, beam-8 PER {b:.4f}")
    return {"bench_per_greedy": round(g, 4), "bench_per_beam8": round(b, 4)}


# ---------------------------------------------------------------------------
# Analytic FLOPs model → MFU
# ---------------------------------------------------------------------------


def flagship_flops_per_utt(beam_width: int = 1) -> dict:
    """Algorithmic (fp32-equivalent) FLOPs to transcribe one 10 s
    utterance with the flagship config — matmul/elementwise terms only,
    2 FLOPs per MAC (the reference's model, term for term). Dims come from
    the live flagship config."""
    from phones_las_torch.entry import flagship_cfg

    cfg = flagship_cfg()
    sp, li, fe_cfg = cfg.speller, cfg.listener, cfg.frontend
    u, emb, attn = sp.units, sp.embedding_dim, sp.attention_units
    mem, vocab = sp.memory_dim, sp.vocab_size
    nmel, win, nfft = (fe_cfg.num_mel,
                       int(fe_cfg.win_ms * fe_cfg.sample_rate / 1000),
                       fe_cfg.nfft)
    t0 = int(10.0 * 1000 / fe_cfg.hop_ms)  # 10 s at the config's hop

    # front-end: framed DFT as two real matmuls + mel projection + deltas
    fe = t0 * (2 * win * (nfft // 2 + 1) * 2 + 2 * (nfft // 2 + 1) * nmel)

    # pyramidal BiLSTM: per step per direction 2*4u*(d+u) FLOPs
    eu = li.units
    enc = 0
    t, d = t0, li.input_dim
    for layer in range(li.num_layers):
        if layer > 0:
            t, d = t // 2, 4 * eu  # reshape-concat pyramid
        enc += t * 2 * (2 * 4 * eu * (d + eu) + 20 * eu)  # gates + pointwise

    # decoder: LSTM cells + additive attention per step, x beam width
    t_enc = t0 // (2 ** (li.num_layers - 1))
    step = (
        2 * 4 * u * ((emb + attn) + u)  # cell 1
        + (sp.num_layers - 1) * 2 * 4 * u * (u + u)  # further cells
        + 2 * u * attn                  # query projection
        + t_enc * (2 * attn + 2)        # tanh(keys+q) @ v
        + 2 * t_enc * mem               # context reduction
        + 2 * (u + mem) * attn          # attention layer
        + 2 * attn * vocab              # output projection
    )
    dec = DECODE_STEPS * beam_width * step
    return {"frontend": fe, "encoder": enc, "decoder": dec,
            "total": fe + enc + dec}


def train_flops_per_utt(target_steps: int = DECODE_STEPS) -> float:
    """Algorithmic FLOPs for one utterance of a flagship TRAIN step:
    forward + backward ≈ 3× the forward matmul work, over front-end +
    encoder + teacher-forced decoder (the front-end has no parameters, so
    the backward skips it)."""
    f = flagship_flops_per_utt(beam_width=1)
    fwd = f["frontend"] + f["encoder"] + f["decoder"] * (
        target_steps / DECODE_STEPS)
    return f["frontend"] + 3.0 * (fwd - f["frontend"])


def mfu(rate_utt_per_s: float, beam_width: int = 1) -> float:
    return rate_utt_per_s * flagship_flops_per_utt(beam_width)["total"] / H100_SXM_PEAK_FLOPS


# ---------------------------------------------------------------------------
# Baseline: reference-equivalent CPU pipeline (numpy frontend + torch LAS)
# ---------------------------------------------------------------------------


def _np_frontend(sig):
    """Vectorized psf-semantics log-mel + deltas (as the reference's
    offline python_speech_features pass)."""
    win, hop, nfft, nmel = 400, 160, 512, 40
    sig = np.append(sig[0], sig[1:] - 0.97 * sig[:-1])
    n = 1 + int(np.ceil((len(sig) - win) / hop)) if len(sig) > win else 1
    pad = (n - 1) * hop + win - len(sig)
    sig = np.pad(sig, (0, max(pad, 0)))
    idx = np.arange(n)[:, None] * hop + np.arange(win)[None, :]
    frames = sig[idx]
    ps = (np.abs(np.fft.rfft(frames, nfft)) ** 2) / nfft
    # HTK mel filterbank with integer bin edges
    hz2mel = lambda h: 2595 * np.log10(1 + h / 700.0)
    mel2hz = lambda m: 700 * (10 ** (m / 2595.0) - 1)
    pts = np.linspace(hz2mel(0), hz2mel(SAMPLE_RATE / 2), nmel + 2)
    bins = np.floor((nfft + 1) * mel2hz(pts) / SAMPLE_RATE).astype(int)
    fb = np.zeros((nmel, nfft // 2 + 1))
    for j in range(nmel):
        for i in range(bins[j], bins[j + 1]):
            fb[j, i] = (i - bins[j]) / max(bins[j + 1] - bins[j], 1)
        for i in range(bins[j + 1], bins[j + 2]):
            fb[j, i] = (bins[j + 2] - i) / max(bins[j + 2] - bins[j + 1], 1)
    feat = np.log(np.maximum(ps @ fb.T, np.finfo(float).eps))

    def delta(f):
        p = np.pad(f, ((2, 2), (0, 0)), mode="edge")
        return (p[3:-1] - p[1:-3] + 2 * (p[4:] - p[:-4])) / 10.0

    d1 = delta(feat)
    return np.concatenate([feat, d1, delta(d1)], axis=1).astype(np.float32)


def bench_cpu_baseline(batch_size=8):
    """The reference-equivalent pipeline on the host's cores (torch.nn
    LSTMs of the flagship's widths, per-step greedy attention decoder) →
    utt/s."""
    import torch

    torch.set_num_threads(os.cpu_count() or 1)
    units, dec_units, emb, attn = 256, 256, 128, 256
    if TINY:
        batch_size = 2

    enc_layers = [
        torch.nn.LSTM(120, units, bidirectional=True, batch_first=True),
        torch.nn.LSTM(4 * units, units, bidirectional=True, batch_first=True),
        torch.nn.LSTM(4 * units, units, bidirectional=True, batch_first=True),
    ]
    embedding = torch.nn.Embedding(VOCAB, emb)
    dec_cells = [
        torch.nn.LSTMCell(emb + attn, dec_units),
        torch.nn.LSTMCell(dec_units, dec_units),
    ]
    wq = torch.nn.Linear(dec_units, attn, bias=False)
    wk = torch.nn.Linear(2 * units, attn, bias=False)
    v = torch.nn.Parameter(torch.randn(attn))
    attn_layer = torch.nn.Linear(dec_units + 2 * units, attn, bias=False)
    out_proj = torch.nn.Linear(attn, VOCAB)

    audio = make_audio(batch_size)
    t0 = time.time()
    with torch.no_grad():
        feats = np.stack([_np_frontend(a) for a in audio])
        x = torch.from_numpy(feats)
        for li, lstm in enumerate(enc_layers):
            if li > 0:  # pyramid reshape-concat
                b, t, u = x.shape
                t2 = t // 2 * 2
                x = x[:, :t2].reshape(b, t2 // 2, 2 * u)
            x, _ = lstm(x)
        memory = x  # [B, T', 512]
        keys = wk(memory)
        b = memory.shape[0]
        states = [
            (torch.zeros(b, dec_units), torch.zeros(b, dec_units))
            for _ in dec_cells
        ]
        att = torch.zeros(b, attn)
        tok = torch.ones(b, dtype=torch.long)
        for _ in range(DECODE_STEPS):
            inp = torch.cat([embedding(tok), att], dim=-1)
            for i, cell in enumerate(dec_cells):
                states[i] = cell(inp, states[i])
                inp = states[i][0]
            q = wq(inp)
            scores = torch.tanh(keys + q[:, None, :]) @ v
            al = torch.softmax(scores, dim=-1)
            ctx = (al[:, :, None] * memory).sum(1)
            att = attn_layer(torch.cat([inp, ctx], dim=-1))
            tok = out_proj(att).argmax(-1)
    dt = time.time() - t0
    rate = batch_size / dt
    log(f"cpu baseline: {rate:.2f} utt/s ({dt:.1f}s for {batch_size} utts, "
        f"{os.cpu_count()} host cores)")
    return rate


# ---------------------------------------------------------------------------
# Fault-tolerant orchestration (parent + --gpu-worker subprocess)
# ---------------------------------------------------------------------------


def _greedy_fields(mode, device):
    rate, rtf, steps = bench_gpu(precision=mode, device=device)
    return {f"value_{mode}": round(rate, 2), f"rtf_x_{mode}": round(rtf), f"greedy_steps_run_{mode}": steps}


# row name → zero-arg callable returning {field: value}
def _row_fns(device: DeviceLike = None):
    return {
        "parity": lambda: _greedy_fields("parity", device),
        "production": lambda: _greedy_fields("production", device),
        "beam8_parity": lambda: {
            "value_beam8_parity": round(bench_gpu_beam(precision="parity", device=device), 2)},
        "beam8_production": lambda: {
            "value_beam8_production": round(bench_gpu_beam(precision="production", device=device), 2)},
        "beam8_ctcjoint_production": lambda: {
            "value_beam8_ctcjoint_production": round(
                bench_gpu_beam(precision="production", ctc_joint=True, device=device), 2)},
        "beam8_luong_production": lambda: {
            "value_beam8_luong_production": round(
                bench_gpu_beam(precision="production", attention="luong", device=device), 2)},
        "train_parity": lambda: {
            "value_train_step_ms_parity": round(bench_train(precision="parity", device=device), 2)},
        "train_production": lambda: {
            "value_train_step_ms_production": round(bench_train(precision="production", device=device), 2)},
        "accuracy": lambda: bench_accuracy(device) or {},
    }


# production rows first, as the reference orders them
ROW_ORDER = ["production", "beam8_production", "beam8_ctcjoint_production",
             "beam8_luong_production", "train_production", "accuracy",
             "parity", "beam8_parity", "train_parity"]


def _kernels():
    """The kernel wrappers, whose ``launches`` counts a row reports."""
    from phones_las_torch.decode.fused_greedy import greedy_decode_fused
    from phones_las_torch.frontend.fused_frontend import fused_logmel
    from phones_las_torch.ops.lstm import bidir_recurrence, recurrence, recurrence_bwd, recurrence_residual

    return (fused_logmel, bidir_recurrence, greedy_decode_fused, recurrence, recurrence_residual, recurrence_bwd)


def gpu_worker(skip, device: DeviceLike = None):
    """Run the rows in order; print ``BEGIN <row>`` / ``ROW <json>`` (with
    the row's kernel launches, those not 0) / ``ROWERR <json>`` lines on stdout. A CUDA
    error aborts the process (it poisons the context: a retry must be a
    fresh process); any other per-row error is reported and the
    remaining rows still run."""
    force_fail = os.environ.get("PLU_BENCH_FORCE_FAIL", "")
    fns = _row_fns(device)
    kernels = _kernels()
    for name in ROW_ORDER:
        if name in skip:
            continue
        print(f"BEGIN {name}", flush=True)
        for fn in kernels:
            fn.launches = 0
        try:
            if name == force_fail:
                raise RuntimeError("forced failure (PLU_BENCH_FORCE_FAIL)")
            fields = fns[name]()
        except Exception as e:  # noqa: BLE001
            msg = f"{type(e).__name__}: {e}"[:400]
            print("ROWERR " + json.dumps({"row": name, "error": msg}), flush=True)
            log(f"row {name} failed: {msg}")
            if "CUDA error" in msg or "backend" in msg.lower():
                sys.exit(3)  # a poisoned context: only a fresh process can retry
            continue
        launches = {fn.__name__: fn.launches for fn in kernels if fn.launches}
        print("ROW " + json.dumps({"row": name, "fields": fields, "launches": launches}), flush=True)
    sys.exit(0)


def run_worker_with_retries(results, errors, launches, device: DeviceLike = None):
    """Spawn --gpu-worker subprocesses until every row is captured or the
    attempt/failure budget is spent. Mutates ``results`` (row → fields),
    ``errors`` (list of strings) and ``launches`` (row → kernel counts)."""
    attempts = int(os.environ.get("PLU_BENCH_ATTEMPTS", "5"))
    backoff = float(os.environ.get("PLU_BENCH_BACKOFF", "60"))
    timeout = float(os.environ.get("PLU_BENCH_ROW_TIMEOUT", "2400"))
    failcount = {}
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))

    for attempt in range(attempts):
        skip = [r for r in ROW_ORDER
                if r in results or failcount.get(r, 0) >= 2]
        todo = [r for r in ROW_ORDER if r not in skip]
        if not todo:
            return
        if attempt:
            log(f"bench: retry {attempt + 1}/{attempts} for rows {todo} "
                f"after {backoff:.0f}s backoff")
            time.sleep(backoff)
        cmd = [sys.executable, "-m", "phones_las_torch.bench", "--gpu-worker", "--skip", ",".join(skip)]
        if device is not None:
            cmd += ["--device", str(device)]
        current = None
        timed_out = []
        proc = None
        try:
            proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=sys.stderr, text=True, cwd=REPO, env=env)

            # the readline loop blocks while the worker runs silently; a
            # watchdog is the only hang-proof timeout
            def _watchdog():
                timed_out.append(True)
                proc.kill()

            timer = threading.Timer(timeout, _watchdog)
            timer.start()
            try:
                for line in proc.stdout:
                    line = line.strip()
                    if line.startswith("BEGIN "):
                        current = line[6:]
                    elif line.startswith("ROW "):
                        rec = json.loads(line[4:])
                        results[rec["row"]] = rec["fields"]
                        launches[rec["row"]] = rec["launches"]
                        current = None
                    elif line.startswith("ROWERR "):
                        rec = json.loads(line[7:])
                        failcount[rec["row"]] = failcount.get(rec["row"], 0) + 1
                        errors.append(f"{rec['row']}: {rec['error']}")
                        current = None
            finally:
                timer.cancel()
            rc = proc.wait(timeout=60)
            if timed_out:
                errors.append(f"worker timeout after {timeout:.0f}s (row {current})")
                if current:
                    failcount[current] = failcount.get(current, 0) + 1
            elif rc not in (0, 3) and current:
                failcount[current] = failcount.get(current, 0) + 1
                errors.append(f"worker died rc={rc} in row {current}")
        except Exception as e:  # noqa: BLE001
            errors.append(f"worker spawn/IO failure: {e}")
            if proc is not None and proc.poll() is None:
                proc.kill()


def main(device: DeviceLike = None):
    results, errors, launches = {}, [], {}
    # CPU baseline FIRST: it cannot be lost to a card's failure. Take the
    # faster of two runs (conservative ratio).
    try:
        cpu_rate = max(bench_cpu_baseline(), bench_cpu_baseline())
    except Exception as e:  # noqa: BLE001
        errors.append(f"cpu baseline: {type(e).__name__}: {e}")
        cpu_rate = None

    run_worker_with_retries(results, errors, launches, device)

    flat = {}
    for name in ROW_ORDER:
        flat.update(results.get(name, {}))
    parity = flat.get("value_parity")
    prod = flat.get("value_production")
    beam8_prod = flat.get("value_beam8_production")

    # headline = parity mode; if the parity rows were lost, production,
    # with the unit saying which
    head, head_mode = (parity, "fp32-parity") if parity else (prod, "bf16-production")
    out = {
        "metric": "offline_inference_throughput",
        "value": head,
        "unit": f"utterances/sec/card ({SECONDS:.0f}s utts, LibriSpeech-class char LAS, {head_mode} mode, "
                "greedy through the fused decoder kernel)",
        "vs_baseline": (round(head / cpu_rate, 2) if head and cpu_rate else None),
    }
    out.update(flat)
    if cpu_rate:
        out["cpu_baseline_utt_per_s"] = round(cpu_rate, 2)
        if prod:
            out["vs_baseline_production"] = round(prod / cpu_rate, 2)
    # achieved fraction of the H100 SXM's dense bf16 peak for the
    # algorithmic FLOPs (parity mode runs float32 work for the same count)
    if prod:
        out["mfu_production"] = round(mfu(prod), 4)
    if parity:
        out["mfu_parity"] = round(mfu(parity), 4)
    if beam8_prod:
        out["mfu_beam8_production"] = round(mfu(beam8_prod, beam_width=8), 4)
    for suffix in ("production", "parity"):
        t_ms = flat.get(f"value_train_step_ms_{suffix}")
        if t_ms and not TINY:  # tiny smoke shapes don't match the model
            out[f"mfu_train_{suffix}"] = round(train_mfu(t_ms), 4)
    out.update(card_info())
    out["launches"] = launches
    if errors:
        out["errors"] = errors  # each row fails at most twice before it is skipped
    print(json.dumps(out), flush=True)


def _parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--device", default=None, help="unset: CUDA (every row errors without a card); 'cpu': the "
                                                  "plain PyTorch path, for the tiny mode and the tests")
    p.add_argument("--gpu-worker", action="store_true", help="run the rows in this process (the protocol lines)")
    p.add_argument("--skip", default="", help="with --gpu-worker: rows to skip, comma-separated")
    p.add_argument("--prewarm", action="store_true", help="build the kernels and run every row once, in-process")
    return p


if __name__ == "__main__":
    args = _parser().parse_args()
    if args.gpu_worker:
        gpu_worker(set(filter(None, args.skip.split(","))), args.device)
    elif args.prewarm:
        # no compile cache to fill: this builds the kernels (csrc/_build.py
        # reuses a warm build directory) and runs every row once
        PREWARM = True
        os.environ["PLU_BENCH_PREWARM"] = "1"
        t0 = time.time()
        try:
            gpu_worker(set(), args.device)  # exits 0 when done
        finally:
            log(f"prewarm: every row run once in {time.time()-t0:.0f}s")
    else:
        main(args.device)
