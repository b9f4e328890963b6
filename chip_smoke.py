#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``phones_las_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``phones_las_torch/csrc`` (first use),
then:

  0. prints the card's name and power limit, the numerics switches of
     parity mode and the build's seconds;
  1. holds each kernel against its plain PyTorch version on the card at
     the main path's shapes, with the tolerance stated in each line, and
     times kernel, plain version and, where one exists, a single PyTorch
     library call computing the same function (CUDA events, median of
     10 runs, warm L2);
  2. decodes the committed checkpoint on all 64 utterances of the
     committed eval set on the card (load_artifact → encode →
     greedy_decode, launch counters set to 0 just before and read just
     after) and holds the tokens and greedy PER against the port's plain
     path on the CPU and against the reference's PER;
  3. runs the same path at the flagship shape (64 × 10 s of random PCM,
     200 greedy steps) and prints utt/s and the split among front-end,
     listener and decoder.

Every phase that fails ends the script with a non-zero exit code. The
line before the last holds the card's name and power limit as
``nvidia-smi`` prints them; the line before that the kernels' record;
the last line is ``{"ok": true, "device": {...}}``. Without a CUDA
device the script exits non-zero and prints no result.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.abspath(__file__))
ASSETS = os.path.join(REPO, "phones_las_tpu", "assets", "bench")
REF_GREEDY_PER = 0.0319  # the reference's greedy PER on the eval set
PER_TOL = 0.005
MAX_DIFF_ROWS = 2  # token rows allowed to differ from the CPU plain path

SECONDS = 10.0
SAMPLE_RATE = 16000
FLAGSHIP_B = 64
DECODE_STEPS = 200

# published peaks of one H100 SXM (dense), for the least-time bound
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12  # float32 outside the tensor cores
BF16_FLOPS = 989e12

DEV = "cuda"
# BiLSTM checks: (T, listener layer whose wh is used, recurrent-dot precision)
LSTM_CASES = ((999, 0, "highest"), (999, 0, "bf16"), (250, 2, "highest"), (250, 2, "bf16"))
DECODER_BATCHES = (8, 64)


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    raise SystemExit(1)


def make_audio(b: int, seed: int = 0) -> np.ndarray:
    """Random PCM at the scale of 16-bit speech, as bench.py::make_audio."""
    rs = np.random.RandomState(seed)
    return (rs.randn(b, int(SECONDS * SAMPLE_RATE)) * 2000).astype(np.float32)


def time_ms(fn, reps: int = 10, warmup: int = 1) -> float:
    """Median over ``reps`` runs of ``fn`` timed with CUDA events."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def bound(nbytes: float, flops: float, peak: float):
    """Least time on the card (ms) and what bounds it."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / peak * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def compare(got, want, atol: float, rtol: float):
    """→ (max |got − want|, max relative error, every element within
    atol + rtol·|want|)."""
    max_abs = max_rel = 0.0
    ok = True
    for g, w in zip(got, want):
        d = (g.double() - w.double()).abs()
        max_abs = max(max_abs, float(d.max()))
        max_rel = max(max_rel, float((d / w.double().abs().clamp_min(1e-30)).max()))
        ok = ok and bool((d <= atol + rtol * w.double().abs()).all())
    return max_abs, max_rel, ok


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]


def check_frontend(cfg_fe, audio):
    from phones_las_torch.frontend import features as F
    from phones_las_torch.frontend.fused_frontend import fused_logmel, fused_logmel_plain

    b, s = audio.shape
    t = F.frames_for_samples(s, cfg_fe)
    x = F.preemphasize(audio, cfg_fe.preemphasis).contiguous()
    (lm, en), (plm, pen) = fused_logmel(x, cfg_fe, t), fused_logmel_plain(x, cfg_fe, t)
    torch.cuda.synchronize()
    tol = 1e-4
    max_abs, max_rel, ok = compare([lm], [plm], tol, tol)
    # the energy is a sum of powers (~1e9 for this PCM): held relatively
    en_abs, en_rel, en_ok = compare([en], [pen], 0.0, tol)
    win, nb, nm = cfg_fe.win_samples, cfg_fe.num_bins, cfg_fe.num_mel
    nbytes = 4 * (b * s + win * 2 * nb + nb * nm + b * t * (nm + 1))
    flops = b * t * (2 * win * 2 * nb + 4 * nb + 2 * nb * nm)
    bms, by = bound(nbytes, flops, F32_FLOPS)
    rec = {
        "phase": 1, "kernel": "fused_logmel", "shape": f"B={b} S={s} T={t}",
        "max_abs_err": max_abs, "max_rel_err": max_rel, "tol": f"logmel atol=rtol={tol}",
        "energy_max_abs_err": en_abs, "energy_max_rel_err": en_rel, "energy_tol": f"rtol={tol}",
        "ms": time_ms(lambda: fused_logmel(x, cfg_fe, t)),
        "plain_ms": time_ms(lambda: fused_logmel_plain(x, cfg_fe, t)),
        "library_ms": None, "bound_ms": bms, "bound_by": by,
    }
    emit(rec)
    if not (ok and en_ok):
        fail(f"front-end kernel disagrees with its plain version: {rec}")
    return rec


def check_bilstm(params, b, t, layer, prec, seed):
    from phones_las_torch.ops.lstm import bidir_recurrence, bidir_recurrence_plain
    from phones_las_torch.ops.masking import length_mask

    pf, pb = params.listener.layers[layer]
    u = pf.units
    g = torch.Generator(device=DEV).manual_seed(seed)
    lengths = torch.randint(t // 2, t + 1, (b,), generator=g, device=DEV)
    lengths[0] = t
    xpf = torch.randn((t, b, 4 * u), generator=g, device=DEV)
    xpb = torch.randn((t, b, 4 * u), generator=g, device=DEV)
    mask = length_mask(lengths, t).transpose(0, 1).contiguous()
    args = (xpf, xpb, mask, pf.wh, pb.wh, 1.0, prec)
    of, ob, (hf, cf), (hb, cb) = bidir_recurrence(*args)
    pof, pob, (phf, pcf), (phb, pcb) = bidir_recurrence_plain(*args)
    torch.cuda.synchronize()
    atol, rtol = (1e-5, 1e-5) if prec == "highest" else (2e-2, 0.0)
    max_abs, max_rel, ok = compare(
        (of, ob, hf, cf, hb, cb), (pof, pob, phf, pcf, phb, pcb), atol, rtol
    )
    # one bidirectional torch.nn.LSTM (cuDNN) over full-length rows of the
    # layer's real input width: the same recurrence with the forget bias
    # folded into the bias, plus the input projection the kernel leaves out
    d = pf.wx.shape[0]
    lstm = torch.nn.LSTM(d, u, bidirectional=True).to(DEV)
    with torch.no_grad():
        fb = torch.zeros(4 * u, device=DEV)
        fb[u:2 * u] = 1.0
        for sfx, p in (("", pf), ("_reverse", pb)):
            getattr(lstm, f"weight_ih_l0{sfx}").copy_(p.wx.t())
            getattr(lstm, f"weight_hh_l0{sfx}").copy_(p.wh.t())
            getattr(lstm, f"bias_ih_l0{sfx}").copy_(p.b + fb)
            getattr(lstm, f"bias_hh_l0{sfx}").zero_()
    x_in = torch.randn((t, b, d), generator=g, device=DEV)
    wbytes = 2 if prec == "bf16" else 4
    nbytes = 4 * (2 * t * b * 4 * u + t * b + 2 * t * b * u + 4 * b * u) + 2 * wbytes * u * 4 * u
    flops = 2 * t * b * (2 * u * 4 * u)
    bms, by = bound(nbytes, flops, BF16_FLOPS if prec == "bf16" else F32_FLOPS)
    rec = {
        "phase": 1, "kernel": "bidir_recurrence", "shape": f"T={t} B={b} U={u} prec={prec}",
        "max_abs_err": max_abs, "max_rel_err": max_rel, "tol": f"atol={atol} rtol={rtol}",
        "ms": time_ms(lambda: bidir_recurrence(*args)),
        "plain_ms": time_ms(lambda: bidir_recurrence_plain(*args)),
        "library_ms": time_ms(lambda: lstm(x_in)),
        "library": f"torch.nn.LSTM({d}, {u}, bidirectional=True), includes the input projection",
        "bound_ms": bms, "bound_by": by,
    }
    emit(rec)
    if not ok:
        fail(f"BiLSTM kernel disagrees with its plain version: {rec}")
    return rec


def check_greedy(params, cfg, memory, enc_mask, b):
    from phones_las_torch.decode.fused_greedy import greedy_decode_fused, greedy_decode_fused_plain

    sp, sc = params.speller, cfg.speller
    mem, mask = memory[:b].contiguous(), enc_mask[:b].contiguous()
    tok, _ = greedy_decode_fused(sp, sc, mem, mask, DECODE_STEPS)
    ptok, _ = greedy_decode_fused_plain(sp, sc, mem, mask, DECODE_STEPS)
    torch.cuda.synchronize()
    diff_rows = int((tok != ptok).any(dim=1).sum())
    t = mem.shape[1]
    # row-steps this data runs: each row up to and including its <eos>
    is_eos = (tok == sc.eos_id).int()
    first = torch.where(is_eos.any(1), is_eos.argmax(1) + 1, torch.full_like(is_eos[:, 0], DECODE_STEPS))
    row_steps = int(first.sum())
    u, a, m, al, v, e = sc.units, sc.attention_units, sc.memory_dim, sc.attention_layer_size, sc.vocab_size, sc.embedding_dim
    per_step = (
        2 * (e + al) * 4 * u + 2 * (sc.num_layers - 1) * u * 4 * u + 2 * sc.num_layers * u * 4 * u
        + 2 * u * a + t * (3 * a + 2 * m + 4) + 2 * (u + m) * al + 2 * al * v
    )
    wparams = sum(p.numel() for p in sp.parameters())
    nbytes = 4 * (b * t * (a + m + 1) + wparams + b * DECODE_STEPS)
    bms, by = bound(nbytes, row_steps * per_step, F32_FLOPS)
    rec = {
        "phase": 1, "kernel": "greedy_decode_fused", "shape": f"B={b} T={t} steps={DECODE_STEPS}",
        "max_abs_err": float((tok - ptok).abs().max()), "token_rows_differing": diff_rows,
        "tol": "tokens equal",
        "row_steps": row_steps,
        "ms": time_ms(lambda: greedy_decode_fused(sp, sc, mem, mask, DECODE_STEPS)),
        "plain_ms": time_ms(lambda: greedy_decode_fused_plain(sp, sc, mem, mask, DECODE_STEPS)),
        "library_ms": None, "bound_ms": bms, "bound_by": by,
    }
    emit(rec)
    if diff_rows:
        fail(f"greedy kernel tokens differ from its plain version: {rec}")
    return rec


def reset_counters(kernels) -> None:
    for fn in kernels:
        fn.launches = 0


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    from phones_las_torch.csrc import _build
    from phones_las_torch.decode.fused_greedy import greedy_decode_fused
    from phones_las_torch.decode.greedy import greedy_decode
    from phones_las_torch.frontend.fused_frontend import fused_logmel
    from phones_las_torch.models.las import encode, featurize
    from phones_las_torch.models.listener import listen
    from phones_las_torch.ops.lstm import bidir_recurrence
    from phones_las_torch.ops.masking import length_mask
    from phones_las_torch.utils.device import set_parity_mode
    from phones_las_torch.utils.metrics import edit_distance_stats, per_from_stats
    from phones_las_torch.utils.param_io import load_artifact

    kernels = (fused_logmel, bidir_recurrence, greedy_decode_fused)
    card = card_line()
    _build.library()
    emit({
        "phase": 0, "card": card, "torch": torch.__version__, "cuda": torch.version.cuda,
        "parity_mode": set_parity_mode(), "build_seconds": _build.last_build_seconds,
    })
    print((_build.BUILD_DIR / "build.log").read_text() if (_build.BUILD_DIR / "build.log").exists() else "",
          file=sys.stderr, flush=True)
    torch.set_grad_enabled(False)

    ckpt = os.path.join(ASSETS, "ckpt.npz")
    params, cfg, _ = load_artifact(ckpt, device=None if DEV == "cuda" else DEV)

    # ---- phase 1: each kernel against its plain version, at main-path shapes
    audio64 = torch.from_numpy(make_audio(FLAGSHIP_B)).to(DEV)
    full_len = torch.full((FLAGSHIP_B,), audio64.shape[1], dtype=torch.int32, device=DEV)
    fe_rec = check_frontend(cfg.frontend, audio64)
    lstm_recs = [
        check_bilstm(params, FLAGSHIP_B, t, layer, prec, seed=10 + i)
        for i, (t, layer, prec) in enumerate(LSTM_CASES)
    ]
    memory, _, enc_mask = encode(params, cfg, audio64, full_len)
    dec_recs = [check_greedy(params, cfg, memory, enc_mask, b) for b in DECODER_BATCHES]

    # ---- phase 2: the committed checkpoint on the committed eval set
    data = np.load(os.path.join(ASSETS, "eval_set.npz"), allow_pickle=False)
    cap = int(data["decode_cap"][0])
    refs = data["refs"]
    ref_lens = (refs >= 0).sum(axis=1)
    ref_ids = np.where(refs >= 0, refs, 0)

    def decode_eval(p, device):
        audio = torch.from_numpy(data["audio"]).to(device)
        lens = torch.from_numpy(data["lengths"]).to(device)
        mem, _, mask = encode(p, cfg, audio, lens)
        tok, tl, _ = greedy_decode(p.speller, cfg.speller, mem, mask, cap)
        return tok.cpu().numpy(), tl.cpu().numpy()

    reset_counters(kernels)
    tok_gpu, len_gpu = decode_eval(params, DEV)
    torch.cuda.synchronize()
    launches = {fn.__name__: fn.launches for fn in kernels}
    params_cpu, _, _ = load_artifact(ckpt, device="cpu")
    tok_cpu, _ = decode_eval(params_cpu, "cpu")
    diff = [
        {"row": i, "first_step": int(np.nonzero(tok_gpu[i] != tok_cpu[i])[0][0])}
        for i in range(len(tok_gpu)) if (tok_gpu[i] != tok_cpu[i]).any()
    ]
    per = per_from_stats(*edit_distance_stats(tok_gpu, len_gpu, ref_ids, ref_lens))
    emit({
        "phase": 2, "utterances": len(tok_gpu), "decode_cap": cap, "greedy_per": per,
        "reference_per": REF_GREEDY_PER, "rows_differing_from_cpu_plain": diff,
        "launches": launches,
    })
    if len(diff) > MAX_DIFF_ROWS:
        fail(f"{len(diff)} token rows differ from the CPU plain path (at most {MAX_DIFF_ROWS})")
    if abs(per - REF_GREEDY_PER) > PER_TOL:
        fail(f"greedy PER {per} is not within {PER_TOL} of {REF_GREEDY_PER}")
    if not all(launches.values()):
        fail(f"a kernel of the main path never launched: {launches}")

    # ---- phase 3: the flagship shape, 64 × 10 s, 200 greedy steps
    def flagship():
        t0 = time.perf_counter()
        feats, flens = featurize(params, cfg, audio64, full_len)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        mem, enc_lens = listen(params.listener, cfg.listener, feats, flens)
        mask = length_mask(enc_lens, mem.shape[1])
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        tok, _, _ = greedy_decode(params.speller, cfg.speller, mem, mask, DECODE_STEPS)
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        return tok, (t1 - t0, t2 - t1, t3 - t2)

    reset_counters(kernels)
    tok3, _ = flagship()
    flag_launches = {fn.__name__: fn.launches for fn in kernels}
    if not all(flag_launches.values()):
        fail(f"a kernel of the main path never launched at the flagship shape: {flag_launches}")
    if tok3.shape != (FLAGSHIP_B, DECODE_STEPS):
        fail(f"flagship tokens have shape {tuple(tok3.shape)}")
    splits = [flagship()[1] for _ in range(5)]
    fe_s, li_s, de_s = (statistics.median(x) for x in zip(*splits))
    total = fe_s + li_s + de_s
    emit({
        "phase": 3, "shape": f"B={FLAGSHIP_B} x {SECONDS} s, {DECODE_STEPS} greedy steps",
        "utt_per_s": FLAGSHIP_B / total, "total_ms": total * 1e3, "frontend_ms": fe_s * 1e3,
        "listener_ms": li_s * 1e3, "decoder_ms": de_s * 1e3, "launches": flag_launches,
        "card": card,
    })

    def kernel_entry(name, source, replaces, rec):
        return {
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches[name], "max_abs_err": rec["max_abs_err"],
            "ms": rec["ms"], "plain_ms": rec["plain_ms"], "bound_ms": rec["bound_ms"],
            "bound_by": rec["bound_by"], "library_ms": rec["library_ms"],
        }

    emit({"kernels": [
        kernel_entry("fused_logmel", "phones_las_torch/csrc/frontend.cu",
                     "phones_las_tpu/frontend/pallas_frontend.py:110", fe_rec),
        kernel_entry("bidir_recurrence", "phones_las_torch/csrc/bilstm.cu",
                     "phones_las_tpu/ops/lstm.py:269", lstm_recs[0]),
        kernel_entry("greedy_decode_fused", "phones_las_torch/csrc/greedy.cu",
                     "phones_las_tpu/decode/pallas_greedy.py:134", dec_recs[-1]),
    ]})
    print(card, flush=True)
    emit({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }})
    return 0


if __name__ == "__main__":
    sys.exit(main())
