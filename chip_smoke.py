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
     10 runs, warm L2); the front-end kernel also at the eval set's shape,
     under an odd window and hop and at transforms of 1024 and 2048
     points (smaller frame tiles), with the SM cycles one block spends
     in each part; for the two cluster kernels (the LSTM forward and
     the greedy decoder) it also prints the cluster size, the rows of a
     tile or group, what ``cudaOccupancyMaxActiveClusters`` says, shared
     memory and registers, µs per step and the SM cycles a step spends in
     each of its parts; then holds both on ragged cases (a batch that is no
     multiple of the tile, rows of very different lengths, widths that
     only a cluster of one serves) at a short T;
  2. decodes the committed checkpoint on all 64 utterances of the
     committed eval set on the card (load_artifact → encode →
     greedy_decode, launch counters set to 0 just before and read just
     after) and holds the tokens and greedy PER against the port's plain
     path on the CPU and against the reference's PER;
  3. runs the same path at the flagship shape (64 × 10 s of random PCM,
     200 greedy steps) and prints utt/s and the split among front-end,
     listener and decoder;
  4. the training slice, with gradients on:
     a. holds the three training LSTM kernels (``recurrence``,
        ``recurrence_residual``, ``recurrence_bwd``) against their plain
        versions at B = 32 and the listener's widths, and times them as
        phase 1 does, beside cuDNN's ``torch.nn.LSTM``; for the VJP it
        also prints the plan of its cluster kernel, what the card gives
        it, µs per step, the SM cycles a step spends in each part, the
        milliseconds of each of its four kernels and whether two runs
        are bitwise equal, and holds it on the ragged cases of phase 1;
     b. one step of the committed checkpoint on the eval set
        (``compute_loss(train=False)``, backward, one optimizer step) on
        the card and on the CPU plain path: loss, every gradient leaf and
        every updated leaf held within the bounds stated below;
     c. ``Trainer.train_step`` at full width (32 × 10 s of random PCM,
        200-token targets, dropout and scheduled sampling on), 6 steps on
        one batch: ms per step, peak device memory, the loss of each step
        (finite and falling) and each step's kernel launches; then the
        device time of one more step under ``torch.profiler``, and 3 more
        steps driven in their three parts (``Trainer.loss``, backward,
        ``Trainer.apply_gradients``) for the split of a step into
        forward, backward and optimizer;
     d. the ops API: ``lstm_layer`` without and with gradients.

``python3 chip_smoke.py --sweep`` runs none of the phases: it times the
LSTM forward kernel under every plan it takes at the flagship width
(cluster 8 or 16 blocks, tiles of 8 or 16 rows, both precisions, the
serving and the ops-API shape), each held against the chosen plan's
output, and prints one line a plan; then the VJP's loop kernel the same
way at the training shape; the numbers behind the choice of
``CLUSTER_SIZES`` in ``ops/lstm.py``.

``python3 chip_smoke.py --compare DIR`` runs none of the phases either: it
times the front-end kernel (flagship shape) and the VJP (T = 999, B = 32,
both precisions) of another checkout of this repository unpacked at DIR
(say the parent commit, ``git archive`` into an ignored directory) and of
this one, each in a process of its own, in the order other, this, this,
other on the same card, and prints one line a run: the numbers behind a
"[was …]" in ``PERF.md``. ``--time-kernels DIR`` is one such run, of the
package in the checkout at DIR.

Every phase that fails ends the script with a non-zero exit code. The
line before the last holds the card's name and power limit as
``nvidia-smi`` prints them; the line before that the kernels' record;
the last line is ``{"ok": true, "device": {...}}``. Without a CUDA
device the script exits non-zero and prints no result.
"""

from __future__ import annotations

import dataclasses
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
# BiLSTM checks: (T, listener layer whose wh is used, recurrent-dot precision);
# the three float32 cases are the three launches of one serving call
LSTM_CASES = ((999, 0, "highest"), (999, 0, "bf16"), (250, 2, "highest"), (250, 2, "bf16"), (500, 1, "highest"))
# ragged agreement checks of the LSTM forward kernel: (T, B, U), each in both
# precisions, one and two directions, with and without the residuals
RAGGED_LSTM = ((37, 13, 256), (20, 5, 40), (20, 9, 248))
RAGGED_DECODER_B = 13
RAGGED_DECODER_STEPS = 60
DECODER_BATCHES = (8, 64)
TRAIN_B = 32
TRAIN_STEPS = 6
SPLIT_STEPS = 3  # further steps timed in their three parts
EOS_ID = 2
# phase 4b bounds, card against the CPU plain path: the loss relative to
# the CPU's; each gradient leaf's max |d| over its max |g_cpu|; each
# updated leaf's max |d| (a tenth of Adam's first step, lr = 1e-3)
LOSS_TOL = 1e-5
GRAD_TOL = 1e-4
PARAM_TOL = 1e-4


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


def check_frontend(cfg_fe, audio, what="flagship"):
    from phones_las_torch.frontend import features as F
    from phones_las_torch.frontend.fused_frontend import (
        CLOCK_NAMES, frame_tile, fused_logmel, fused_logmel_plain,
    )

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
    # the mel matrix is sparse (narrow triangles): only its non-zero entries are work
    mel_nnz = int((F.mel_matrix(cfg_fe, x.device) != 0).sum())
    flops = b * t * (2 * win * 2 * nb + 4 * nb + 2 * mel_nnz)
    bms, by = bound(nbytes, flops, F32_FLOPS)
    clocks = torch.zeros(len(CLOCK_NAMES), dtype=torch.int64, device=DEV)
    fused_logmel(x, cfg_fe, t, clocks)
    torch.cuda.synchronize()
    rec = {
        "phase": 1, "kernel": "fused_logmel", "shape": f"B={b} S={s} T={t} ({what})",
        "nfft": cfg_fe.nfft, "frame_tile": frame_tile(cfg_fe), "mel_nonzeros": mel_nnz,
        "cycles_of_one_block": dict(zip(CLOCK_NAMES, clocks.tolist())),
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


def forward_report(entry, xps, mask, whs, reverse, prec, ms=None):
    """The plan of the forward kernel's last launch, what the card gives it,
    and (one more launch) the SM cycles a step spends in its parts."""
    from phones_las_torch.ops import lstm as L

    plan = L._launch_forward.last_plan
    t, _, four_u = xps[0].shape
    info = L.forward_kernel_info(four_u // 4, prec == "bf16", entry == "plt_lstm_residual",
                                 plan.cluster, plan.bt, plan.ksplit, plan.resident)
    clocks = torch.zeros(4, dtype=torch.int64, device=DEV)
    L._launch_forward(entry, xps, mask, whs, 1.0, reverse, prec, None, clocks)
    torch.cuda.synchronize()
    rep = {
        "cluster": plan.cluster, "bt": plan.bt, "ksplit": plan.ksplit, "wh_in_smem": plan.resident,
        "clusters_launched": -(-xps[0].shape[1] // plan.bt) * len(xps), **info,
        "cycles_per_step": dict(zip(("product", "cell_update", "stores_prefetch", "h_wait"),
                                    (c / t for c in clocks.tolist()))),
    }
    if ms is not None:
        rep["us_per_step"] = ms * 1e3 / t
    if info["smem_bytes"] != plan.smem:
        fail(f"the kernel's shared memory ({info['smem_bytes']}) is not what forward_plan computed ({plan.smem})")
    return rep


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
    ms = time_ms(lambda: bidir_recurrence(*args))
    launch = forward_report("plt_lstm_recurrence", [xpf, xpb], mask, [pf.wh, pb.wh], [False, True], prec, ms)
    rec = {
        "phase": 1, "kernel": "bidir_recurrence", "shape": f"T={t} B={b} U={u} prec={prec}",
        "max_abs_err": max_abs, "max_rel_err": max_rel, "tol": f"atol={atol} rtol={rtol}",
        "ms": ms, "launch": launch,
        "plain_ms": time_ms(lambda: bidir_recurrence_plain(*args)),
        "library_ms": time_ms(lambda: lstm(x_in)),
        "library": f"torch.nn.LSTM({d}, {u}, bidirectional=True), includes the input projection",
        "bound_ms": bms, "bound_by": by,
    }
    emit(rec)
    if not ok:
        fail(f"BiLSTM kernel disagrees with its plain version: {rec}")
    if launch["cluster"] <= 1 or not launch["wh_in_smem"]:
        fail(f"the BiLSTM kernel did not run as a cluster with wh in shared memory: {launch}")
    if launch["clusters_launched"] > launch["max_active_clusters"]:
        fail(f"the BiLSTM kernel's clusters do not fit in one wave: {launch}")
    return rec


def check_lstm_ragged(t, b, u, seed):
    """The forward kernel on a batch that is no multiple of its tile, rows
    of lengths from 1 to T, and (U = 40, 248) widths only a cluster of one
    serves: both precisions, one and two directions, both entries."""
    from phones_las_torch.ops import lstm as L
    from phones_las_torch.ops.masking import length_mask

    g = torch.Generator(device=DEV).manual_seed(seed)
    lengths = torch.randint(1, t + 1, (b,), generator=g, device=DEV)
    lengths[0], lengths[1] = t, 1
    mask = length_mask(lengths, t).transpose(0, 1).contiguous()
    worst = {}
    plans = set()
    ok = True
    for prec in ("highest", "bf16"):
        tol, res_tol = (1e-5, 1e-5) if prec == "highest" else (2e-2, 3e-2)
        for nd in (1, 2):
            xps = [torch.randn((t, b, 4 * u), generator=g, device=DEV) for _ in range(nd)]
            whs = [torch.randn((u, 4 * u), generator=g, device=DEV) / u ** 0.5 for _ in range(nd)]
            rev = [False, True][:nd] if nd == 2 else [True]
            want = L.recurrence_residual_plain(xps, mask, whs, 1.0, rev, prec)
            got = L.recurrence_residual(xps, mask, whs, 1.0, rev, prec)
            plans.add(tuple(L._launch_forward.last_plan))
            if nd == 1:
                out, (h, c) = L.recurrence(xps[0], mask, whs[0], 1.0, rev[0], prec)
                primal = [(out, h, c)]
            else:
                of, ob, (hf, cf), (hb, cb) = L.bidir_recurrence(xps[0], xps[1], mask, whs[0], whs[1], 1.0, prec)
                primal = [(of, hf, cf), (ob, hb, cb)]
            plans.add(tuple(L._launch_forward.last_plan))
            torch.cuda.synchronize()
            for k, p, pr in zip(got, want, primal):
                a, _, k_ok = compare((k[0], k[3], k[4]), (p[0], p[3], p[4]), tol, tol)
                ar, _, r_ok = compare((k[1], k[2]), (p[1], p[2]), res_tol, res_tol)
                ap, _, p_ok = compare(pr, (p[0], p[3], p[4]), tol, tol)
                ok = ok and k_ok and r_ok and p_ok
                worst[prec] = max(worst.get(prec, 0.0), a, ar, ap)
    rec = {"phase": 1, "kernel": "lstm forward, ragged", "shape": f"T={t} B={b} U={u} lengths 1..{t}",
           "max_abs_err": worst, "tol": "highest 1e-5; bf16 2e-2, residuals 3e-2",
           "plans (cluster, bt, ksplit, wh_in_smem, smem_bytes)": sorted(plans), "ok": ok}
    emit(rec)
    if not ok:
        fail(f"the LSTM forward kernel disagrees with its plain version on a ragged case: {rec}")
    return rec


def check_greedy(params, cfg, memory, enc_mask, b, steps=DECODE_STEPS, timed=True):
    from phones_las_torch.decode.fused_greedy import CLOCK_NAMES, greedy_decode_fused, greedy_decode_fused_plain

    sp, sc = params.speller, cfg.speller
    mem, mask = memory[:b].contiguous(), enc_mask[:b].contiguous()
    tok, _ = greedy_decode_fused(sp, sc, mem, mask, steps)
    ptok, _ = greedy_decode_fused_plain(sp, sc, mem, mask, steps)
    torch.cuda.synchronize()
    diff_rows = int((tok != ptok).any(dim=1).sum())
    t = mem.shape[1]
    # row-steps this data runs: each row up to and including its <eos>
    is_eos = (tok == sc.eos_id).int()
    first = torch.where(is_eos.any(1), is_eos.argmax(1) + 1, torch.full_like(is_eos[:, 0], steps))
    row_steps = int(first.sum())
    u, a, m, al, v, e = sc.units, sc.attention_units, sc.memory_dim, sc.attention_layer_size, sc.vocab_size, sc.embedding_dim
    per_step = (
        2 * (e + al) * 4 * u + 2 * (sc.num_layers - 1) * u * 4 * u + 2 * sc.num_layers * u * 4 * u
        + 2 * u * a + t * (3 * a + 2 * m + 4) + 2 * (u + m) * al + 2 * al * v
    )
    wparams = sum(p.numel() for p in sp.parameters())
    nbytes = 4 * (b * t * (a + m + 1) + wparams + b * steps)
    bms, by = bound(nbytes, row_steps * per_step, F32_FLOPS)
    clocks = torch.zeros(len(CLOCK_NAMES), dtype=torch.int64, device=DEV)
    greedy_decode_fused(sp, sc, mem, mask, steps, clocks)
    torch.cuda.synchronize()
    launch = dict(greedy_decode_fused.last_launch)
    counts = clocks.tolist()
    steps_run = max(counts[-1], 1)  # of the first group
    launch["steps_of_first_group"] = counts[-1]
    launch["cycles_per_step"] = {n: c / steps_run for n, c in zip(CLOCK_NAMES[:-1], counts)}
    # the design's own floor: the weights once a group and step, keys and
    # memory once a row and step, all from L2
    groups = -(-b // launch["rows"])
    launch["l2_bytes_per_step"] = 4 * (groups * wparams + b * t * (a + m))
    rec = {
        "phase": 1, "kernel": "greedy_decode_fused", "shape": f"B={b} T={t} steps={steps}",
        "max_abs_err": float((tok - ptok).abs().max()), "token_rows_differing": diff_rows,
        "tol": "tokens equal",
        "row_steps": row_steps, "launch": launch,
        "library_ms": None, "bound_ms": bms, "bound_by": by,
    }
    if timed:
        rec["ms"] = time_ms(lambda: greedy_decode_fused(sp, sc, mem, mask, steps))
        rec["plain_ms"] = time_ms(lambda: greedy_decode_fused_plain(sp, sc, mem, mask, steps))
        launch["us_per_step"] = rec["ms"] * 1e3 / max(int(first.max()), 1)
    if diff_rows:
        bad = [{"row": r, "first_step": int((tok[r] != ptok[r]).nonzero()[0])}
               for r in (tok != ptok).any(dim=1).nonzero().flatten().tolist()]
        rec["rows_differing"] = bad
    emit(rec)
    if diff_rows:
        fail(f"greedy kernel tokens differ from its plain version: {rec}")
    if timed and launch["cluster"] <= 1:
        fail(f"the greedy kernel did not run as a cluster: {launch}")
    return rec


def rel_err(got, want) -> float:
    """max |got − want| over max |want|."""
    return float((got.double() - want.double()).abs().max()) / max(float(want.double().abs().max()), 1e-30)


BWD_PARTS = ("gates_gemm", "loop", "dwh_partial", "dwh_reduce")
BWD_CLOCKS = ("dgates", "product", "send", "prefetch", "wait")


def backward_report(bargs, t):
    """The plan of the VJP's last launch, what the card gives its loop
    kernel, the milliseconds of its four kernels (median of 5 launches) and
    (one more launch) the SM cycles a step of the loop spends in its parts."""
    from phones_las_torch.ops import lstm as L

    plan = L._launch_backward.last_plan
    xps, prec = bargs[0], bargs[-1]
    u = xps[0].shape[2] // 4
    info = L.backward_kernel_info(u, prec == "bf16", plan)
    runs = []
    for _ in range(5):
        ms = []
        L._launch_backward(*bargs, part_ms=ms)
        runs.append(ms)
    parts = {name: statistics.median(r[i] for r in runs) for i, name in enumerate(BWD_PARTS)}
    clocks = torch.zeros(len(BWD_CLOCKS), dtype=torch.int64, device=DEV)
    L._launch_backward(*bargs, clocks=clocks)
    torch.cuda.synchronize()
    rep = {
        "cluster": plan.cluster, "bt": plan.bt, "ksplit": plan.ksplit,
        "wh_in_smem": plan.resident, "clusters_launched": -(-xps[0].shape[1] // plan.bt) * len(xps), **info,
        "kernel_ms": parts, "us_per_step": parts["loop"] * 1e3 / t,
        "cycles_per_step": dict(zip(BWD_CLOCKS, (c / t for c in clocks.tolist()))),
    }
    if info["smem_bytes"] != plan.smem:
        fail(f"the loop kernel's shared memory ({info['smem_bytes']}) is not what backward_plan computed ({plan.smem})")
    return rep


def check_lstm_bwd_ragged(t, b, u, seed):
    """The VJP on a batch that is no multiple of its tile, rows of lengths
    from 1 to T, and (U = 40, 248) widths only a cluster of one serves:
    both precisions, one and two directions, against the plain version on
    the plain version's residuals; two runs bitwise equal."""
    from phones_las_torch.ops import lstm as L
    from phones_las_torch.ops.masking import length_mask

    g = torch.Generator(device=DEV).manual_seed(seed)
    lengths = torch.randint(1, t + 1, (b,), generator=g, device=DEV)
    lengths[0], lengths[1] = t, 1
    mask = length_mask(lengths, t).transpose(0, 1).contiguous()
    worst, plans = {}, set()
    ok = True
    for prec in ("highest", "bf16"):
        tol = 1e-4 if prec == "highest" else 3e-2
        for nd in (1, 2):
            rnd = lambda *shape: torch.randn(shape, generator=g, device=DEV)
            xps = [rnd(t, b, 4 * u) for _ in range(nd)]
            whs = [rnd(u, 4 * u) / u ** 0.5 for _ in range(nd)]
            rev = [False, True][:nd] if nd == 2 else [True]
            res = L.recurrence_residual_plain(xps, mask, whs, 1.0, rev, prec)
            bargs = (xps, mask, whs, [r[1] for r in res], [r[2] for r in res],
                     [rnd(t, b, u) for _ in range(nd)], [rnd(b, u) for _ in range(nd)],
                     [rnd(b, u) for _ in range(nd)], 1.0, rev, prec)
            got = L.recurrence_bwd(*bargs)
            plans.add(tuple(L._launch_backward.last_plan))
            again = L.recurrence_bwd(*bargs)
            want = L.recurrence_bwd_plain(*bargs)
            torch.cuda.synchronize()
            err = max(rel_err(k, p) for kg, pg in zip(got, want) for k, p in zip(kg, pg))
            same = all(torch.equal(x, y) for kg, ag in zip(got, again) for x, y in zip(kg, ag))
            # masked steps pass no gradient into xp
            dead = all(float((kg[0] * (1.0 - mask)[:, :, None]).abs().max()) == 0.0 for kg in got)
            ok = ok and err <= tol and same and dead
            worst[prec] = max(worst.get(prec, 0.0), err)
    rec = {"phase": "4a", "kernel": "recurrence_bwd, ragged", "shape": f"T={t} B={b} U={u} lengths 1..{t}",
           "max_rel_to_max": worst, "tol": "dxp, dwh max|d|/max|plain|: highest 1e-4, bf16 3e-2; bitwise repeatable",
           "plans (cluster, bt, ksplit, wh_in_smem, smem_bytes)": sorted(plans), "ok": ok}
    emit(rec)
    if not ok:
        fail(f"the VJP kernel disagrees with its plain version on a ragged case: {rec}")
    return rec


def cudnn_lstm(d, u, bidirectional):
    """A torch.nn.LSTM (cuDNN) of the listener layer's width, for library_ms."""
    return torch.nn.LSTM(d, u, bidirectional=bidirectional).to(DEV)


def check_lstm_train(params, t, layer, prec, seed):
    """Phase 4a: the training path's three LSTM kernels against their
    plain versions at B = TRAIN_B, both directions → (recurrence record,
    residual record, VJP record)."""
    from phones_las_torch.ops import lstm as L
    from phones_las_torch.ops.masking import length_mask

    pf, pb = params.listener.layers[layer]
    u, d, b = pf.units, pf.wx.shape[0], TRAIN_B
    g = torch.Generator(device=DEV).manual_seed(seed)
    lengths = torch.randint(t // 2, t + 1, (b,), generator=g, device=DEV)
    lengths[0] = t
    xpf, xpb = (torch.randn((t, b, 4 * u), generator=g, device=DEV) for _ in range(2))
    mask = length_mask(lengths, t).transpose(0, 1).contiguous()
    whs = [pf.wh.detach(), pb.wh.detach()]
    bf16 = prec == "bf16"
    tol = 2e-2 if bf16 else 1e-5
    res_tol = 3e-2 if bf16 else 1e-5
    vjp_tol = 3e-2 if bf16 else 1e-4
    peak = BF16_FLOPS if bf16 else F32_FLOPS
    wbytes = rbytes = 2 if bf16 else 4
    dot = 2 * t * b * u * 4 * u  # one direction's recurrent dots
    shape = f"T={t} B={b} U={u} prec={prec}"

    # library yardsticks: cuDNN LSTMs of the layer's width over full-length rows
    x_in = torch.randn((t, b, d), generator=g, device=DEV, requires_grad=True)
    uni, bi = cudnn_lstm(d, u, False), cudnn_lstm(d, u, True)
    g_out = torch.randn((t, b, 2 * u), generator=g, device=DEV)

    def lib_fwd_bwd():
        torch.autograd.backward(bi(x_in)[0], g_out)

    with torch.no_grad():
        lib_uni_ms = time_ms(lambda: uni(x_in))
    lib_fwd_ms = time_ms(lambda: bi(x_in))
    lib_fwd_bwd_ms = time_ms(lib_fwd_bwd)

    # recurrence (one direction a call): forward on xpf, reverse on xpb
    recs = []
    ok = True
    max_abs = 0.0
    for xp, wh, rev in ((xpf, whs[0], False), (xpb, whs[1], True)):
        out, (h, c) = L.recurrence(xp, mask, wh, 1.0, rev, prec)
        pout, (ph, pc) = L.recurrence_plain(xp, mask, wh, 1.0, rev, prec)
        torch.cuda.synchronize()
        a, _, k_ok = compare((out, h, c), (pout, ph, pc), tol, tol)
        ok, max_abs = ok and k_ok, max(max_abs, a)
    nbytes = 4 * (t * b * 4 * u + t * b + t * b * u + 2 * b * u) + wbytes * u * 4 * u
    bms, by = bound(nbytes, dot, peak)
    ms = time_ms(lambda: L.recurrence(xpf, mask, whs[0], 1.0, False, prec))
    recs.append({
        "phase": "4a", "kernel": "recurrence", "shape": shape + " one direction",
        "max_abs_err": max_abs, "tol": f"atol=rtol={tol}", "ok": ok,
        "ms": ms, "launch": forward_report("plt_lstm_recurrence", [xpf], mask, whs[:1], [False], prec, ms),
        "plain_ms": time_ms(lambda: L.recurrence_plain(xpf, mask, whs[0], 1.0, False, prec)),
        "library_ms": lib_uni_ms, "library": f"torch.nn.LSTM({d}, {u}) forward, no grad",
        "library_fwd_bwd_ms": lib_fwd_bwd_ms, "bound_ms": bms, "bound_by": by,
    })

    # recurrence_residual: both directions in one launch
    args = ([xpf, xpb], mask, whs, 1.0, [False, True], prec)
    res = L.recurrence_residual(*args)
    pres = L.recurrence_residual_plain(*args)
    torch.cuda.synchronize()
    max_abs, ok = 0.0, True
    for k, pk in zip(res, pres):
        a, _, s_ok = compare((k[0], k[3], k[4]), (pk[0], pk[3], pk[4]), tol, tol)
        ar, _, r_ok = compare((k[1], k[2]), (pk[1], pk[2]), res_tol, res_tol)
        ok, max_abs = ok and s_ok and r_ok, max(max_abs, a, ar)
    nbytes = 2 * (4 * t * b * 4 * u + 4 * t * b * u + 2 * rbytes * t * b * u + 4 * 2 * b * u + wbytes * u * 4 * u) + 4 * t * b
    bms, by = bound(nbytes, 2 * dot, peak)
    ms = time_ms(lambda: L.recurrence_residual(*args))
    recs.append({
        "phase": "4a", "kernel": "recurrence_residual", "shape": shape + " both directions",
        "max_abs_err": max_abs, "tol": f"out, h, c atol=rtol={tol}; hprev, cprev atol=rtol={res_tol}", "ok": ok,
        "ms": ms, "launch": forward_report("plt_lstm_residual", [xpf, xpb], mask, whs, [False, True], prec, ms),
        "plain_ms": time_ms(lambda: L.recurrence_residual_plain(*args)),
        "library_ms": lib_fwd_ms, "library": f"torch.nn.LSTM({d}, {u}, bidirectional=True) forward under grad",
        "library_fwd_bwd_ms": lib_fwd_bwd_ms, "bound_ms": bms, "bound_by": by,
    })

    # recurrence_bwd on the kernel's own residuals, both directions in one launch
    douts = [torch.randn((t, b, u), generator=g, device=DEV) for _ in range(2)]
    dhs = [torch.randn((b, u), generator=g, device=DEV) for _ in range(2)]
    dcs = [torch.randn((b, u), generator=g, device=DEV) for _ in range(2)]
    bargs = ([xpf, xpb], mask, whs, [r[1] for r in res], [r[2] for r in res], douts, dhs, dcs,
             1.0, [False, True], prec)
    grads = L.recurrence_bwd(*bargs)
    pgrads = L.recurrence_bwd_plain(*bargs)
    again = L.recurrence_bwd(*bargs)
    torch.cuda.synchronize()
    errs = [rel_err(k, p) for kg, pg in zip(grads, pgrads) for k, p in zip(kg, pg)]
    deterministic = all(torch.equal(x, y) for kg, ag in zip(grads, again) for x, y in zip(kg, ag))
    nbytes = 2 * (2 * 4 * t * b * 4 * u + (2 * rbytes + 4) * t * b * u + 4 * 2 * b * u + 2 * wbytes * u * 4 * u + 4 * u * 4 * u) + 4 * t * b
    bms, by = bound(nbytes, 3 * 2 * dot, peak)
    launch = backward_report(bargs, t)
    recs.append({
        "phase": "4a", "kernel": "recurrence_bwd", "shape": shape + " both directions",
        "max_abs_err": max(float((k - p).abs().max()) for kg, pg in zip(grads, pgrads) for k, p in zip(kg, pg)),
        "max_rel_to_max": max(errs), "tol": f"dxp, dwh max|d|/max|plain| <= {vjp_tol}",
        "bitwise_repeatable": deterministic, "ok": max(errs) <= vjp_tol and deterministic,
        "ms": time_ms(lambda: L.recurrence_bwd(*bargs)), "launch": launch,
        "plain_ms": time_ms(lambda: L.recurrence_bwd_plain(*bargs)),
        "library_ms": lib_fwd_bwd_ms, "library": f"torch.nn.LSTM({d}, {u}, bidirectional=True) forward + backward",
        "library_fwd_bwd_ms": lib_fwd_bwd_ms, "bound_ms": bms, "bound_by": by,
    })
    for rec in recs:
        emit(rec)
    bad = [r["kernel"] for r in recs if not r["ok"]]
    if bad:
        fail(f"training LSTM kernels disagree with their plain versions at {shape}: {bad}")
    if launch["cluster"] <= 1 or not launch["wh_in_smem"]:
        fail(f"the VJP's loop did not run as a cluster with its slice of wh in shared memory: {launch}")
    if launch["clusters_launched"] > launch["max_active_clusters"]:
        fail(f"the VJP's clusters do not fit in one wave: {launch}")
    return recs


def eval_batch(data) -> dict:
    """All utterances of the committed eval set, targets = refs + <eos>."""
    refs = data["refs"]
    ref_lens = (refs >= 0).sum(axis=1)
    targets = np.zeros((len(refs), int(ref_lens.max()) + 1), np.int32)
    for i, n in enumerate(ref_lens):
        targets[i, :n] = refs[i, :n]
        targets[i, n] = EOS_ID
    return {
        "audio": data["audio"], "audio_lengths": data["lengths"],
        "targets": targets, "target_lengths": (ref_lens + 1).astype(np.int32),
    }


def check_train_step(ckpt, data, kernels):
    """Phase 4b: compute_loss(train=False), backward and one optimizer step
    of the committed checkpoint on the eval set, on the card and on the
    CPU plain path; loss, every gradient leaf and every updated leaf held."""
    from phones_las_torch.models.las import compute_loss
    from phones_las_torch.train.loop import Trainer
    from phones_las_torch.train.state import TrainConfig
    from phones_las_torch.utils.param_io import load_artifact, named_leaves

    batch = eval_batch(data)
    runs = {}
    for dev in (DEV, "cpu"):
        params, cfg, _ = load_artifact(ckpt, device=dev)
        tr = Trainer(cfg, TrainConfig(), device=dev)
        tr.warm_start(params)
        if dev == DEV:
            reset_counters(kernels)
        loss, _ = compute_loss(tr.state.params, cfg, tr.device_batch(batch), train=False, prec=tr.prec)
        loss.backward()
        grads = {k: t.grad.detach().cpu() for k, t in named_leaves(tr.state.params) if t.grad is not None}
        tr.apply_gradients()
        if dev == DEV:
            torch.cuda.synchronize()
            launches = {fn.__name__: fn.launches for fn in kernels}
        runs[dev] = (loss.item(), grads, {k: t.detach().cpu() for k, t in named_leaves(tr.state.params)})
    (gl, gg, gp), (cl, cg, cp) = runs[DEV], runs["cpu"]
    loss_rel = abs(gl - cl) / abs(cl)
    grad_rel = {k: rel_err(gg[k], cg[k]) for k in cg}
    param_abs = {k: float((gp[k] - cp[k]).abs().max()) for k in cp}
    worst_g = max(grad_rel, key=grad_rel.get)
    worst_p = max(param_abs, key=param_abs.get)
    rec = {
        "phase": "4b", "utterances": len(batch["audio"]), "loss_gpu": gl, "loss_cpu": cl,
        "loss_rel_err": loss_rel, "loss_tol": LOSS_TOL,
        "grad_leaves": len(grad_rel), "grad_max_rel_to_max": grad_rel[worst_g], "grad_worst_leaf": worst_g,
        "grad_tol": GRAD_TOL, "param_max_abs_err": param_abs[worst_p], "param_worst_leaf": worst_p,
        "param_tol": PARAM_TOL, "launches": launches,
    }
    emit(rec)
    if set(gg) != set(cg):
        fail(f"gradient leaves differ between the card and the CPU: {sorted(set(gg) ^ set(cg))}")
    if loss_rel > LOSS_TOL or grad_rel[worst_g] > GRAD_TOL or param_abs[worst_p] > PARAM_TOL:
        fail(f"the training step on the card disagrees with the CPU plain path: {rec}")
    if launches["bidir_recurrence"] or not (launches["recurrence_residual"] and launches["recurrence_bwd"]):
        fail(f"the step under grad did not run the residual and VJP kernels alone: {launches}")
    return rec


def profile_step(step, step_ms: float, top: int = 8) -> dict:
    """One more call of ``step`` under ``torch.profiler`` (not part of any
    timing or check): the device time its kernels took, summed (one
    stream, so they do not overlap), their share of ``step_ms`` (the
    unprofiled median step) and the kernels that took the most. A
    profiler that records no device time gives "not measured"."""
    from torch.profiler import ProfilerActivity, profile

    # only the profiler's own failures (no CUPTI on the machine) give "not
    # measured": a failure of the step itself propagates
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    try:
        prof.start()
    except RuntimeError as e:
        return {"device_ms": "not measured", "error": str(e)[:200]}
    stop_error = None
    try:
        step()
        torch.cuda.synchronize()
    finally:
        try:
            prof.stop()
        except RuntimeError as e:
            stop_error = str(e)[:200]
    if stop_error is not None:
        return {"device_ms": "not measured", "error": stop_error}
    from torch.autograd import DeviceType

    dev_us = lambda e: e.self_device_time_total
    # the kernels' own events (an operator's row repeats its kernels' time)
    events = [
        e for e in prof.key_averages()
        if e.device_type == DeviceType.CUDA and not e.is_user_annotation and dev_us(e) > 0
    ]
    total_ms = sum(dev_us(e) for e in events) / 1e3
    if not total_ms:
        return {"device_ms": "not measured"}
    events.sort(key=dev_us, reverse=True)
    return {
        "device_ms": total_ms, "device_busy_share": total_ms / step_ms,
        "device_launches": sum(e.count for e in events),
        "top": [{"name": e.key[:80], "ms": dev_us(e) / 1e3, "count": e.count} for e in events[:top]],
    }


def split_step(tr, batch) -> dict:
    """One optimizer step driven as ``Trainer.train_step`` composes it
    (``loss``, backward, ``apply_gradients``), the device synchronised
    between the three so that each is timed on the host clock."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    loss, _ = tr.loss(batch)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    loss.backward()
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    tr.apply_gradients()
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    return {"loss": float(loss), "forward_ms": (t1 - t0) * 1e3, "backward_ms": (t2 - t1) * 1e3,
            "optimizer_ms": (t3 - t2) * 1e3}


def train_flagship(ckpt, kernels):
    """Phase 4c: Trainer.train_step at full width on B = TRAIN_B × 10 s of
    random PCM with 200-token targets, TRAIN_STEPS steps on one batch."""
    from phones_las_torch.train.loop import Trainer
    from phones_las_torch.train.state import TrainConfig
    from phones_las_torch.utils.param_io import load_artifact

    device = None if DEV == "cuda" else DEV  # the entry points' default is CUDA
    params, cfg, _ = load_artifact(ckpt, device=device)
    tr = Trainer(cfg, TrainConfig(), device=device)
    tr.warm_start(params)
    del params
    rs = np.random.RandomState(0)  # as bench.py::bench_train
    n = int(SECONDS * SAMPLE_RATE)
    batch = {
        "audio": torch.from_numpy((rs.randn(TRAIN_B, n) * 2000).astype(np.float32)).to(DEV),
        "audio_lengths": torch.full((TRAIN_B,), n, dtype=torch.int32, device=DEV),
        "targets": torch.from_numpy(rs.randint(4, cfg.speller.vocab_size, (TRAIN_B, DECODE_STEPS))).to(DEV),
        "target_lengths": torch.full((TRAIN_B,), DECODE_STEPS, dtype=torch.int32, device=DEV),
    }
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    steps = []
    for i in range(TRAIN_STEPS):
        reset_counters(kernels)
        t0 = time.perf_counter()
        out = tr.train_step(batch)
        loss = float(out["loss"])
        torch.cuda.synchronize()
        steps.append({
            "step": i + 1, "loss": loss, "grad_norm": float(out["grad_norm"]),
            "ms": (time.perf_counter() - t0) * 1e3,
            "launches": {fn.__name__: fn.launches for fn in kernels},
        })
        emit({"phase": "4c", **steps[-1]})
    step_ms = statistics.median(s["ms"] for s in steps[1:])
    totals = {name: sum(s["launches"][name] for s in steps) for name in steps[0]["launches"]}
    profiled = profile_step(lambda: tr.train_step(batch), step_ms)
    splits = [split_step(tr, batch) for _ in range(SPLIT_STEPS)]
    med = lambda key: statistics.median(s[key] for s in splits)
    rec = {
        "phase": "4c", "shape": f"B={TRAIN_B} x {SECONDS} s, {DECODE_STEPS}-token targets, {TRAIN_STEPS} steps",
        "step_ms": step_ms, "timed_steps": f"2-{TRAIN_STEPS}",
        "forward_ms": med("forward_ms"), "backward_ms": med("backward_ms"),
        "optimizer_ms": med("optimizer_ms"), "split_steps": f"{TRAIN_STEPS + 2}-{TRAIN_STEPS + 1 + SPLIT_STEPS}",
        "split_losses": [s["loss"] for s in splits],
        "max_memory_allocated_gb": torch.cuda.max_memory_allocated() / 1e9,
        "losses": [s["loss"] for s in steps], "launches_total": totals,
        "prec": tr.prec, "card": card_line(), "device_profile": profiled,
    }
    emit(rec)
    losses = rec["losses"]
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        fail(f"training losses are not finite and falling: {losses}")
    for s in steps:
        la = s["launches"]
        if la["recurrence_residual"] != cfg.listener.num_layers or la["recurrence_bwd"] != cfg.listener.num_layers:
            fail(f"step {s['step']}: the residual and VJP kernels must launch once per listener layer: {la}")
        if la["bidir_recurrence"] != 0 or la["fused_logmel"] != 1:
            fail(f"step {s['step']}: unexpected launches under grad: {la}")
    return rec, totals


def drive_lstm_layer(params, kernels):
    """Phase 4d: the ops API, ``lstm_layer`` at the listener's first-layer
    width (T = 250), without grad (the ``recurrence`` kernel, both
    directions) and under grad (residual + VJP kernels, one direction)."""
    from phones_las_torch.ops.lstm import lstm_layer

    p = params.listener.layers[0][0]
    g = torch.Generator(device=DEV).manual_seed(7)
    t, d = 250, p.wx.shape[0]
    x = torch.randn((TRAIN_B, t, d), generator=g, device=DEV)
    lens = torch.randint(t // 2, t + 1, (TRAIN_B,), generator=g, device=DEV)
    reset_counters(kernels)
    with torch.no_grad():
        outs = [lstm_layer(p, x, lens, reverse=rev)[0] for rev in (False, True)]
    x.requires_grad_(True)
    out, (h, c) = lstm_layer(p, x, lens, reverse=True)
    (out.square().sum() + h.sum() + c.sum()).backward()
    torch.cuda.synchronize()
    launches = {fn.__name__: fn.launches for fn in kernels}
    finite = all(bool(torch.isfinite(v).all()) for v in (*outs, out, x.grad))
    rec = {"phase": "4d", "shape": f"lstm_layer B={TRAIN_B} T={t} D={d}", "finite": finite, "launches": launches}
    emit(rec)
    if not finite or not (launches["recurrence"] == 2 and launches["recurrence_residual"] == 1
                          and launches["recurrence_bwd"] == 1):
        fail(f"lstm_layer did not run its kernels as expected: {rec}")
    return launches


def sweep_forward_plans(params) -> None:
    """``--sweep``: the forward kernel under each plan at U = 256, T = 999."""
    from phones_las_torch.ops import lstm as L
    from phones_las_torch.ops.masking import length_mask

    t, u = 999, 256
    pf, pb = params.listener.layers[0]
    entry = "plt_lstm_recurrence"
    for b, nd in ((FLAGSHIP_B, 2), (TRAIN_B, 1)):
        g = torch.Generator(device=DEV).manual_seed(60)
        lengths = torch.randint(t // 2, t + 1, (b,), generator=g, device=DEV)
        mask = length_mask(lengths, t).transpose(0, 1).contiguous()
        xps = [torch.randn((t, b, 4 * u), generator=g, device=DEV) for _ in range(nd)]
        whs, rev = [pf.wh, pb.wh][:nd], [False, True][:nd]
        for prec in ("highest", "bf16"):
            want = L._launch_forward(entry, xps, mask, whs, 1.0, rev, prec)
            chosen = L._launch_forward.last_plan
            for c in (8, 16):
                for bt in L.ROW_TILES:
                    ks = L._ksplit(u, c, bt, prec == "bf16")
                    smem = L.forward_smem_bytes(u, c, bt, ks, True, prec == "bf16")
                    if smem > L.SMEM_MAX:
                        continue
                    plan = L.ForwardPlan(c, bt, ks, True, smem)
                    got = L._launch_forward(entry, xps, mask, whs, 1.0, rev, prec, plan)
                    torch.cuda.synchronize()
                    err, _, _ = compare([k[0] for k in got], [k[0] for k in want], 0.0, 0.0)
                    ms = time_ms(lambda: L._launch_forward(entry, xps, mask, whs, 1.0, rev, prec, plan), reps=5)
                    info = L.forward_kernel_info(u, prec == "bf16", False, c, bt, ks, True)
                    emit({
                        "sweep": "lstm forward", "shape": f"T={t} B={b} U={u} nd={nd} prec={prec}",
                        "cluster": c, "bt": bt, "ksplit": ks, "chosen": plan == chosen,
                        "clusters_launched": -(-b // bt) * nd, **info, "ms": ms, "us_per_step": ms * 1e3 / t,
                        "max_abs_diff_to_chosen_plan": err,
                    })


def vjp_cases(L, params, seed):
    """The VJP's arguments at the training shape (the listener's first layer,
    T = 999, B = TRAIN_B, both directions, random lengths and cotangents),
    once per precision → (prec, the arguments of ``L.recurrence_bwd``)."""
    from phones_las_torch.ops.masking import length_mask

    t, b = 999, TRAIN_B
    pf, pb = params.listener.layers[0]
    u = pf.units
    g = torch.Generator(device=DEV).manual_seed(seed)
    rnd = lambda *shape: torch.randn(shape, generator=g, device=DEV)
    lengths = torch.randint(t // 2, t + 1, (b,), generator=g, device=DEV)
    mask = length_mask(lengths, t).transpose(0, 1).contiguous()
    xps, whs, rev = [rnd(t, b, 4 * u) for _ in range(2)], [pf.wh.detach(), pb.wh.detach()], [False, True]
    cots = ([rnd(t, b, u) for _ in range(2)], [rnd(b, u) for _ in range(2)], [rnd(b, u) for _ in range(2)])
    for prec in ("highest", "bf16"):
        res = L.recurrence_residual(xps, mask, whs, 1.0, rev, prec)
        yield prec, (xps, mask, whs, [r[1] for r in res], [r[2] for r in res], *cots, 1.0, rev, prec)


def sweep_backward_plans(params) -> None:
    """``--sweep``: the VJP under each plan of its loop at U = 256, T = 999, B = TRAIN_B."""
    from phones_las_torch.ops import lstm as L

    t, u, b = 999, 256, TRAIN_B
    for prec, bargs in vjp_cases(L, params, seed=61):
        want = L.recurrence_bwd(*bargs)
        chosen = L._launch_backward.last_plan
        for c in (8, 16):
            for bt in L.ROW_TILES:
                ks = L._bwd_ksplit(u, c, bt, prec == "bf16")
                while ks > 1 and L.backward_smem_bytes(u, c, bt, ks, True, prec == "bf16") > L.SMEM_MAX:
                    ks //= 2
                smem = L.backward_smem_bytes(u, c, bt, ks, True, prec == "bf16")
                if smem > L.SMEM_MAX:
                    continue
                plan = L.BackwardPlan(c, bt, ks, True, smem)
                got = L._launch_backward(*bargs, plan=plan)
                torch.cuda.synchronize()
                err = max(rel_err(k, p) for kg, pg in zip(got, want) for k, p in zip(kg, pg))
                runs = []
                for _ in range(5):
                    ms = []
                    L._launch_backward(*bargs, plan=plan, part_ms=ms)
                    runs.append(ms[1])
                loop_ms = statistics.median(runs)
                emit({
                    "sweep": "lstm vjp loop", "shape": f"T={t} B={b} U={u} nd=2 prec={prec}",
                    "cluster": c, "bt": bt, "ksplit": ks, "chosen": plan == chosen,
                    "clusters_launched": -(-b // bt) * 2, **L.backward_kernel_info(u, prec == "bf16", plan),
                    "loop_ms": loop_ms, "us_per_step": loop_ms * 1e3 / t, "max_rel_diff_to_chosen_plan": err,
                })


def time_kernels(tree: str) -> None:
    """``--time-kernels DIR``: the two kernels a ``--compare`` is about, of
    the package in the checkout at DIR, through calls that every slice of
    the port since the training slice has."""
    sys.path.insert(0, tree)
    from phones_las_torch.frontend import features as F
    from phones_las_torch.frontend.fused_frontend import fused_logmel
    from phones_las_torch.ops import lstm as L
    from phones_las_torch.utils.param_io import load_artifact

    torch.set_grad_enabled(False)
    params, cfg, _ = load_artifact(os.path.join(ASSETS, "ckpt.npz"), device=None)
    audio = torch.from_numpy(make_audio(FLAGSHIP_B)).to(DEV)
    x = F.preemphasize(audio, cfg.frontend.preemphasis).contiguous()
    t_fe = F.frames_for_samples(x.shape[1], cfg.frontend)
    rec = {"tree": tree, "card": card_line(),
           "fused_logmel_ms": time_ms(lambda: fused_logmel(x, cfg.frontend, t_fe))}
    for prec, bargs in vjp_cases(L, params, seed=62):
        rec[f"recurrence_bwd_{prec}_ms"] = time_ms(lambda: L.recurrence_bwd(*bargs))
    emit(rec)


def compare_trees(other: str) -> int:
    """``--compare DIR``: ``--time-kernels`` of the checkout at DIR and of
    this one, in turns, each in its own process."""
    other = os.path.abspath(other)
    for tree in (other, REPO, REPO, other):
        run = subprocess.run([sys.executable, os.path.abspath(__file__), "--time-kernels", tree])
        if run.returncode:
            return run.returncode
    return 0


def reset_counters(kernels) -> None:
    for fn in kernels:
        fn.launches = 0


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    if sys.argv[1:2] == ["--compare"]:
        return compare_trees(sys.argv[2])
    if sys.argv[1:2] == ["--time-kernels"]:
        time_kernels(sys.argv[2])
        return 0
    sys.path.insert(0, REPO)
    from phones_las_torch.csrc import _build
    from phones_las_torch.decode.fused_greedy import greedy_decode_fused
    from phones_las_torch.decode.greedy import greedy_decode
    from phones_las_torch.frontend.fused_frontend import fused_logmel
    from phones_las_torch.models.las import encode, featurize
    from phones_las_torch.models.listener import listen
    from phones_las_torch.ops.lstm import bidir_recurrence, recurrence, recurrence_bwd, recurrence_residual
    from phones_las_torch.ops.masking import length_mask
    from phones_las_torch.utils.device import set_parity_mode
    from phones_las_torch.utils.metrics import edit_distance_stats, per_from_stats
    from phones_las_torch.utils.param_io import load_artifact

    serve_kernels = (fused_logmel, bidir_recurrence, greedy_decode_fused)
    train_kernels = (recurrence, recurrence_residual, recurrence_bwd)
    kernels = serve_kernels + train_kernels
    serving_ran_only_its_kernels = lambda la: (
        all(la[fn.__name__] for fn in serve_kernels) and not any(la[fn.__name__] for fn in train_kernels)
    )
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
    if sys.argv[1:] == ["--sweep"]:
        sweep_forward_plans(params)
        sweep_backward_plans(params)
        print(card, flush=True)
        return 0

    # ---- phase 1: each kernel against its plain version, at main-path shapes
    audio64 = torch.from_numpy(make_audio(FLAGSHIP_B)).to(DEV)
    full_len = torch.full((FLAGSHIP_B,), audio64.shape[1], dtype=torch.int32, device=DEV)
    fe_rec = check_frontend(cfg.frontend, audio64)
    data = np.load(os.path.join(ASSETS, "eval_set.npz"), allow_pickle=False)
    check_frontend(cfg.frontend, torch.from_numpy(data["audio"]).to(DEV), "the eval set")
    # a window of 401 samples (padded to 416 rows) under a hop of 161: the
    # frames' samples are not 8-byte aligned in the staged window
    odd = dataclasses.replace(cfg.frontend, win_ms=25.0625, hop_ms=10.0625, window="hamming")
    check_frontend(odd, audio64[:3, :20000], "odd window and hop")
    # longer transforms, whose power tile leaves room for fewer frames a block
    for nfft, tile in ((1024, 32), (2048, 16)):
        long_fft = dataclasses.replace(cfg.frontend, nfft=nfft, win_ms=40.0)
        rec = check_frontend(long_fft, audio64[:3, :40000], f"nfft {nfft}")
        if rec["frame_tile"] != tile:
            fail(f"the front-end kernel took an unexpected frame tile at nfft {nfft}: {rec}")
    lstm_recs = [
        check_bilstm(params, FLAGSHIP_B, t, layer, prec, seed=10 + i)
        for i, (t, layer, prec) in enumerate(LSTM_CASES)
    ]
    for i, (t, b, u) in enumerate(RAGGED_LSTM):
        check_lstm_ragged(t, b, u, seed=40 + i)
    memory, _, enc_mask = encode(params, cfg, audio64, full_len)
    dec_recs = [check_greedy(params, cfg, memory, enc_mask, b) for b in DECODER_BATCHES]
    # a batch that is no multiple of the group, rows of very different lengths
    g = torch.Generator(device=DEV).manual_seed(50)
    t_enc = memory.shape[1]
    rag_len = torch.randint(1, t_enc + 1, (RAGGED_DECODER_B,), generator=g, device=DEV)
    rag_len[0], rag_len[1] = t_enc, 1
    check_greedy(params, cfg, memory, length_mask(rag_len, t_enc), RAGGED_DECODER_B,
                 steps=RAGGED_DECODER_STEPS, timed=False)

    # ---- phase 2: the committed checkpoint on the committed eval set
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
    if not serving_ran_only_its_kernels(launches):
        fail(f"a kernel of the main path never launched, or a training kernel did: {launches}")

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
    if not serving_ran_only_its_kernels(flag_launches):
        fail(f"a kernel of the main path never launched at the flagship shape, or a training kernel did: {flag_launches}")
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

    # ---- phase 4: the training slice, under grad
    with torch.enable_grad():
        train_recs = [
            check_lstm_train(params, t, layer, prec, seed=20 + i)
            for i, (t, layer, prec) in enumerate(LSTM_CASES)
        ]
        for i, (t, b, u) in enumerate(RAGGED_LSTM):
            check_lstm_bwd_ragged(t, b, u, seed=70 + i)
        check_train_step(ckpt, data, kernels)
        _, train_launches = train_flagship(ckpt, kernels)
        api_launches = drive_lstm_layer(params, kernels)

    def kernel_entry(name, source, replaces, rec, n_launches):
        return {
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": n_launches, "max_abs_err": rec["max_abs_err"],
            "ms": rec["ms"], "plain_ms": rec["plain_ms"], "bound_ms": rec["bound_ms"],
            "bound_by": rec["bound_by"], "library_ms": rec["library_ms"],
        }

    lstm_cu = "phones_las_torch/csrc/lstm.cu"
    emit({"kernels": [
        kernel_entry("fused_logmel", "phones_las_torch/csrc/frontend.cu",
                     "phones_las_tpu/frontend/pallas_frontend.py:110", fe_rec, launches["fused_logmel"]),
        kernel_entry("bidir_recurrence", lstm_cu,
                     "phones_las_tpu/ops/lstm.py:269", lstm_recs[0], launches["bidir_recurrence"]),
        kernel_entry("greedy_decode_fused", "phones_las_torch/csrc/greedy.cu",
                     "phones_las_tpu/decode/pallas_greedy.py:134", dec_recs[-1], launches["greedy_decode_fused"]),
        # the unidirectional primal runs on no model path: its launches are
        # the ops API's (phase 4d); the other two the training run's (4c)
        kernel_entry("recurrence", lstm_cu, "phones_las_tpu/ops/lstm.py:164",
                     train_recs[0][0], api_launches["recurrence"]),
        kernel_entry("recurrence_residual", lstm_cu, "phones_las_tpu/ops/lstm.py:485",
                     train_recs[0][1], train_launches["recurrence_residual"]),
        kernel_entry("recurrence_bwd", lstm_cu, "phones_las_tpu/ops/lstm.py:536",
                     train_recs[0][2], train_launches["recurrence_bwd"]),
    ]})
    print(card, flush=True)
    emit({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }})
    return 0


if __name__ == "__main__":
    sys.exit(main())
