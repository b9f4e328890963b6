"""Diagnose long-form stitching error sources (counterpart of
``tools/longform_debug.py``).

Separates the three possible culprits behind the stitched PER:

  1. *decode quality*: is each window transcribed correctly in isolation?
     (window hyp against the true tokens inside the window, using the
     synthesizer's exact per-phone sample spans)
  2. *timestamp quality*: are the attention-peak timestamps close to the
     true acoustic centers? (edit-align window hyp to window ref, report
     |predicted - true| for matched tokens)
  3. *cut logic*: does the overlap-midpoint assignment drop or duplicate
     tokens at boundaries? (per-region PER against the tokens the region
     truly owns; boundary-local error concentration)

Uses the same streams as ``longform_eval`` (same seeds).

    python -m phones_las_torch.tools.longform_debug --workdir runs/L_mono_ctc --streams 1
"""
import argparse
import collections

import numpy as np

from phones_las_torch.tools.longform_eval import stream_args, synth_streams
from phones_las_torch.utils.metrics import _edit_distance


def edit_align(hyp, ref):
    """Levenshtein backtrace → list of (op, hyp_idx, ref_idx)."""
    H, R = len(hyp), len(ref)
    d = np.zeros((H + 1, R + 1), np.int32)
    d[:, 0] = np.arange(H + 1)
    d[0, :] = np.arange(R + 1)
    for i in range(1, H + 1):
        for j in range(1, R + 1):
            sub = d[i - 1, j - 1] + (hyp[i - 1] != ref[j - 1])
            d[i, j] = min(sub, d[i - 1, j] + 1, d[i, j - 1] + 1)
    ops = []
    i, j = H, R
    while i > 0 or j > 0:
        if i > 0 and j > 0 and d[i, j] == d[i - 1, j - 1] + (
            hyp[i - 1] != ref[j - 1]
        ):
            ops.append(("match" if hyp[i - 1] == ref[j - 1] else "sub",
                        i - 1, j - 1))
            i, j = i - 1, j - 1
        elif i > 0 and d[i, j] == d[i - 1, j] + 1:
            ops.append(("ins", i - 1, None))
            i -= 1
        else:
            ops.append(("del", None, j - 1))
            j -= 1
    return ops[::-1]


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    stream_args(p, 8.0)
    args = p.parse_args(argv)

    from phones_las_torch.api import Transcriber, merge_window_hypotheses

    t = Transcriber(args.workdir, device=args.device)
    sr = t.sample_rate
    win = int(args.window * sr)
    ov = int(args.overlap * sr)
    hop = win - ov

    tot = collections.Counter()
    ts_errs = []
    streams = synth_streams(args.streams, args.stream_syllables, args.words, args.seed,
                            args.phonotactics_seed, args.snr_db)
    for si, u in enumerate(streams):
        ref_ids = list(u.targets)
        centers = u.token_times.mean(axis=1)  # true acoustic centers [N]
        starts = list(range(0, u.audio.shape[0] - ov, hop))
        decoded = t.decode_aligned(
            [u.audio[s: s + win] for s in starts], window_samples=win
        )
        per_window = [
            (ids, s0 + times) for s0, (ids, times) in zip(starts, decoded)
        ]
        print(f"=== stream {si}: {u.audio.shape[0]/sr:.1f}s, "
              f"{len(ref_ids)} ref tokens, {len(starts)} windows ===")
        n = len(per_window)
        for i, (ids, times) in enumerate(per_window):
            s0 = starts[i]
            lo = -np.inf if i == 0 else starts[i] + ov / 2.0
            hi = np.inf if i == n - 1 else starts[i + 1] + ov / 2.0
            # (1) decode quality: everything the window can see
            w_ref_idx = [k for k, c in enumerate(centers)
                         if s0 <= c < s0 + win]
            w_ref = [ref_ids[k] for k in w_ref_idx]
            e_dec = _edit_distance(list(map(int, ids)), w_ref)
            # (2) timestamps: align and compare times of matches
            ops = edit_align(list(map(int, ids)), w_ref)
            m_err = []
            for op, hi_, rj in ops:
                if op == "match":
                    m_err.append(abs(times[hi_] - centers[w_ref_idx[rj]]) / sr)
                else:
                    # error position: seconds from the nearest window edge
                    tm = (times[hi_] if hi_ is not None
                          else centers[w_ref_idx[rj]])
                    d = min(tm - s0, s0 + win - tm) / sr
                    tot[f"err_edge_{min(int(d), 4)}s"] += 1
            # (3) cut logic: region-owned tokens
            r_ref = [ref_ids[k] for k in range(len(ref_ids))
                     if lo <= centers[k] < hi]
            r_hyp = [int(tok) for tok, tm in zip(ids, times) if lo <= tm < hi]
            e_cut = _edit_distance(r_hyp, r_ref)
            ms = np.asarray(m_err) * 1000 if m_err else np.asarray([0.0])
            print(f"  w{i:02d} [{s0/sr:6.1f}s+{args.window:.0f}] "
                  f"hyp={len(ids):3d} see_ref={len(w_ref):3d} "
                  f"dec_err={e_dec:3d} | own_ref={len(r_ref):3d} "
                  f"own_hyp={len(r_hyp):3d} cut_err={e_cut:3d} | "
                  f"ts_err ms p50={np.percentile(ms,50):5.0f} "
                  f"p90={np.percentile(ms,90):5.0f} max={ms.max():5.0f}")
            tot["dec_err"] += e_dec
            tot["cut_err"] += e_cut
            tot["see_ref"] += len(w_ref)
            tot["own_ref"] += len(r_ref)
            ts_errs += m_err
        merged = merge_window_hypotheses(per_window, starts, ov)
        e = _edit_distance(merged, ref_ids)
        tot["stitch_err"] += e
        tot["ref"] += len(ref_ids)
        print(f"  stream stitched PER {e/len(ref_ids):.4f} "
              f"({e}/{len(ref_ids)})")

    ms = np.asarray(ts_errs) * 1000
    print("\n=== totals ===")
    print(f"stitched PER        {tot['stitch_err']/tot['ref']:.4f}")
    print(f"within-window decode PER (vs visible ref) "
          f"{tot['dec_err']/max(tot['see_ref'],1):.4f}")
    print(f"region-cut PER (sum of per-region edits) "
          f"{tot['cut_err']/max(tot['own_ref'],1):.4f}")
    print(f"timestamp |err| ms: p50={np.percentile(ms,50):.0f} "
          f"p90={np.percentile(ms,90):.0f} p99={np.percentile(ms,99):.0f} "
          f"max={ms.max():.0f} (n={len(ms)})")
    print("decode-error position histogram (s from nearest window edge):",
          {k: tot[k] for k in sorted(tot) if k.startswith("err_edge")})


if __name__ == "__main__":
    main()
