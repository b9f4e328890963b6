"""Train an n-gram LM over corpus transcripts for shallow-fusion beam
decoding (port of ``phones_las_tpu/cli/lm.py``; the file format is the
reference's, so either package reads it). Host only: numpy counts.

    python -m phones_las_torch.cli.lm --data data/timit --out data/timit/lm.npz
    python -m phones_las_torch.cli.infer ... --lm data/timit/lm.npz --lm-weight 0.3
"""

from __future__ import annotations

import argparse
import glob
import os
import sys


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--data", required=True,
                   help="a prepared data dir (uses train*.plu) or .plu file(s)")
    p.add_argument("--text", default=None,
                   help="train on this plain-text file instead of the .plu "
                        "transcripts (one utterance per line, space-separated "
                        "tokens; --data still supplies the vocab)")
    p.add_argument("--out", required=True, help="output .npz path")
    p.add_argument("--order", type=int, default=3, choices=[2, 3])
    p.add_argument("--head", default="phone", choices=["phone", "grapheme"],
                   help="which target stream to model")
    p.add_argument("--interp", type=float, default=0.8,
                   help="interpolation weight toward the higher-order ML estimate")
    p.add_argument("--add-k", type=float, default=0.5, help="unigram add-k smoothing")
    args = p.parse_args(argv)

    import numpy as np

    from phones_las_torch.data.records import RecordReader
    from phones_las_torch.data.vocab import Vocab
    from phones_las_torch.decode.lm import fit_ngram_lm, save_lm

    if os.path.isdir(args.data):
        paths = sorted(glob.glob(os.path.join(args.data, "train*.plu")))
        vocab_file = os.path.join(args.data, "grapheme_vocab.txt" if args.head == "grapheme" else "vocab.txt")
    else:
        paths = [args.data]
        vocab_file = os.path.join(os.path.dirname(args.data), "vocab.txt")
    if not (args.text or paths):
        p.error(f"no train records under {args.data}")
    vocab = Vocab.load(vocab_file)

    seqs = []
    if args.text:
        n_unk = n_tok = 0
        with open(args.text) as f:
            for line in f:
                toks = line.split()
                if toks:
                    ids = vocab.encode(toks)
                    n_tok += len(ids)
                    n_unk += sum(i == vocab.unk_id for i in ids)
                    seqs.append(np.asarray(ids, np.int32))
        if n_unk:
            # silent <unk> mass would put LM probability on transitions
            # that never occur at decode time
            print(f"WARNING: {n_unk}/{n_tok} tokens in {args.text} are not in {vocab_file} "
                  "and were mapped to <unk>", file=sys.stderr)
            if n_unk >= n_tok // 2:
                p.error("more than half the --text tokens are out-of-vocab; the text "
                        "file's token convention does not match the vocab")
    else:
        for path in paths:
            for utt in RecordReader(path):
                t = utt.grapheme_targets if args.head == "grapheme" else utt.targets
                if t is not None and len(t):
                    seqs.append(np.asarray(t))
    if not seqs:
        p.error("no transcripts found")
    logp = fit_ngram_lm(
        seqs, len(vocab), vocab.sos_id, vocab.eos_id, order=args.order, interp=args.interp, add_k=args.add_k,
    )
    # held-in perplexity as a sanity number
    ll = n = 0.0
    for seq in seqs[:2000]:
        ctx2 = ctx1 = vocab.sos_id
        for w in list(map(int, seq)) + [vocab.eos_id]:
            ll += logp[ctx2, ctx1, w] if args.order == 3 else logp[ctx1, w]
            n += 1
            ctx2, ctx1 = ctx1, w
    save_lm(args.out, logp, vocab.tokens)
    print(f"{args.out}: order={args.order} vocab={len(vocab)} "
          f"sequences={len(seqs)} train ppl={np.exp(-ll / max(n, 1)):.2f}")


if __name__ == "__main__":
    main()
