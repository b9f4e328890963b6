"""PER + derailment breakdown for an infer TSV against its test records
(counterpart of ``tools/decode_stats.py``, the same output).

Long-utterance LAS decodes fail by *derailing*: the attention loses its
place and the decoder emits insertion loops until the step cap. This
splits the PER into that failure mode and the well-behaved rest.

    python -m phones_las_torch.tools.decode_stats --tsv runs/L_base_greedy.tsv \\
        --records runs/long_data/test.plu [--cap 84]
"""

import argparse
import os
import sys

from phones_las_torch.data.records import RecordReader
from phones_las_torch.data.vocab import Vocab
from phones_las_torch.utils.metrics import _edit_distance


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--tsv", required=True)
    p.add_argument("--records", required=True)
    p.add_argument("--vocab", default=None,
                   help="vocab.txt the records were written with (default: "
                        "vocab.txt next to --records)")
    p.add_argument("--cap", type=int, default=None,
                   help="decode step cap used by infer; hyps within "
                        "--cap-margin of it count as derailed (infer strips "
                        "special tokens, so a capped hyp can be shorter "
                        "than the cap)")
    p.add_argument("--cap-margin", type=int, default=2)
    p.add_argument("--slack", type=int, default=15,
                   help="hyp len ≥ ref len + slack counts as derailed")
    args = p.parse_args(argv)

    vocab_path = args.vocab or os.path.join(
        os.path.dirname(os.path.abspath(args.records)), "vocab.txt"
    )
    if not os.path.exists(vocab_path):
        sys.exit(f"decode_stats: no vocab at {vocab_path} — pass --vocab")
    vocab = Vocab.load(vocab_path)
    ids = {t: i for i, t in enumerate(vocab.tokens)}
    refs = {u.utt_id: vocab.decode(u.targets) for u in RecordReader(args.records)}

    n = derailed = errs = toks = errs_ok = toks_ok = 0
    for line in open(args.tsv):
        if line.startswith("#"):
            continue
        uid, _, hyp_s = line.rstrip("\n").partition("\t")
        hyp = hyp_s.split() if hyp_s else []
        if uid not in refs:
            sys.exit(f"decode_stats: uid {uid!r} in TSV but not in "
                     f"{args.records} — wrong --records for this TSV?")
        ref = refs[uid]
        unknown = [x for x in hyp + ref if x not in ids]
        if unknown:
            sys.exit(f"decode_stats: token {unknown[0]!r} not in "
                     f"{vocab_path} — wrong --vocab for this run?")
        e = _edit_distance([ids[x] for x in hyp], [ids[x] for x in ref])
        errs += e
        toks += len(ref)
        n += 1
        if len(hyp) >= len(ref) + args.slack or (
            args.cap and len(hyp) >= args.cap - args.cap_margin
        ):
            derailed += 1
        else:
            errs_ok += e
            toks_ok += len(ref)
    if n == 0:
        sys.exit(f"decode_stats: no hypotheses in {args.tsv}")
    print(f"utts={n} derailed={derailed} ({derailed/n:.1%})")
    print(f"PER {errs/toks:.4f}; PER excluding derailed "
          f"{errs_ok/toks_ok if toks_ok else float('nan'):.4f}")


if __name__ == "__main__":
    main()
