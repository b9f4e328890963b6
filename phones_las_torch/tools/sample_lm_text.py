"""Sample fresh sentences from the speechlike phonotactic model
(counterpart of ``tools/sample_lm_text.py``, the same text for the same
seeds).

Writes one utterance per line (space-separated phone tokens, PAUSE
markers dropped: they are acoustic-only, never labels), for training a
shallow-fusion LM whose text corpus far exceeds the paired audio.

    python -m phones_las_torch.tools.sample_lm_text --out lm_text.txt --n 20000 \\
        --syllables 14 28 --words 1 3
"""
import argparse

import numpy as np

from phones_las_torch.data.speechlike import PAUSE, make_phonotactics, sample_sentence


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--out", required=True)
    p.add_argument("--n", type=int, default=20000)
    p.add_argument("--seed", type=int, default=99)
    p.add_argument("--phonotactics-seed", type=int, default=1234,
                   help="must match the corpus' language seed")
    p.add_argument("--syllables", type=int, nargs=2, default=(2, 6))
    p.add_argument("--words", type=int, nargs=2, default=None)
    args = p.parse_args(argv)

    model = make_phonotactics(args.phonotactics_seed)
    rng = np.random.RandomState(args.seed)
    with open(args.out, "w") as f:
        for _ in range(args.n):
            seq = sample_sentence(
                rng, model, tuple(args.syllables),
                word_syllables=tuple(args.words) if args.words else None,
            )
            f.write(" ".join(t for t in seq if t != PAUSE) + "\n")
    print(f"wrote {args.n} sentences to {args.out}")


if __name__ == "__main__":
    main()
