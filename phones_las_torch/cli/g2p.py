"""G2P CLI (port of ``phones_las_tpu/cli/g2p.py``): train and apply the
seq2seq grapheme → phoneme model on the card (``--device cpu``: the plain
PyTorch path).

    # train on the bundled expanded lexicon (optionally with your own pairs)
    python -m phones_las_torch.cli.g2p train --out runs/g2p_en.npz

    # apply: words (or a text file) → IPA
    python -m phones_las_torch.cli.g2p apply --model runs/g2p_en.npz hello world

The model file is the reference's format (either package reads the
other's). A trained model plugs into corpus prep through ``prepare
librispeech|common_voice --g2p-model`` and into ``data.g2p.text_to_ipa(
model=...)``; words it cannot handle (digits, foreign characters) keep the
rule tables.
"""

from __future__ import annotations

import argparse

from phones_las_torch.cli.common import add_device_arg


def read_extra_lexicon(path: str, lex: dict, log=print) -> None:
    """Add the ``word: p h o n e s`` lines of ``path`` to ``lex``, keyed by
    the lower-cased word (the form ``normalize_text`` looks up); words with
    characters outside the G2P alphabet are skipped with a message."""
    from phones_las_torch.models.g2p_model import G2P_CHARS

    allowed = set(G2P_CHARS)
    with open(path) as f:
        for lineno, line in enumerate(f, 1):
            word, _, phones = line.partition(":")
            word = word.strip().lower()
            if not phones.split() or not word:
                continue
            bad = set(word) - allowed
            if bad:
                log(f"--extra-lexicon:{lineno}: skipping {word!r} (chars outside the G2P alphabet: {sorted(bad)})")
                continue
            lex[word] = tuple(phones.split())


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = p.add_subparsers(dest="cmd", required=True)

    tr = sub.add_parser("train", help="train on the bundled expanded lexicon")
    tr.add_argument("--out", required=True, help="output .npz model path")
    tr.add_argument("--steps", type=int, default=1200)
    tr.add_argument("--batch-size", type=int, default=256)
    tr.add_argument("--learning-rate", type=float, default=2e-3)
    tr.add_argument("--seed", type=int, default=0)
    tr.add_argument("--extra-lexicon", default=None,
                    help="extra training pairs: 'word: p h o n e s' lines")

    ap = sub.add_parser("apply", help="words → IPA")
    ap.add_argument("--model", required=True)
    ap.add_argument("--beam-width", type=int, default=4)
    ap.add_argument("--text", default=None, help="file of words/sentences")
    ap.add_argument("words", nargs="*")

    for sp in (tr, ap):
        add_device_arg(sp)
    args = p.parse_args(argv)

    if args.cmd == "train":
        from phones_las_torch.data.lexicon_en import expanded_lexicon
        from phones_las_torch.models.g2p_model import save_g2p, train_g2p

        lex = expanded_lexicon()
        if args.extra_lexicon:
            read_extra_lexicon(args.extra_lexicon, lex)
        params, cfg, vc, vp = train_g2p(
            lex, steps=args.steps, batch_size=args.batch_size, learning_rate=args.learning_rate,
            seed=args.seed, log_every=max(args.steps // 10, 1), device=args.device,
        )
        save_g2p(args.out, params, cfg, vc, vp)
        print(f"{args.out}: trained on {len(lex)} pairs, {len(vp)} phone tokens")
    else:
        from phones_las_torch.data.g2p import normalize_text
        from phones_las_torch.models.g2p_model import NeuralG2P

        model = NeuralG2P(args.model, beam_width=args.beam_width, device=args.device)
        words = list(args.words)
        if args.text:
            with open(args.text) as f:
                for line in f:
                    words += normalize_text(line)
        out = model.lookup(words)
        for w in words:
            print(f"{w}\t{' '.join(out.get(w, ['<no-model-coverage>']))}")


if __name__ == "__main__":
    main()
