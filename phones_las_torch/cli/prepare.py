"""Data preparation CLI (port of ``phones_las_tpu/cli/prepare.py``): record
files, vocabularies and CMVN stats for a corpus. The CMVN pass runs the
front-end kernel, and ``--g2p-model`` the seq2seq G2P, on the card
(``--device cpu``: the plain path).

    python -m phones_las_torch.cli.prepare speechlike --out data/spl --n-utts 256
    python -m phones_las_torch.cli.prepare timit --root /data/TIMIT --out data/timit
    python -m phones_las_torch.cli.prepare librispeech --root /data/LibriSpeech --out data/ls \
        --targets phone --g2p-model bundled
    python -m phones_las_torch.cli.prepare common_voice --root /data/cv --out data/cv --langs en es it
"""

from __future__ import annotations

import argparse
import os

from phones_las_torch.cli.common import add_device_arg


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    sub = p.add_subparsers(dest="corpus", required=True)

    t = sub.add_parser("timit")
    t.add_argument("--root", required=True)
    t.add_argument("--out", required=True)
    t.add_argument("--arpabet", action="store_true",
                   help="keep ARPAbet labels instead of IPA (--output_ipa off)")
    t.add_argument("--include-sa", action="store_true")

    l = sub.add_parser("librispeech")
    l.add_argument("--root", required=True)
    l.add_argument("--out", required=True)
    l.add_argument("--splits", nargs="+",
                   default=["train-clean-100", "dev-clean", "test-clean"])
    l.add_argument("--targets", choices=["char", "phone"], default="char")
    l.add_argument("--g2p-model", default=None,
                   help="seq2seq G2P .npz (cli.g2p train) for phone "
                        "targets; rules remain the OOV fallback")

    c = sub.add_parser("common_voice")
    c.add_argument("--root", required=True)
    c.add_argument("--out", required=True)
    c.add_argument("--langs", nargs="+", required=True)
    c.add_argument("--tsv", default="validated.tsv")
    c.add_argument("--max-per-lang", type=int, default=None)
    c.add_argument("--g2p-model", default=None,
                   help="seq2seq G2P .npz, applied to EN text only")

    for sp in (t, l, c):
        sp.add_argument("--cmvn-utts", type=int, default=500,
                        help="utterances for global CMVN stats; 0 = whole "
                             "corpus (exact Σx/Σx², reference semantics)")

    s = sub.add_parser("synthetic")
    s.add_argument("--out", required=True)
    s.add_argument("--n-utts", type=int, default=128)
    s.add_argument("--n-phones", type=int, default=10)
    s.add_argument("--graphemes", action="store_true",
                   help="also emit spelled-out grapheme targets + vocab "
                        "(enables multitask presets on the synthetic corpus)")
    s.add_argument("--max-phones-per-utt", type=int, default=8,
                   help="upper bound of the per-utterance phone count")

    sl = sub.add_parser(
        "speechlike",
        help="formant-synthesized hard corpus (coarticulation, "
             "phonotactics, speaker variation, noise); see data/speechlike.py",
    )
    sl.add_argument("--out", required=True)
    sl.add_argument("--n-utts", type=int, default=256)
    sl.add_argument("--seed", type=int, default=0)
    sl.add_argument("--snr-db", type=float, nargs=2, default=[8.0, 30.0])
    sl.add_argument("--syllables", type=int, nargs=2, default=[2, 6])
    sl.add_argument("--words", type=int, nargs=2, default=None,
                    metavar=("LO", "HI"),
                    help="sentence mode: group syllables into words of "
                         "LO-HI syllables with inter-word silences")
    sl.add_argument("--graphemes", action="store_true")

    for sp in (t, l, c, s, sl):
        add_device_arg(sp)
    args = p.parse_args(argv)
    cmvn_utts = getattr(args, "cmvn_utts", 500) or None  # 0 → None → all
    from phones_las_torch.data.prep_common import finalize_split_dir
    from phones_las_torch.data.vocab import Vocab

    if args.corpus == "timit":
        from phones_las_torch.data.timit import prepare_timit

        prepare_timit(args.root, args.out, output_ipa=not args.arpabet,
                      include_sa=args.include_sa, cmvn_max_utts=cmvn_utts, device=args.device)
    elif args.corpus == "librispeech":
        from phones_las_torch.data.librispeech import prepare_librispeech

        prepare_librispeech(args.root, args.out, splits=tuple(args.splits), g2p_model=args.g2p_model,
                            targets=args.targets, cmvn_max_utts=cmvn_utts, device=args.device)
    elif args.corpus == "common_voice":
        from phones_las_torch.data.common_voice import prepare_common_voice

        prepare_common_voice(args.root, args.out, args.langs, tsv=args.tsv, g2p_model=args.g2p_model,
                             max_per_lang=args.max_per_lang, cmvn_max_utts=cmvn_utts, device=args.device)
    elif args.corpus == "speechlike":
        from phones_las_torch.data.speechlike import speechlike_grapheme_inventory, write_speechlike_corpus

        os.makedirs(args.out, exist_ok=True)
        kw = dict(
            snr_db_range=tuple(args.snr_db),
            n_syllables_range=tuple(args.syllables),
            graphemes=args.graphemes,
            word_syllables=tuple(args.words) if args.words else None,
        )
        _, vocab = write_speechlike_corpus(
            os.path.join(args.out, "train.plu"), n_utts=args.n_utts, seed=args.seed, **kw,
        )
        write_speechlike_corpus(
            os.path.join(args.out, "test.plu"), n_utts=max(args.n_utts // 4, 16), seed=args.seed + 1, **kw,
        )
        finalize_split_dir(
            args.out, vocab,
            grapheme_vocab=Vocab(speechlike_grapheme_inventory()) if args.graphemes else None,
            cmvn_from=os.path.join(args.out, "train.plu"), meta={"corpus": "speechlike"}, device=args.device,
        )
    else:
        from phones_las_torch.data.synthetic import synth_grapheme_inventory, write_synth_corpus

        os.makedirs(args.out, exist_ok=True)
        rng = (3, args.max_phones_per_utt)
        _, vocab = write_synth_corpus(
            os.path.join(args.out, "train.plu"), n_utts=args.n_utts, n_phones=args.n_phones,
            graphemes=args.graphemes, n_phones_range=rng,
        )
        write_synth_corpus(
            os.path.join(args.out, "test.plu"), n_utts=max(args.n_utts // 4, 8), n_phones=args.n_phones,
            seed=1, graphemes=args.graphemes, n_phones_range=rng,
        )
        finalize_split_dir(
            args.out, vocab,
            grapheme_vocab=Vocab(synth_grapheme_inventory()) if args.graphemes else None,
            cmvn_from=os.path.join(args.out, "train.plu"), meta={"corpus": "synthetic"}, device=args.device,
        )


if __name__ == "__main__":
    main()
