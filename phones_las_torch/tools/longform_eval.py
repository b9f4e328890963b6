"""Long-form stitching PER on fresh speechlike streams (counterpart of
``tools/longform_eval.py``, the same streams for the same seeds).

Synthesizes N continuous streams of ``--stream-syllables`` syllables
(~60 s+ each at the long-corpus word and pause settings) from the same
phonotactic language as the training corpus, runs
``Transcriber.transcribe_long`` of the port over each on ``--device``,
and reports the stitched PER against the true phone sequence.

    python -m phones_las_torch.tools.longform_eval --workdir runs/long_base \\
        --streams 4 --stream-syllables 170 --window 8 --overlap 2
"""
import argparse
from typing import Iterator, Sequence

import numpy as np

from phones_las_torch.cli.common import add_device_arg
from phones_las_torch.data.speechlike import (
    make_phonotactics,
    speechlike_phone_inventory,
    synth_speech_utterance,
)
from phones_las_torch.data.vocab import Vocab
from phones_las_torch.utils.metrics import _edit_distance


def synth_streams(n: int, syllables: int, words: Sequence[int], seed: int, phonotactics_seed: int,
                  snr_db: Sequence[float]) -> Iterator:
    """The ``n`` evaluation streams (``data.records.Utterance``s with
    their phone targets and token times), drawn in order from one
    ``RandomState(seed)``, one at a time."""
    vocab = Vocab(speechlike_phone_inventory())
    model = make_phonotactics(phonotactics_seed)
    rng = np.random.RandomState(seed)
    for i in range(n):
        yield synth_speech_utterance(
            rng, vocab, f"stream-{i}", model=model,
            n_syllables_range=(syllables, syllables),
            word_syllables=tuple(words),
            snr_db_range=tuple(snr_db),
        )


def stream_args(p: argparse.ArgumentParser, window_default) -> None:
    """The stream and window flags both long-form tools share."""
    p.add_argument("--workdir", required=True)
    p.add_argument("--streams", type=int, default=4)
    p.add_argument("--stream-syllables", type=int, default=170)
    p.add_argument("--words", type=int, nargs=2, default=(1, 3))
    p.add_argument("--seed", type=int, default=31)
    p.add_argument("--phonotactics-seed", type=int, default=1234)
    p.add_argument("--window", type=float, default=window_default,
                   help="segment seconds" + ("" if window_default else " (default: auto from the "
                                             "model's training buckets, pause mode)"))
    p.add_argument("--overlap", type=float, default=2.0)
    p.add_argument("--snr-db", type=float, nargs=2, default=(8.0, 30.0))
    add_device_arg(p)


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    stream_args(p, None)
    p.add_argument("--segmentation", choices=("pause", "overlap"),
                   default="pause")
    p.add_argument("--adapt-cmvn", action="store_true",
                   help="per-stream CMVN (speaker adaptation)")
    p.add_argument("--beam-width", type=int, default=None)
    p.add_argument("--ctc-joint", type=float, default=None)
    args = p.parse_args(argv)

    from phones_las_torch.api import Transcriber

    vocab = Vocab(speechlike_phone_inventory())
    t = Transcriber(args.workdir, beam_width=args.beam_width,
                    ctc_joint=args.ctc_joint, device=args.device)
    streams = synth_streams(args.streams, args.stream_syllables, args.words, args.seed,
                            args.phonotactics_seed, args.snr_db)

    errs = tokens = 0
    total_audio = 0.0
    ids = {tok: j for j, tok in enumerate(vocab.tokens)}
    for i, u in enumerate(streams):
        ref = vocab.decode(u.targets)
        hyp = t.transcribe_long(
            u.audio, window_seconds=args.window,
            overlap_seconds=args.overlap, segmentation=args.segmentation,
            adapt_cmvn=args.adapt_cmvn,
        )
        e = _edit_distance([ids[x] for x in hyp], [ids[x] for x in ref])
        errs += e
        tokens += len(ref)
        total_audio += len(u.audio) / 16000.0
        print(f"stream {i}: {len(u.audio)/16000.0:.1f}s audio, "
              f"{len(ref)} ref tokens, {len(hyp)} hyp, PER {e/len(ref):.4f}")
    print(f"TOTAL: {args.streams} streams, {total_audio:.0f}s audio, "
          f"{tokens} tokens, stitched PER {errs/tokens:.4f}")


if __name__ == "__main__":
    main()
