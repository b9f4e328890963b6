"""Transcribe audio FILES with a trained model (port of
``phones_las_tpu/cli/transcribe.py``): wav / flac / sphere / mp3 through
the native decoders, then the workdir ``Transcriber`` on the card, with an
optional long-form mode for recordings far beyond utterance length
(pause-snapped segmentation, or sliding windows stitched by attention
timestamps: ``Transcriber.transcribe_long``).

    python -m phones_las_torch.cli.transcribe --workdir runs/timit a.wav b.flac
    python -m phones_las_torch.cli.transcribe --workdir runs/ls --long-form lecture.mp3
"""

from __future__ import annotations

import argparse
import sys

from phones_las_torch.cli.common import add_device_arg


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("files", nargs="+", help="audio files (wav/flac/sphere/mp3)")
    p.add_argument("--workdir", required=True)
    p.add_argument("--beam-width", type=int, default=None, help="override the run's beam width (0 = greedy)")
    p.add_argument("--length-penalty", type=float, default=0.0)
    p.add_argument("--head", default="phone", choices=["phone", "grapheme"])
    p.add_argument("--long-form", action="store_true",
                   help="segmented transcription for recordings longer than an utterance")
    p.add_argument("--window-seconds", type=float, default=None,
                   help="long-form segment size; default: sized to the model's training "
                        "bucket lengths (pause mode) or 20 s (overlap mode)")
    p.add_argument("--overlap-seconds", type=float, default=2.0,
                   help="overlap (segmentation=overlap) or the pause search half-width (pause)")
    p.add_argument("--segmentation", default="pause", choices=["pause", "overlap"],
                   help="long-form window placement: boundaries snapped to pauses, or "
                        "fixed-stride overlapping windows stitched by timestamps")
    p.add_argument("--max-tokens-per-second", type=float, default=25.0,
                   help="long-form per-window decode cap = window × this")
    p.add_argument("--adapt-cmvn", action="store_true",
                   help="long-form only: normalize features with the stream's own mean/std")
    p.add_argument("--output", default=None, help="write TSV here instead of stdout")
    p.add_argument("--average-checkpoints", type=int, default=1, metavar="K",
                   help="decode with the mean of the newest K checkpoints")
    p.add_argument("--lm", default=None, metavar="LM.npz", help="shallow-fusion n-gram LM (beam decoding only)")
    p.add_argument("--lm-weight", type=float, default=0.3)
    p.add_argument("--ctc-joint", type=float, default=None, metavar="ALPHA",
                   help="one-pass joint CTC-attention beam decoding")
    add_device_arg(p)
    args = p.parse_args(argv)

    import numpy as np

    from phones_las_torch.api import Transcriber
    from phones_las_torch.data.audio_io import read_audio

    t = Transcriber(
        args.workdir, beam_width=args.beam_width, length_penalty=args.length_penalty, head=args.head,
        average_checkpoints=args.average_checkpoints, lm=args.lm, lm_weight=args.lm_weight,
        ctc_joint=args.ctc_joint, device=args.device,
    )
    if args.long_form:
        results = [
            t.transcribe_long(
                np.asarray(read_audio(path, target_rate=t.sample_rate)[0]),
                window_seconds=args.window_seconds, overlap_seconds=args.overlap_seconds,
                max_tokens_per_second=args.max_tokens_per_second, segmentation=args.segmentation,
                adapt_cmvn=args.adapt_cmvn,
            )
            for path in args.files
        ]
    else:
        results = t.transcribe_files(args.files)

    out = open(args.output, "w") if args.output else sys.stdout
    try:
        for path, toks in zip(args.files, results):
            print(f"{path}\t{' '.join(toks)}", file=out)
    finally:
        if args.output:
            out.close()


if __name__ == "__main__":
    main()
