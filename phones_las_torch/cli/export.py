"""Export CLI (port of ``phones_las_tpu/cli/export.py``): freeze a trained
workdir into serving programs.

Traces the full inference program (front-end → encoder → decode) at each
requested serving shape with the trained weights inside and saves it
with ``torch.export`` — see ``phones_las_torch.export``. The kernels are
operators of the program, so on the card it launches them.

    python -m phones_las_torch.cli.export --workdir runs/ls --out runs/ls/export \\
        --batch-sizes 1,16,64 --pad-seconds 10
"""

from __future__ import annotations

import argparse
import os

from phones_las_torch.cli.common import add_device_arg


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--workdir", required=True)
    p.add_argument("--out", required=True, help="export directory")
    p.add_argument("--batch-sizes", default="1,8,64", help="comma-separated serving batch sizes")
    p.add_argument("--pad-seconds", default="10", help="comma-separated audio capacities (seconds)")
    p.add_argument("--beam-width", type=int, default=None, help="0 = force greedy; unset = the preset's width")
    p.add_argument("--head", default="phone", choices=["phone", "grapheme"])
    p.add_argument("--platforms", default=None,
                   help="comma-separated devices the programs may be served on (cuda,cpu); "
                        "default: the device they are traced on")
    p.add_argument("--average-checkpoints", type=int, default=1, metavar="K",
                   help="export the mean of the newest K checkpoints")
    p.add_argument("--lm", default=None, metavar="LM.npz",
                   help="bake a shallow-fusion n-gram LM into the programs (beam decoding only)")
    p.add_argument("--lm-weight", type=float, default=0.3)
    add_device_arg(p)
    args = p.parse_args(argv)

    from phones_las_torch.export import export_model

    meta = export_model(
        args.workdir, args.out,
        batch_sizes=[int(x) for x in args.batch_sizes.split(",")],
        pad_seconds=[float(x) for x in args.pad_seconds.split(",")],
        beam_width=args.beam_width, head=args.head,
        platforms=args.platforms.split(",") if args.platforms else None,
        average_checkpoints=args.average_checkpoints, lm=args.lm, lm_weight=args.lm_weight,
        device=args.device,
    )
    total = sum(os.path.getsize(os.path.join(args.out, e["file"])) for e in meta["entries"])
    print(f"exported {len(meta['entries'])} program(s) to {args.out} "
          f"({total / 2**20:.1f} MiB, vocab {len(meta['tokens'])}, on {meta['device']})")


if __name__ == "__main__":
    main()
