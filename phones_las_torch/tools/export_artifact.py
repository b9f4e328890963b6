"""Export a trained workdir of the port as one self-contained flat-npz
serving artifact (counterpart of ``tools/export_artifact.py``): params,
model config and decode metadata (vocab, training buckets, target cap),
read by ``Transcriber.from_artifact`` and by the JAX package's
``load_artifact``. A thin command line over ``Transcriber.export_artifact``.

    python -m phones_las_torch.tools.export_artifact --workdir runs/x --out model.npz
"""

from __future__ import annotations

import argparse
import os

from phones_las_torch.cli.common import add_device_arg


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--workdir", required=True, help="trained run (config.json + checkpoints)")
    p.add_argument("--out", required=True, help="output .npz path")
    p.add_argument("--average-checkpoints", type=int, default=1)
    add_device_arg(p)
    args = p.parse_args(argv)

    from phones_las_torch.api import Transcriber
    from phones_las_torch.utils.param_io import named_leaves

    t = Transcriber(args.workdir, average_checkpoints=args.average_checkpoints, device=args.device)
    extras = t.export_artifact(args.out)
    n = sum(x.numel() for _, x in named_leaves(t.params))
    print(f"wrote {args.out}: {n:,} params, step {extras['step']}, "
          f"{os.path.getsize(args.out)/1e6:.1f} MB")


if __name__ == "__main__":
    main()
