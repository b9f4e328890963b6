"""Build the bench's accuracy-row assets from a trained workdir of the
port (counterpart of ``tools/make_bench_assets.py``):

    <out>/ckpt.npz      — params + config (``utils/param_io.py``)
    <out>/eval_set.npz  — a fixed padded eval batch in the reference's keys
                          (audio, lengths, refs, decode_cap)

which ``python -m phones_las_torch.bench`` decodes with
``PLU_BENCH_ASSETS_DIR=<out>`` (and the JAX package's bench reads alike).
``--out`` is required: the committed assets live in the JAX package,
which this tool does not write.

    python -m phones_las_torch.tools.make_bench_assets --workdir runs/x --out assets --n-utts 64
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
from typing import Callable, Dict

import numpy as np

from phones_las_torch.cli.common import add_device_arg


def eval_set_arrays(reader, n_utts: int, decode_cap: Callable[[Dict], int]) -> Dict[str, np.ndarray]:
    """The first ``n_utts`` utterances of a record reader as the padded
    eval batch: float32 PCM [N, S_max], sample lengths, targets padded
    with -1 to the longest + 1 (<eos> headroom), and the decode cap that
    ``decode_cap({'audio': audio})`` gives the batch."""
    n = min(n_utts, len(reader))
    utts = [reader[i] for i in range(n)]
    s_max = max(u.audio.shape[0] for u in utts)
    l_max = max(u.targets.shape[0] for u in utts) + 1  # +eos headroom
    audio = np.zeros((n, s_max), np.float32)
    lengths = np.zeros((n,), np.int32)
    refs = np.full((n, l_max), -1, np.int32)
    for i, u in enumerate(utts):
        audio[i, : u.audio.shape[0]] = u.audio.astype(np.float32)
        lengths[i] = u.audio.shape[0]
        refs[i, : u.targets.shape[0]] = u.targets
    cap = decode_cap({"audio": audio})
    return {"audio": audio, "lengths": lengths, "refs": refs, "decode_cap": np.array([cap], np.int32)}


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--workdir", required=True, help="trained run (config.json + checkpoints)")
    p.add_argument("--n-utts", type=int, default=64)
    p.add_argument("--split", default="test.plu")
    p.add_argument("--out", required=True, help="output dir")
    add_device_arg(p)
    args = p.parse_args(argv)

    from phones_las_torch.cli.common import resolve_preset
    from phones_las_torch.data.records import RecordReader
    from phones_las_torch.train.checkpoint import load_averaged_params
    from phones_las_torch.train.loop import Trainer
    from phones_las_torch.utils.param_io import save_params_npz

    os.makedirs(args.out, exist_ok=True)
    with open(os.path.join(args.workdir, "config.json")) as f:
        cfg_file = json.load(f)
    preset, vocab, _, _, binf_codes = resolve_preset(
        cfg_file["preset"], cfg_file["data"], dict(cfg_file.get("overrides") or {}) or None,
    )
    if cfg_file.get("precision"):
        preset = dataclasses.replace(
            preset, model=dataclasses.replace(preset.model, matmul_precision=cfg_file["precision"]),
        )
    trainer = Trainer(preset.model, preset.train, binf_codes=binf_codes, device=args.device)
    # the latest checkpoint's params alone, whatever device type wrote it
    params, used = load_averaged_params(args.workdir, trainer.state, 1)
    step = used[-1]
    if step <= 0:
        raise ValueError(f"no trained checkpoint in {args.workdir}")
    save_params_npz(os.path.join(args.out, "ckpt.npz"), params, preset.model)

    arrays = eval_set_arrays(RecordReader(os.path.join(cfg_file["data"], args.split)), args.n_utts,
                             trainer.decode_cap)
    np.savez_compressed(os.path.join(args.out, "eval_set.npz"), **arrays)
    n, s_max = arrays["audio"].shape
    print(f"wrote {args.out}/ckpt.npz (step {step}, vocab {len(vocab)}) and "
          f"eval_set.npz ({n} utts, S={s_max}, cap={int(arrays['decode_cap'][0])})")


if __name__ == "__main__":
    main()
