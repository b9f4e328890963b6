"""Training CLI (port of ``phones_las_tpu/cli/train.py``).

Resolves a preset against a prepared data dir, writes the bound config
into the workdir (``config.json``, the reference's format, which the
workdir ``Transcriber`` and ``cli.infer`` replay), warm-starts or resumes,
and trains with periodic eval and checkpoints on the card (``--device
cpu``: the plain path).

    python -m phones_las_torch.cli.train --preset timit_phone_las \\
        --data data/timit --workdir runs/timit --num-steps 20000
"""

from __future__ import annotations

import argparse
import glob
import os

from phones_las_torch.cli.common import add_device_arg, not_ported


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--preset", default="timit_phone_las", help="one of utils.config.PRESETS")
    p.add_argument("--data", required=True, help="prepared data dir")
    p.add_argument("--workdir", required=True)
    p.add_argument("--train-records", default=None, help="glob under --data (default: train*.plu)")
    p.add_argument("--eval-records", default=None, help="glob under --data (default: {dev,test}*.plu)")
    p.add_argument("--num-steps", type=int, default=None)
    p.add_argument("--learning-rate", type=float, default=None)
    p.add_argument("--batch-size", type=int, default=None)
    p.add_argument("--lr-decay-rate", type=float, default=None,
                   help="exponential LR decay factor per --lr-decay-steps (1.0 = constant)")
    p.add_argument("--lr-decay-steps", type=int, default=None)
    p.add_argument("--warmup-steps", type=int, default=None,
                   help="linear LR warmup steps before decay applies")
    p.add_argument("--eval-every", type=int, default=None)
    p.add_argument("--checkpoint-every", type=int, default=None,
                   help="checkpoint cadence in steps (preset default 1000)")
    p.add_argument("--encoder-layers", type=int, default=None)
    p.add_argument("--encoder-units", type=int, default=None)
    p.add_argument("--decoder-layers", type=int, default=None)
    p.add_argument("--decoder-units", type=int, default=None)
    p.add_argument("--embedding-dim", type=int, default=None)
    p.add_argument("--attention-type", default=None,
                   choices=["bahdanau", "bahdanau_norm", "luong", "luong_scaled",
                            "bahdanau_monotonic", "luong_monotonic"])
    p.add_argument("--attention-units", type=int, default=None)
    p.add_argument("--monotonic-mode", default=None, choices=["parallel", "hard"],
                   help="decode-time monotonic-attention mode recorded in the run "
                        "config; training always uses the soft 'parallel' recursion")
    p.add_argument("--monotonic-noise", type=float, default=None,
                   help="pre-sigmoid noise stddev on monotonic attention energies "
                        "during training (default 1.0)")
    p.add_argument("--dropout", type=float, default=None)
    p.add_argument("--sampling-probability", type=float, default=None)
    p.add_argument("--specaugment", action="store_true", help="SpecAugment during training")
    p.add_argument("--sa-freq-masks", type=int, default=2)
    p.add_argument("--sa-freq-width", type=int, default=10)
    p.add_argument("--sa-time-masks", type=int, default=2)
    p.add_argument("--sa-time-width", type=int, default=50)
    p.add_argument("--sa-time-ratio", type=float, default=0.2)
    p.add_argument("--buckets", type=int, nargs="+", default=None,
                   help="length-bucket boundaries in samples (overrides the preset)")
    p.add_argument("--max-target-len", type=int, default=None,
                   help="training target-length cap in tokens (overrides the preset)")
    p.add_argument("--multitask-weight", type=float, default=None)
    p.add_argument("--label-smoothing", type=float, default=None,
                   help="uniform label smoothing on the attention CE (train only)")
    p.add_argument("--ctc-weight", type=float, default=None,
                   help="joint CTC-attention loss weight (0 = attention only)")
    p.add_argument("--clip-norm", type=float, default=None)
    p.add_argument("--init-checkpoint", default=None,
                   help="workdir of another run to warm-start params from")
    p.add_argument("--init-scope", default="all", choices=["all", "encoder"],
                   help="'encoder' restores only the listener + CMVN (phone sets differ)")
    p.add_argument("--implementation", default="auto", choices=["auto"],
                   help="kept for the reference's command lines: the port has one implementation")
    p.add_argument("--mesh", action="store_true", help="data-parallel training (not ported: ROADMAP A8)")
    p.add_argument("--model-parallel", type=int, default=1, help="(not ported: ROADMAP A8)")
    p.add_argument("--multihost", action="store_true", help="multi-process training (not ported: ROADMAP A8)")
    p.add_argument("--precision", default=None, choices=["highest", "high", "default"],
                   help="model matmul precision: 'highest' = fp32 parity (default), "
                        "'default' = bf16 recurrent dots and TF32 elsewhere")
    p.add_argument("--frontend-precision", default=None, choices=["highest", "high"],
                   help="front-end precision recorded in the config (the kernel computes float32 for both)")
    p.add_argument("--debug-nans", action="store_true",
                   help="autograd anomaly mode: a NaN in a backward raises and names its operation")
    p.add_argument("--profile-steps", type=int, default=0,
                   help="trace N diagnostic train steps into <workdir>/profile (a Chrome "
                        "trace; the steps advance the model but are not checkpointed)")
    add_device_arg(p)
    args = p.parse_args(argv)

    for flag, on in (("--mesh", args.mesh), ("--multihost", args.multihost),
                     ("--model-parallel", args.model_parallel != 1)):
        if on:
            raise not_ported(flag, "A8")

    import dataclasses
    import json

    from phones_las_torch.cli.common import apply_cmvn_to_params, resolve_preset, timit_score_fold
    from phones_las_torch.data.pipeline import DataSource
    from phones_las_torch.train.loop import Trainer

    overrides = {
        "num_steps": args.num_steps,
        "learning_rate": args.learning_rate,
        "lr_decay_rate": args.lr_decay_rate,
        "lr_decay_steps": args.lr_decay_steps,
        "warmup_steps": args.warmup_steps,
        "batch_size": args.batch_size,
        "eval_every": args.eval_every,
        "checkpoint_every": args.checkpoint_every,
        "encoder_layers": args.encoder_layers,
        "encoder_units": args.encoder_units,
        "decoder_layers": args.decoder_layers,
        "decoder_units": args.decoder_units,
        "embedding_dim": args.embedding_dim,
        "attention_type": args.attention_type,
        "attention_units": args.attention_units,
        "monotonic_mode": args.monotonic_mode,
        "monotonic_noise": args.monotonic_noise,
        "dropout": args.dropout,
        "sampling_probability": args.sampling_probability,
        "buckets": tuple(args.buckets) if args.buckets else None,
        "max_target_len": args.max_target_len,
        "multitask_weight": args.multitask_weight,
        "ctc_weight": args.ctc_weight,
        "label_smoothing": args.label_smoothing,
        "clip_norm": args.clip_norm,
        "frontend_precision": args.frontend_precision,
        "specaugment": (
            {
                "freq_masks": args.sa_freq_masks,
                "freq_mask_width": args.sa_freq_width,
                "time_masks": args.sa_time_masks,
                "time_mask_width": args.sa_time_width,
                "time_mask_ratio": args.sa_time_ratio,
            }
            if args.specaugment
            else None
        ),
    }
    preset, vocab, gvocab, cmvn, binf_codes = resolve_preset(args.preset, args.data, overrides)
    if args.precision:
        preset = dataclasses.replace(
            preset, model=dataclasses.replace(preset.model, matmul_precision=args.precision)
        )

    os.makedirs(args.workdir, exist_ok=True)
    with open(os.path.join(args.workdir, "config.json"), "w") as f:
        json.dump(
            {"preset": args.preset, "data": args.data,
             # non-None overrides, replayed by infer and the Transcriber so a
             # run trained with hparam flags restores with the right shapes
             "overrides": {k: v for k, v in overrides.items() if v is not None},
             "precision": args.precision,
             "resolved": dataclasses.asdict(preset)},
            f, indent=2, default=str,
        )

    train_glob = args.train_records or "train*.plu"
    train_paths = sorted(glob.glob(os.path.join(args.data, train_glob)))
    if not train_paths:
        p.error(f"no records match {train_glob} in {args.data}")
    eval_paths = []
    for g in ([args.eval_records] if args.eval_records else ["dev*.plu", "test*.plu"]):
        eval_paths += sorted(glob.glob(os.path.join(args.data, g)))

    fold = None
    meta_path = os.path.join(args.data, "meta.json")
    if os.path.exists(meta_path):
        with open(meta_path) as f:
            meta = json.load(f)
        if meta.get("corpus") == "timit":
            fold = timit_score_fold(vocab, meta.get("output_ipa", True))

    source = DataSource(train_paths, preset.pipeline)
    eval_cfg = dataclasses.replace(preset.pipeline, shuffle=False, drop_remainder=False)
    eval_source = DataSource(eval_paths, eval_cfg) if eval_paths else None

    g_sep = None
    if gvocab is not None:
        g_sep = next((gvocab.encode([t])[0] for t in ("<space>", "|") if t in gvocab), None)
    trainer = Trainer(
        preset.model, preset.train, workdir=args.workdir, binf_codes=binf_codes, score_fold=fold,
        default_decode_steps=preset.pipeline.max_target_len,
        eval_beam_width=preset.beam_width,  # periodic eval honors the preset
        grapheme_word_sep_id=g_sep,  # grapheme-head WER in periodic eval
        device=args.device,
    )
    if args.init_checkpoint and trainer.state.step == 0:
        from phones_las_torch.train.checkpoint import load_params_for_warm_start

        trainer.warm_start(load_params_for_warm_start(
            args.init_checkpoint, trainer.state, scope=args.init_scope, target_params=trainer.state.params,
        ))
        print(f"warm-started [{args.init_scope}] from {args.init_checkpoint}")
    apply_cmvn_to_params(trainer.state.params, cmvn)

    if args.debug_nans:
        from phones_las_torch.utils.diagnostics import enable_nan_checks

        enable_nan_checks(True)
    if args.profile_steps:
        import itertools

        from phones_las_torch.utils.diagnostics import profile_trace

        # diagnostic leg: these steps advance the model but are never
        # checkpointed, so a profile run leaves the resume bookkeeping alone
        ckpt, trainer.ckpt = trainer.ckpt, None
        try:
            with profile_trace(os.path.join(args.workdir, "profile")):
                trainer.fit(itertools.islice(source.repeat(trainer.start_epoch), args.profile_steps))
        finally:
            trainer.ckpt = ckpt

    print(f"training {args.preset}: vocab={len(vocab)} steps={preset.train.num_steps} workdir={args.workdir}")
    trainer.fit(source, eval_batches_fn=(lambda: eval_source.epoch(0)) if eval_source else None)
    if eval_source:
        print("final eval:", trainer.evaluate(eval_source.epoch(0), beam_width=preset.beam_width))


if __name__ == "__main__":
    main()
