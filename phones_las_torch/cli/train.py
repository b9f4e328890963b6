"""Training CLI (port of ``phones_las_tpu/cli/train.py``).

Resolves a preset against a prepared data dir, writes the bound config
into the workdir (``config.json``, the reference's format, which the
workdir ``Transcriber`` and ``cli.infer`` replay), warm-starts or resumes,
and trains with periodic eval and checkpoints on the card (``--device
cpu``: the plain path).

    python -m phones_las_torch.cli.train --preset timit_phone_las \\
        --data data/timit --workdir runs/timit --num-steps 20000

Several cards: ``--mesh`` trains data-parallel (× ``--model-parallel``
model-sharded) with one process a card. Run alone, it starts those
processes itself (``torch.multiprocessing.spawn``, one a card or an entry
of ``--devices``); under a launcher that sets ``WORLD_SIZE``/``RANK``
(``torchrun``) each process is one rank. The global batch is the
preset's ``batch_size``, split over the data ranks. ``--multihost``: every
process, started by a launcher on each host, feeds its own slice of the
epoch plan, and the global batch is data ranks × ``batch_size``. The
ranks meet over NCCL on cards (one card a rank) and over gloo on the CPU.
"""

from __future__ import annotations

import argparse
import glob
import os

from phones_las_torch.cli.common import add_device_arg, parse_devices


def _parser() -> argparse.ArgumentParser:
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
    p.add_argument("--mesh", action="store_true",
                   help="train data-parallel over every card (or --devices), one process a card: "
                        "a ('data', 'model') mesh")
    p.add_argument("--model-parallel", type=int, default=1,
                   help="size of the mesh's 'model' axis (with --mesh or --multihost)")
    p.add_argument("--multihost", action="store_true",
                   help="multi-process training started by a launcher (MASTER_ADDR/MASTER_PORT, "
                        "WORLD_SIZE, RANK), each process feeding its slice of the epoch plan; "
                        "implies --mesh over all ranks")
    p.add_argument("--devices", default=None, metavar="DEV,DEV,...",
                   help="each rank's device, in rank order (default: every card; the CPU may "
                        "repeat, a card may not)")
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
    return p


def main(argv=None):
    p = _parser()
    args = p.parse_args(argv)
    if args.model_parallel != 1 and not (args.mesh or args.multihost):
        p.error("--model-parallel sizes the mesh of --mesh or --multihost")
    devices = parse_devices(args.devices, args.device)
    if devices is not None and not (args.mesh or args.multihost):
        p.error("--devices names the ranks' devices of --mesh or --multihost")
    if args.mesh and not args.multihost and "WORLD_SIZE" not in os.environ:
        _spawn_mesh(args, devices)
    else:
        _train(args, devices)


def _spawn_mesh(args, devices) -> None:
    """``--mesh`` outside a launcher: one process a device, rendezvous on
    a file in the workdir; a rank that fails fails the command."""
    import torch.multiprocessing as mp

    from phones_las_torch.parallel.mesh import local_devices

    devs = devices or local_devices(args.device)
    backend = "nccl" if devs[0].type == "cuda" else "gloo"
    os.makedirs(args.workdir, exist_ok=True)
    rendezvous = os.path.join(os.path.abspath(args.workdir), f".rendezvous-{os.getpid()}")
    try:
        mp.spawn(_mesh_rank, args=(args, devs, f"file://{rendezvous}", backend), nprocs=len(devs), join=True)
    finally:
        if os.path.exists(rendezvous):
            os.remove(rendezvous)


def _mesh_rank(rank: int, args, devices, init_method: str, backend: str) -> None:
    from phones_las_torch.parallel.multihost import initialize_distributed

    initialize_distributed(init_method, len(devices), rank, backend)
    _train(args, devices)


def _train(args, devices) -> None:
    import dataclasses
    import json

    import torch

    from phones_las_torch.cli.common import apply_cmvn_to_params, resolve_preset, timit_score_fold
    from phones_las_torch.data.pipeline import DataSource
    from phones_las_torch.train.loop import Trainer

    p = _parser()
    mesh = None
    if args.mesh or args.multihost:
        import torch.distributed as dist

        from phones_las_torch.parallel.mesh import make_mesh
        from phones_las_torch.parallel.multihost import initialize_distributed

        cpu = args.device is not None and torch.device(args.device).type == "cpu"
        if not dist.is_initialized():
            initialize_distributed(backend="gloo" if cpu else None)
        world = dist.get_world_size() if dist.is_initialized() else 1
        if devices is None and cpu:
            devices = [torch.device("cpu")] * world
        mesh = make_mesh(model=args.model_parallel, devices=devices, local_batches=args.multihost)
        if args.multihost and not _same_workdir(mesh, args.workdir):
            raise ValueError("--multihost needs the same --workdir on every process: "
                             "rank 0 writes the checkpoints that every rank reads")
    rank0 = mesh is None or mesh.rank == 0
    say = print if rank0 else (lambda *a, **k: None)

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
    if rank0:
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

    # --multihost: each data rank reads its own slice of the epoch plan (the
    # ranks of one data row the same), and evaluates its slice of the eval set
    shard = (mesh.data_index, mesh.data) if mesh is not None and mesh.local_batches else None
    source = DataSource(train_paths, preset.pipeline, shard=shard)
    eval_cfg = dataclasses.replace(preset.pipeline, shuffle=False, drop_remainder=False)
    eval_source = DataSource(eval_paths, eval_cfg, shard=shard) if eval_paths else None

    g_sep = None
    if gvocab is not None:
        g_sep = next((gvocab.encode([t])[0] for t in ("<space>", "|") if t in gvocab), None)
    trainer = Trainer(
        preset.model, preset.train, workdir=args.workdir, binf_codes=binf_codes, score_fold=fold,
        default_decode_steps=preset.pipeline.max_target_len,
        eval_beam_width=preset.beam_width,  # periodic eval honors the preset
        grapheme_word_sep_id=g_sep,  # grapheme-head WER in periodic eval
        device=None if mesh is not None else args.device, mesh=mesh,
    )
    if args.init_checkpoint and trainer.state.step == 0:
        from phones_las_torch.train.checkpoint import load_params_for_warm_start

        trainer.warm_start(load_params_for_warm_start(
            args.init_checkpoint, trainer.state, scope=args.init_scope, target_params=trainer.state.params,
        ))
        say(f"warm-started [{args.init_scope}] from {args.init_checkpoint}")
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
                trainer.fit(itertools.islice(source.repeat(trainer.start_epoch), args.profile_steps), log_fn=say)
        finally:
            trainer.ckpt = ckpt

    say(f"training {args.preset}: vocab={len(vocab)} steps={preset.train.num_steps} workdir={args.workdir}"
        + ("" if mesh is None else f" mesh={mesh.data}x{mesh.model}"))
    trainer.fit(source, eval_batches_fn=(lambda: eval_source.epoch(0)) if eval_source else None, log_fn=say)
    if eval_source:
        ev = trainer.evaluate(eval_source.epoch(0), beam_width=preset.beam_width)
        say("final eval:", ev)
    if mesh is not None and mesh.distributed:
        torch.distributed.destroy_process_group()


def _same_workdir(mesh, workdir: str) -> bool:
    """Whether every rank names rank 0's workdir (a collective)."""
    import zlib

    import torch
    import torch.distributed as dist

    if not mesh.distributed:
        return True
    h = zlib.crc32(os.path.abspath(workdir).encode()) & 0x7FFFFFFF
    t = torch.tensor([h], device=mesh.device)
    dist.broadcast(t, 0)
    differ = torch.tensor([int(int(t.item()) != h)], device=mesh.device)
    dist.all_reduce(differ)
    return int(differ.item()) == 0


if __name__ == "__main__":
    main()
