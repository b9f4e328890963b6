"""Inference CLI (port of ``phones_las_tpu/cli/infer.py``).

Reads the params of the latest checkpoint (or the mean of the newest K)
of a workdir, whatever device type wrote it, decodes record files greedily (the fused decoder kernel on the
card) or with beam search (joint CTC, CTC rescoring, n-gram fusion), maps
ids back through the vocab, writes or prints hypotheses, and reports PER
(and WER where the target stream has a word break) when references are
present. ``--mesh`` splits every batch over the cards (or ``--devices``),
one copy of the model on each: offline data-parallel decoding.

    python -m phones_las_torch.cli.infer --workdir runs/timit --data data/timit/test.plu
"""

from __future__ import annotations

import argparse

from phones_las_torch.cli.common import add_device_arg, parse_devices


def _dump_alignments(out_dir: str, aligns, lens, enc_lens, batch) -> None:
    """Attention heatmap PNGs of the batch's first rows (matplotlib, loaded
    only here, as the reference loads it)."""
    import os

    try:
        import matplotlib
    except ImportError as e:
        raise RuntimeError("--dump-alignments needs matplotlib, which is not installed") from e
    from phones_las_torch.utils.metrics import attention_image

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    os.makedirs(out_dir, exist_ok=True)
    for i in range(min(batch["num_real"], 8)):
        img = attention_image(aligns[i], max(int(lens[i]), 1), int(enc_lens[i]))
        fig, ax = plt.subplots(figsize=(6, 3))
        ax.imshow(img[..., 0], aspect="auto", origin="lower", interpolation="nearest")
        ax.set_xlabel("encoder frames")
        ax.set_ylabel("decode steps")
        ax.set_title(batch["utt_ids"][i])
        fig.savefig(os.path.join(out_dir, f"{batch['utt_ids'][i]}.png"), dpi=100, bbox_inches="tight")
        plt.close(fig)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--workdir", required=True)
    p.add_argument("--data", required=True, help="a .plu record file or data dir")
    p.add_argument("--beam-width", type=int, default=None, help="0 = force greedy; unset = the preset's width")
    p.add_argument("--length-penalty", type=float, default=0.0)
    p.add_argument("--batch-size", type=int, default=None)
    p.add_argument("--monotonic-mode", default=None, choices=["parallel", "hard"],
                   help="decode-time monotonic-attention mode override (models trained "
                        "with a *_monotonic attention type)")
    p.add_argument("--monotonic-bias", type=float, default=None, metavar="B",
                   help="decode-time pre-sigmoid energy bias for *_monotonic attention")
    p.add_argument("--output", default=None, help="write hypotheses TSV here")
    p.add_argument("--mesh", action="store_true",
                   help="shard each batch over every card (offline data-parallel decoding)")
    p.add_argument("--devices", default=None, metavar="DEV,DEV,...",
                   help="the devices --mesh shards over, in order, one may repeat (default: every card)")
    p.add_argument("--head", default="phone", choices=["phone", "grapheme"],
                   help="which decoder head to decode (multitask models)")
    p.add_argument("--dump-alignments", default=None, metavar="DIR",
                   help="save attention-alignment heatmap PNGs for the first batch "
                        "(greedy only; needs matplotlib)")
    p.add_argument("--average-checkpoints", type=int, default=1, metavar="K",
                   help="decode with the mean of the newest K checkpoints")
    p.add_argument("--lm", default=None, metavar="LM.npz",
                   help="n-gram LM (cli.lm) for shallow-fusion beam decoding")
    p.add_argument("--lm-weight", type=float, default=0.3)
    p.add_argument("--ctc-rescore", type=float, default=None, metavar="ALPHA",
                   help="rescore beam hypotheses with the CTC head "
                        "(score = ALPHA*attn + (1-ALPHA)*ctc; beam > 0)")
    p.add_argument("--ctc-joint", type=float, default=None, metavar="ALPHA",
                   help="one-pass joint decoding: CTC prefix scores inside the beam loop")
    add_device_arg(p)
    args = p.parse_args(argv)
    devices = parse_devices(args.devices, args.device)

    import dataclasses
    import glob
    import json
    import os

    import numpy as np
    import torch

    from phones_las_torch.cli.common import resolve_preset, timit_score_fold
    from phones_las_torch.data.pipeline import DataSource
    from phones_las_torch.decode import beam_decode, greedy_decode
    from phones_las_torch.decode.ctc import rescore_beams
    from phones_las_torch.models.las import ctc_logp, encode
    from phones_las_torch.parallel.mesh import local_devices, map_row_shards, replicate
    from phones_las_torch.train.checkpoint import load_averaged_params
    from phones_las_torch.train.loop import Trainer
    from phones_las_torch.utils.device import matmul_precision_scope
    from phones_las_torch.utils.metrics import edit_distance_stats, per_from_stats, word_error_stats

    with open(os.path.join(args.workdir, "config.json")) as f:
        cfg_file = json.load(f)
    preset_name, data_dir = cfg_file["preset"], cfg_file["data"]
    # replay the hparam overrides the run was trained with (shapes must
    # match the checkpoint), then apply infer-time ones on top
    overrides = dict(cfg_file.get("overrides") or {})
    if args.batch_size:
        overrides["batch_size"] = args.batch_size
    if args.monotonic_mode:
        overrides["monotonic_mode"] = args.monotonic_mode
    if args.monotonic_bias is not None:
        overrides["monotonic_bias"] = args.monotonic_bias
    preset, vocab, gvocab, _, binf_codes = resolve_preset(preset_name, data_dir, overrides or None)
    if (args.monotonic_mode or args.monotonic_bias is not None) and not (
        preset.model.speller.attention_type.endswith("_monotonic")
    ):
        # only *_monotonic attention honors these: a silent no-op would make
        # an A/B decode comparison meaningless
        p.error(f"--monotonic-mode/--monotonic-bias given but the checkpoint's attention type is "
                f"'{preset.model.speller.attention_type}' (not *_monotonic); the flag would have no effect")
    if cfg_file.get("precision"):
        preset = dataclasses.replace(
            preset, model=dataclasses.replace(preset.model, matmul_precision=cfg_file["precision"])
        )

    mesh_devices = None
    if args.mesh:
        mesh_devices = devices or local_devices(args.device)
        if preset.pipeline.batch_size % len(mesh_devices):
            p.error(f"--mesh: the batch size {preset.pipeline.batch_size} does not split over "
                    f"{len(mesh_devices)} devices")
    elif devices is not None:
        p.error("--devices names the devices of --mesh")
    trainer = Trainer(preset.model, preset.train, binf_codes=binf_codes,
                      device=mesh_devices[0] if mesh_devices else args.device)
    # the params alone, so a checkpoint written on one device type decodes on another
    params, used = load_averaged_params(args.workdir, trainer.state, max(1, args.average_checkpoints))
    if args.average_checkpoints > 1:
        print(f"averaged {len(used)} checkpoints: steps {used}")
    model_cfg, prec = preset.model, trainer.prec

    # an explicit --beam-width 0 forces greedy even where the preset has a beam
    beam = args.beam_width if args.beam_width is not None else preset.beam_width
    if args.head == "grapheme":
        if model_cfg.grapheme_speller is None or gvocab is None:
            p.error("the model has no grapheme head")
        speller_cfg, vocab = model_cfg.grapheme_speller, gvocab
        max_steps = preset.pipeline.max_grapheme_len or preset.pipeline.max_target_len
    else:
        speller_cfg = model_cfg.speller
        max_steps = preset.pipeline.max_target_len
    want_aligns = bool(args.dump_alignments) and not beam

    lm_logp = None
    if args.lm:
        if not beam:
            p.error("--lm requires beam decoding (set --beam-width > 0)")
        from phones_las_torch.decode.lm import load_lm

        lm_logp = torch.from_numpy(load_lm(args.lm)).to(trainer.device)
        if lm_logp.shape[-1] != speller_cfg.vocab_size:
            p.error(f"LM vocab {lm_logp.shape[-1]} != model vocab {speller_cfg.vocab_size}")

    rescore_alpha, joint_alpha = args.ctc_rescore, args.ctc_joint
    if rescore_alpha is not None or joint_alpha is not None:
        flag = "--ctc-rescore" if rescore_alpha is not None else "--ctc-joint"
        if rescore_alpha is not None and joint_alpha is not None:
            p.error("--ctc-rescore and --ctc-joint are mutually exclusive")
        if not beam:
            p.error(f"{flag} requires beam decoding")
        if args.head != "phone":
            p.error("the CTC head scores phone targets")
        if params.ctc_w is None:
            p.error(f"{flag} needs a model trained with --ctc-weight > 0")

    def infer_fn(params, audio, lengths, aligned: bool):
        """One batch on ``audio``'s device with ``params`` there → (tokens,
        lengths, alignments or None, encoder lengths)."""
        speller = params.grapheme_speller if args.head == "grapheme" else params.speller
        lm = None if lm_logp is None else lm_logp.to(audio.device)
        with torch.no_grad(), matmul_precision_scope(model_cfg.matmul_precision):
            memory, enc_lens, enc_mask = encode(params, model_cfg, audio, lengths, prec=prec)
            if not beam:
                toks, lens, aligns = greedy_decode(
                    speller, speller_cfg, memory, enc_mask, max_steps, return_alignments=aligned, prec=prec
                )
                return toks, lens, aligns, enc_lens
            res = beam_decode(
                speller, speller_cfg, memory, enc_mask, max_steps, beam_width=beam,
                length_penalty=args.length_penalty, lm_logp=lm, lm_weight=args.lm_weight,
                ctc_logp=None if joint_alpha is None else ctc_logp(params, memory),
                ctc_alpha=1.0 if joint_alpha is None else joint_alpha, prec=prec,
            )
            if rescore_alpha is None:
                return res.tokens, res.lengths, None, enc_lens
            best, _ = rescore_beams(
                torch.matmul(memory, params.ctc_w) + params.ctc_b, enc_mask, res.beam_tokens,
                res.beam_lengths, res.beam_logp, rescore_alpha, beam_finished=res.beam_finished,
                length_penalty=args.length_penalty,
            )
            rows = torch.arange(best.shape[0], device=best.device)
            return res.beam_tokens[rows, best], res.beam_lengths[rows, best], None, enc_lens

    paths = sorted(glob.glob(os.path.join(args.data, "*.plu"))) if os.path.isdir(args.data) else [args.data]
    source = DataSource(paths, dataclasses.replace(preset.pipeline, shuffle=False, drop_remainder=False))

    fold = None
    meta_path = os.path.join(data_dir, "meta.json")
    if os.path.exists(meta_path) and args.head == "phone":
        with open(meta_path) as f:
            meta = json.load(f)
        if meta.get("corpus") == "timit":
            fold = timit_score_fold(vocab, meta.get("output_ipa", True))

    ref_key, ref_len_key = (
        ("grapheme_targets", "grapheme_lengths") if args.head == "grapheme" else ("targets", "target_lengths")
    )
    # word-level scoring where the target stream has a word-break token
    sep_id = next((vocab.encode([t])[0] for t in ("<space>", "|") if t in vocab), None)
    # --mesh: a copy of the model on each device, a part of every batch each
    shards = list(zip(mesh_devices, [params] + replicate(params, mesh_devices[1:]))) if mesh_devices else None
    out_f = open(args.output, "w") if args.output else None
    try:
        dist = tokens_total = wdist = words_total = n_utts = 0
        dumped = False
        for batch in source.epoch(0):
            aligned = want_aligns and not dumped
            if shards:
                toks, lens, aligns, enc_lens = map_row_shards(
                    lambda p, a, n: infer_fn(p, a, n, aligned), shards, batch["audio"], batch["audio_lengths"]
                )
            else:
                db = trainer.device_batch(batch)
                toks, lens, aligns, enc_lens = infer_fn(params, db["audio"], db["audio_lengths"], aligned)
            toks, lens = toks.cpu().numpy(), lens.cpu().numpy()
            if aligned:
                _dump_alignments(args.dump_alignments, aligns.cpu().numpy(), lens, enc_lens.cpu().numpy(), batch)
                dumped = True
            d, t = edit_distance_stats(
                toks, lens, batch[ref_key], batch[ref_len_key] - 1, num_real=batch["num_real"], fold=fold,
            )
            dist, tokens_total = dist + d, tokens_total + t
            if sep_id is not None:
                wd, wt = word_error_stats(
                    toks, lens, batch[ref_key], batch[ref_len_key] - 1, sep_id, num_real=batch["num_real"],
                )
                wdist, words_total = wdist + wd, words_total + wt
            for i in range(batch["num_real"]):
                line = f"{batch['utt_ids'][i]}\t{' '.join(vocab.decode(toks[i][: lens[i]]))}"
                print(line) if out_f is None else out_f.write(line + "\n")
                n_utts += 1
    finally:
        if out_f is not None:
            out_f.close()
    if tokens_total:
        wer = f", WER={per_from_stats(wdist, words_total):.4f} ({wdist}/{words_total})" if words_total else ""
        print(f"# {n_utts} utterances, PER={per_from_stats(dist, tokens_total):.4f} "
              f"({dist}/{tokens_total}){wer}")


if __name__ == "__main__":
    main()
