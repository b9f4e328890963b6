"""Entry points (port of the repository's ``__graft_entry__.py``).

``flagship_cfg(tiny)``  — the model every bench row measures: the
                          LibriSpeech-class char LAS (3 × 256 pyramidal
                          BiLSTM, 2 × 256 speller, vocab 34), or its tiny
                          smoke-size twin.
``entry(device)``       — the forward step of the flagship model (PCM →
                          front-end → listener → greedy decode) and its
                          example arguments.
``dryrun_multichip(n)`` — ONE full training step (loss, gradients, Adam)
                          over an n-rank ('data', 'model') mesh with real
                          data and model shardings, on tiny shapes, held
                          against the unsharded step; then a data-parallel
                          beam-8 decode held against the unsharded one.

    python -m phones_las_torch.entry [--device cpu]

Every entry point runs on CUDA unless given ``device='cpu'`` (``devices``
for the dry run), where the kernels' plain versions run.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import tempfile
from typing import Optional, Sequence

import numpy as np
import torch

from phones_las_torch.models.las import LASConfig
from phones_las_torch.models.listener import ListenerConfig
from phones_las_torch.models.speller import SpellerConfig
from phones_las_torch.utils.device import DeviceLike, resolve_device

ENTRY_BATCH, ENTRY_SAMPLES, ENTRY_STEPS = 4, 64000, 100  # 4 utterances × 4 s at 16 kHz, 100 greedy steps
DRYRUN_LOSS_TOL = 1e-4  # the sharded step's loss against the unsharded one
DRYRUN_GRAD_TOL = 5e-5  # each gradient leaf's max |d| over its max |g|


def flagship_cfg(tiny: bool = False) -> LASConfig:
    """The reference's ``_flagship_cfg``, field by field."""
    if tiny:
        return LASConfig(
            listener=ListenerConfig(input_dim=120, num_layers=2, units=16),
            speller=SpellerConfig(
                vocab_size=34, embedding_dim=8, num_layers=1, units=16,
                memory_dim=32, attention_units=16, attention_layer_size=16,
            ),
        )
    return LASConfig(
        listener=ListenerConfig(input_dim=120, num_layers=3, units=256),
        speller=SpellerConfig(
            vocab_size=34, embedding_dim=128, num_layers=2, units=256,
            memory_dim=512, attention_units=256, attention_layer_size=256,
        ),
    )


def entry(device: DeviceLike = None):
    """→ (fn, example_args): the flagship forward (encode + greedy decode
    of 100 steps, parity mode) and (params from seed 0, 4 × 4 s of random
    PCM, their lengths) on ``device`` (None: CUDA, through the kernels).
    ``fn(params, audio, lengths)`` → (tokens [4, 100], lengths [4])."""
    from phones_las_torch.decode.greedy import greedy_decode
    from phones_las_torch.models.las import encode, init_las
    from phones_las_torch.ops.lstm import resolve_rnn_precision
    from phones_las_torch.utils.device import matmul_precision_scope

    dev = resolve_device(device)
    cfg = flagship_cfg()
    params = init_las(cfg, seed=0, device=dev)
    audio = np.asarray(np.random.RandomState(0).randn(ENTRY_BATCH, ENTRY_SAMPLES) * 1000, np.float32)
    lengths = np.full((ENTRY_BATCH,), ENTRY_SAMPLES, np.int32)
    prec = resolve_rnn_precision(cfg.matmul_precision)

    def fn(params, audio, lengths):
        with torch.no_grad(), matmul_precision_scope(cfg.matmul_precision):
            memory, _, enc_mask = encode(params, cfg, audio, lengths, prec=prec)
            tokens, lens, _ = greedy_decode(params.speller, cfg.speller, memory, enc_mask,
                                            max_steps=ENTRY_STEPS, prec=prec)
        return tokens, lens

    return fn, (params, torch.from_numpy(audio).to(dev), torch.from_numpy(lengths).to(dev))


def _dryrun_batch(n_devices: int) -> dict:
    """The reference's host batch: max(8, n) rows of 0.5 s int16 PCM whose
    audio and target lengths differ by row, so the shards see different
    masks (a wrong reduction cannot hide behind uniform shapes)."""
    b = max(8, n_devices)
    rs = np.random.RandomState(0)
    return {
        "audio": (rs.randn(b, 8000) * 1000).astype(np.int16),
        "audio_lengths": rs.randint(3000, 8001, b).astype(np.int32),
        "targets": rs.randint(4, 34, (b, 6)).astype(np.int32),
        "target_lengths": rs.randint(2, 7, b).astype(np.int32),
    }


def sharded_step(tr, batch):
    """One step of a (mesh) ``Trainer`` without dropout or sampling:
    ``loss(train=False)``, backward, the whole gradients, one Adam update
    → (the global batch's loss, {leaf: whole gradient})."""
    loss, _ = tr.loss(batch, train=False)
    loss.backward()
    grads = tr.gradients()
    total = loss.detach().clone()
    if tr.mesh is not None:
        tr.mesh.sum_data(total)
    tr.apply_gradients(grads)
    return total, grads


def _beam_infer(params, cfg, audio, lengths):
    from phones_las_torch.decode.beam import beam_decode
    from phones_las_torch.models.las import encode

    with torch.no_grad():
        memory, _, enc_mask = encode(params, cfg, audio, lengths)
        res = beam_decode(params.speller, cfg.speller, memory, enc_mask, max_steps=8, beam_width=8)
    return res.tokens.cpu(), res.lengths.cpu()


def _dryrun_rank(rank: int, devices: list, init_method: str, backend: str, out: str) -> None:
    """One rank of ``dryrun_multichip``; rank 0 writes the result to ``out``."""
    import torch.distributed as dist

    from phones_las_torch.models.las import init_las
    from phones_las_torch.parallel.mesh import local_rows, make_mesh
    from phones_las_torch.parallel.multihost import initialize_distributed
    from phones_las_torch.train.loop import Trainer
    from phones_las_torch.train.state import TrainConfig

    n = len(devices)
    initialize_distributed(init_method, n, rank, backend)
    try:
        model_ax = 2 if n % 2 == 0 and n >= 2 else 1
        mesh = make_mesh(data=n // model_ax, model=model_ax, devices=devices)
        cfg = flagship_cfg(tiny=True)
        host_batch = _dryrun_batch(n)
        tr = Trainer(cfg, TrainConfig(), mesh=mesh)  # params from seed 0, as init_las(cfg, 0)
        loss, grads = sharded_step(tr, host_batch)
        loss = float(loss)
        if not np.isfinite(loss):
            raise RuntimeError(f"dryrun_multichip: the sharded step's loss is {loss}")

        # the production decode path: a data-parallel beam-8 decode, each
        # rank decoding its rows, gathered in row order
        dp_mesh = make_mesh(data=n, model=1, devices=devices)
        dec = local_rows({k: host_batch[k] for k in ("audio", "audio_lengths")}, dp_mesh)
        params = init_las(cfg, seed=0, device=mesh.device)
        shard = _beam_infer(params, cfg, torch.from_numpy(dec["audio"]).to(mesh.device),
                            torch.from_numpy(dec["audio_lengths"]).to(mesh.device))
        shards = [None] * n
        dist.all_gather_object(shards, shard)
        if rank != 0:
            return

        # the unsharded step and decode on the same device type
        ref = Trainer(cfg, TrainConfig(), device=mesh.device)
        ref_loss, ref_grads = sharded_step(ref, host_batch)
        max_dev = 0.0
        for key, a in ref_grads.items():
            a, g = a.detach().cpu().double(), grads[key].detach().cpu().double()
            scale = max(float(a.abs().max()), 1e-8)
            max_dev = max(max_dev, float((a - g).abs().max()) / scale)
        loss_dev = abs(float(ref_loss) - loss)
        t_ref, l_ref = _beam_infer(params, cfg, torch.from_numpy(host_batch["audio"]).to(mesh.device),
                                   torch.from_numpy(host_batch["audio_lengths"]).to(mesh.device))
        t_sh, l_sh = (torch.cat(parts) for parts in zip(*shards))
        result = {
            "n_devices": n, "mesh": mesh.shape, "backend": backend, "loss": loss, "loss_dev": loss_dev,
            "max_rel_grad_dev": max_dev,
            "beam8_decode_token_equal": bool(torch.equal(t_sh, t_ref) and torch.equal(l_sh, l_ref)),
        }
        with open(out, "w") as f:
            json.dump(result, f)
    finally:
        dist.destroy_process_group()


def dryrun_multichip(n_devices: int, devices: Optional[Sequence[DeviceLike]] = None) -> dict:
    """One sharded training step over an ``n_devices``-rank mesh (data ×
    model 2 where ``n_devices`` is even), one process a rank started with
    ``torch.multiprocessing.spawn``, against the unsharded step (loss
    within 1e-4, every gradient leaf within 5e-5 of its largest
    magnitude), then a data-parallel beam-8 decode token-equal to the
    unsharded one. ``devices`` gives each rank's device and may repeat one
    (the ranks then meet over gloo: NCCL takes one card a rank); by
    default the first ``n_devices`` cards. Too few devices raise
    ``ValueError`` naming the count. → rank 0's result (printed too)."""
    import torch.multiprocessing as mp

    from phones_las_torch.parallel.mesh import pick_devices

    if n_devices < 1:
        raise ValueError(f"need at least 1 device, asked for {n_devices}")
    try:
        devs = pick_devices(n_devices, devices)
    except ValueError as e:
        raise ValueError(f"need {n_devices} devices: {e}") from None
    shared = len(set(map(str, devs))) < len(devs)
    backend = "gloo" if devs[0].type == "cpu" or shared else "nccl"
    work = tempfile.mkdtemp(prefix="plu_dryrun_")
    try:
        out = os.path.join(work, "result.json")
        mp.spawn(_dryrun_rank, args=(devs, f"file://{os.path.join(work, 'rendezvous')}", backend, out),
                 nprocs=n_devices, join=True)
        with open(out) as f:
            result = json.load(f)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    if not (result["loss_dev"] < DRYRUN_LOSS_TOL and result["max_rel_grad_dev"] < DRYRUN_GRAD_TOL):
        raise AssertionError(f"the sharded step left the unsharded one: {result}")
    if not result["beam8_decode_token_equal"]:
        raise AssertionError("the sharded beam-8 decode diverged from the unsharded decode")
    print(
        f"dryrun_multichip({n_devices}): mesh={result['mesh']} loss={result['loss']:.4f} "
        f"|Δloss|={result['loss_dev']:.2e} max_rel_grad_dev={result['max_rel_grad_dev']:.2e} "
        f"beam8_decode_token_equal=True ok", flush=True
    )
    return result


def main(argv=None) -> None:
    from phones_las_torch.cli.common import add_device_arg
    from phones_las_torch.parallel.mesh import local_devices

    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    add_device_arg(p)
    args = p.parse_args(argv)
    fn, example = entry(args.device)
    tokens, lens = fn(*example)
    print("entry ok:", [tuple(tokens.shape), tuple(lens.shape)], flush=True)
    # every device of the type: each card, or the one CPU
    devices = local_devices(args.device)
    dryrun_multichip(len(devices), devices=devices)


if __name__ == "__main__":
    main()
