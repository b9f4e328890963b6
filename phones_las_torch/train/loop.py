"""Trainer: the training step, the outer loop with its checkpoints, and
the greedy eval leg (port of ``phones_las_tpu/train/loop.py``).

One ``train_step`` is ``compute_loss(train=True)`` (front-end kernel,
frequency warp and SpecAugment, listener with dropout, teacher-forced
speller with scheduled sampling, masked CE), its backward (the residual
and VJP kernels in every listener layer on CUDA), ``mask_grads``, the
clipped Adam update and the learning-rate schedule, all inside the
config's ``matmul_precision`` scope. PyTorch runs eagerly, so there is
no jit; the step's randomness comes from the state's ``torch.Generator``.
With a ``workdir`` the trainer resumes silently from its latest
checkpoint and ``fit`` saves under the ``CheckpointManager``'s policy.

Not ported yet: the epoch-tracked ``DataSource`` loop (ROADMAP A5), the
device mesh (A8), beam-search eval and the eval leg's WER and attention
image.
"""

from __future__ import annotations

import time
from typing import Callable, Dict, Iterable, Optional

import numpy as np
import torch

from phones_las_torch.decode.greedy import greedy_decode
from phones_las_torch.frontend.features import frames_for_samples
from phones_las_torch.models.las import LASConfig, LASParams, compute_loss, encode
from phones_las_torch.ops.lstm import resolve_rnn_precision
from phones_las_torch.train.checkpoint import CheckpointManager
from phones_las_torch.train.state import (
    Optimizer,
    TrainConfig,
    TrainState,
    apply_updates,
    create_train_state,
    global_norm,
    lr_schedule,
    mask_grads,
)
from phones_las_torch.utils import metrics as M
from phones_las_torch.utils.device import DeviceLike, matmul_precision_scope, resolve_device
from phones_las_torch.utils.param_io import named_leaves

_DEVICE_KEYS = (
    "audio", "audio_lengths", "targets", "target_lengths",
    "grapheme_targets", "grapheme_lengths",
)


class Trainer:
    def __init__(
        self,
        model_cfg: LASConfig,
        train_cfg: TrainConfig,
        workdir: Optional[str] = None,
        *,
        binf_codes: Optional[np.ndarray] = None,
        score_fold: Optional[Dict[int, Optional[int]]] = None,
        device: DeviceLike = None,
    ):
        """``device=None`` means CUDA (raises without one); pass
        ``device='cpu'`` for the plain PyTorch path. The recurrent dots'
        precision follows ``model_cfg.matmul_precision``
        (``resolve_rnn_precision``), the other GEMMs its scope. A
        ``workdir`` with a checkpoint restores the state from the latest
        one (``start_epoch`` is its data epoch)."""
        self.device = resolve_device(device)
        self.model_cfg = model_cfg
        self.train_cfg = train_cfg
        self.score_fold = score_fold
        self.prec = resolve_rnn_precision(model_cfg.matmul_precision)
        self.tx = Optimizer(train_cfg)
        self.state: TrainState = create_train_state(model_cfg, train_cfg, binf_codes, self.device)
        self.start_epoch = 0
        self.ckpt: Optional[CheckpointManager] = None
        if workdir is not None:
            self.ckpt = CheckpointManager(
                workdir, keep=train_cfg.keep_checkpoints, save_every=train_cfg.checkpoint_every
            )
            if self.ckpt.latest_step() is not None:
                self.state, self.start_epoch = self.ckpt.restore(self.state)

    def _scope(self):
        return matmul_precision_scope(self.model_cfg.matmul_precision)

    def warm_start(self, params: LASParams) -> None:
        """Set every leaf of the state's params (CMVN stats included) from
        ``params``, as the reference's CLI replaces ``state.params`` with a
        warm-start checkpoint before the first step."""
        src = dict(named_leaves(params))
        with torch.no_grad():
            for key, t in named_leaves(self.state.params):
                t.copy_(src[key])

    def device_batch(self, batch: Dict) -> Dict[str, torch.Tensor]:
        return {k: torch.as_tensor(v).to(self.device) for k, v in batch.items() if k in _DEVICE_KEYS}

    def loss(self, batch: Dict):
        """The forward half of a step: ``compute_loss(train=True)`` with the
        state's generator and the scheduled-sampling ramp → (loss, aux)."""
        st, cfg, tc = self.state, self.model_cfg, self.train_cfg
        sp = None
        if tc.sampling_ramp_steps > 0:
            sp = cfg.speller.sampling_probability * min(1.0, st.step / tc.sampling_ramp_steps)
        with self._scope():
            return compute_loss(
                st.params, cfg, self.device_batch(batch), train=True, generator=st.generator,
                sampling_probability=sp, prec=self.prec,
            )

    def apply_gradients(self) -> Dict:
        """The optimizer half of a step, on the gradients the leaves hold:
        ``mask_grads``, clip by global norm, Adam, ``-lr(step)``; then
        step += 1 and the gradients are cleared → {'grad_norm' (of the
        masked gradients, before clipping), 'lr'}."""
        st = self.state
        leaves = list(named_leaves(st.params))
        grads = mask_grads({k: t.grad for k, t in leaves}, st.params)
        g = [grads[k] for k, _ in leaves]
        lr = lr_schedule(self.train_cfg)(st.step)
        updates, st.opt_state = self.tx.update(g, st.opt_state)
        apply_updates([t for _, t in leaves], updates)
        for _, t in leaves:
            t.grad = None
        st.step += 1
        return {"grad_norm": global_norm(g), "lr": lr}

    def train_step(self, batch: Dict) -> Dict:
        """One optimizer step (``loss``, its backward, ``apply_gradients``)
        → {'loss', 'grad_norm', 'lr', and the per-head losses}, losses as
        detached tensors (no device sync)."""
        for _, t in named_leaves(self.state.params):
            t.grad = None
        with self._scope():
            loss, aux = self.loss(batch)
            loss.backward()
            out = {"loss": loss.detach(), **self.apply_gradients()}
        for k in ("phone_loss", "grapheme_loss", "binf_loss", "ctc_loss"):
            if k in aux:
                out[k] = aux[k].detach()
        return out

    def fit(
        self,
        batches: Iterable[Dict],
        *,
        eval_batches_fn: Optional[Callable[[], Iterable[Dict]]] = None,
        log_fn=print,
    ) -> TrainState:
        """Train over a plain batch iterator until ``num_steps``, logging
        the mean loss of each window of ``log_every`` steps and evaluating
        every ``eval_every`` steps when ``eval_batches_fn`` is given. With a
        workdir, each step is saved under the manager's policy
        (``checkpoint_every``), and also when ``checkpoint_every_secs``
        have passed since the last save; the last step is saved at the end.
        The data epoch saved is 0 (a plain iterator has none)."""
        tc = self.train_cfg
        t0, window = time.time(), []
        last_ckpt_time = time.time()
        step = self.state.step
        for batch in batches:
            if step >= tc.num_steps:
                break
            out = self.train_step(batch)
            # losses stay on the device until a log line needs them
            window.append(out["loss"])
            step += 1
            if step % tc.log_every == 0 or step == tc.num_steps:
                rate = len(window) * len(batch["audio"]) / (time.time() - t0)
                log_fn({
                    "tag": "train", "step": step, "loss": float(torch.stack(window).mean()),
                    "utt_per_sec": round(rate, 2), "lr": float(out["lr"]),
                    "grad_norm": float(out["grad_norm"]),
                })
                t0, window = time.time(), []
            if eval_batches_fn is not None and step % tc.eval_every == 0:
                log_fn({"tag": "eval", "step": step, **self.evaluate(eval_batches_fn())})
            if self.ckpt is not None:
                force = (
                    tc.checkpoint_every_secs > 0
                    and time.time() - last_ckpt_time >= tc.checkpoint_every_secs
                    and self.ckpt.latest_step() != step
                )
                if self.ckpt.save(step, self.state, epoch=0, force=force):
                    last_ckpt_time = time.time()
        if self.ckpt is not None:
            if self.ckpt.latest_step() != self.state.step:
                self.ckpt.save(self.state.step, self.state, epoch=0, force=True)
            self.ckpt.wait()
        return self.state

    def evaluate(self, batches: Iterable[Dict], max_steps: Optional[int] = None) -> Dict:
        """Greedy eval leg: teacher-forced loss + greedy decode + edit-distance
        PER (and the grapheme head's CER), with the cap-hit rate."""
        cfg, params = self.model_cfg, self.state.params
        dist = tokens = g_dist = g_tokens = cap_hits = eval_utts = 0
        losses = []
        with torch.no_grad(), self._scope():
            for batch in batches:
                steps_cap = max_steps or self.decode_cap(batch)
                b = self.device_batch(batch)
                encoded = encode(params, cfg, b["audio"], b["audio_lengths"], prec=self.prec)
                memory, _, enc_mask = encoded
                loss, _ = compute_loss(params, cfg, b, train=False, encoded=encoded, prec=self.prec)
                losses.append(float(loss))
                toks, lens, _ = greedy_decode(
                    params.speller, cfg.speller, memory, enc_mask, steps_cap, prec=self.prec
                )
                toks, lens = toks.cpu().numpy(), lens.cpu().numpy()
                n_real = batch.get("num_real")
                n_real = lens.shape[0] if n_real is None else int(n_real)
                cap_hits += int((lens[:n_real] >= steps_cap).sum())
                eval_utts += n_real
                d, t = M.edit_distance_stats(
                    toks, lens, np.asarray(batch["targets"]),
                    np.asarray(batch["target_lengths"]) - 1,  # exclude <eos>
                    num_real=batch.get("num_real"), fold=self.score_fold,
                )
                dist, tokens = dist + d, tokens + t
                if params.grapheme_speller is not None and "grapheme_targets" in batch:
                    gt, gl, _ = greedy_decode(
                        params.grapheme_speller, cfg.grapheme_speller, memory, enc_mask, steps_cap,
                        prec=self.prec,
                    )
                    d, t = M.edit_distance_stats(
                        gt.cpu().numpy(), gl.cpu().numpy(), np.asarray(batch["grapheme_targets"]),
                        np.asarray(batch["grapheme_lengths"]) - 1, num_real=batch.get("num_real"),
                    )
                    g_dist, g_tokens = g_dist + d, g_tokens + t
        res = {
            "loss": float(np.mean(losses)) if losses else float("nan"),
            "per": M.per_from_stats(dist, tokens),
            "ref_tokens": tokens,
        }
        if eval_utts:
            res["cap_hit_rate"] = cap_hits / eval_utts
        if g_tokens:
            res["cer"] = M.per_from_stats(g_dist, g_tokens)
            res["grapheme_ref_tokens"] = g_tokens
        return res

    def decode_cap(self, batch: Dict) -> int:
        """Per-batch decode-step cap: the batch's encoder frames, at least 16
        (the reference's rule at its default ratio of 1)."""
        cfg = self.model_cfg
        audio = batch["audio"]
        if cfg.input_is_pcm and getattr(audio, "ndim", 2) == 2:
            t = frames_for_samples(audio.shape[1], cfg.frontend)
        else:
            t = audio.shape[1]
        for _ in range(cfg.listener.num_layers - 1):
            t = (t + 1) // 2
        return max(16, t)
