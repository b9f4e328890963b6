"""Trainer: the training step, the outer loop with its checkpoints, and
the eval legs (port of ``phones_las_tpu/train/loop.py``).

One ``train_step`` is ``compute_loss(train=True)`` (front-end kernel,
frequency warp and SpecAugment, listener with dropout, teacher-forced
speller with scheduled sampling, masked CE), its backward (the residual
and VJP kernels in every listener layer on CUDA), ``mask_grads``, the
clipped Adam update and the learning-rate schedule, all inside the
config's ``matmul_precision`` scope. PyTorch runs eagerly, so there is
no jit; the step's randomness comes from the state's ``torch.Generator``.
With a ``workdir`` the trainer resumes silently from its latest
checkpoint and ``fit`` saves under the ``CheckpointManager``'s policy;
over a ``DataSource`` it tracks the data epoch, saves it with each
checkpoint and resumes at it. The eval leg decodes greedily (the fused
kernel on CUDA) with PER, the grapheme head's CER and WER and the
attention image, or with beam search (``beam_width``).

Under a ``mesh`` (``parallel/mesh.py``) the trainer is one rank of a
data × model grid: the state holds this rank's slices of the parameters
and Adam moments, each step all-gathers the whole parameters, computes
this rank's rows with the losses normalised over the global batch, sums
the gradients over the data ranks, clips by the norm over all slices and
updates its slices; the eval leg decodes this rank's rows and sums the
metrics over the data ranks; rank 0 writes the whole state.
"""

from __future__ import annotations

import time
import zlib
from typing import Callable, Dict, Iterable, Iterator, List, Optional, Tuple

import numpy as np
import torch

from phones_las_torch.decode.beam import beam_decode
from phones_las_torch.decode.greedy import greedy_decode, greedy_decode_steps
from phones_las_torch.frontend.features import frames_for_samples
from phones_las_torch.models.las import LASConfig, LASParams, compute_loss, encode
from phones_las_torch.ops.lstm import resolve_rnn_precision
from phones_las_torch.parallel.mesh import (
    _BATCH_SPECS,
    Mesh,
    gather_params,
    local_rows,
    shard_params,
    shard_tensor,
    sharded_dims,
)
from phones_las_torch.train.checkpoint import CheckpointManager
from phones_las_torch.train.state import (
    AdamState,
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


def data_rank_seed(generator: torch.Generator, step: int, data_index: int) -> int:
    """The seed of data rank ``data_index``'s random draws at ``step`` under
    a mesh with several data ranks: a hash of the state's generator (the
    same on every rank), the step and the index, made on the host from the
    generator's state bytes, so the fork waits for no device."""
    words = [zlib.crc32(generator.get_state().numpy().tobytes()), step, data_index]
    return int(np.random.SeedSequence(words).generate_state(1, np.uint64)[0] >> np.uint64(1))


class _DeviceBatch(dict):
    """A batch already on this rank's device, as its rows: ``loss`` takes
    it as it is."""


class Trainer:
    def __init__(
        self,
        model_cfg: LASConfig,
        train_cfg: TrainConfig,
        workdir: Optional[str] = None,
        *,
        binf_codes: Optional[np.ndarray] = None,
        score_fold: Optional[Dict[int, Optional[int]]] = None,
        default_decode_steps: int = 100,
        eval_beam_width: int = 0,
        decode_cap_ratio: float = 1.0,
        grapheme_word_sep_id: Optional[int] = None,
        device: DeviceLike = None,
        mesh: Optional[Mesh] = None,
    ):
        """``device=None`` means CUDA (raises without one); pass
        ``device='cpu'`` for the plain PyTorch path. The recurrent dots'
        precision follows ``model_cfg.matmul_precision``
        (``resolve_rnn_precision``), the other GEMMs its scope. A
        ``workdir`` with a checkpoint restores the state from the latest
        one (``start_epoch`` is its data epoch).

        ``eval_beam_width`` > 0 makes ``fit``'s periodic eval a beam
        search of that width; ``decode_cap_ratio`` scales the eval's decode
        cap (``decode_cap``); ``grapheme_word_sep_id`` (the grapheme
        stream's word-break id) adds the grapheme head's WER to the greedy
        eval. ``default_decode_steps`` is kept as the reference keeps it,
        for its CLI (the preset's ``max_target_len``).

        ``mesh``: train as this process's rank of it, on its device (a
        ``device`` given beside it must be the same). Every rank reads the
        workdir's checkpoint, so ranks on several hosts share a filesystem."""
        if mesh is not None:
            if device is not None and torch.device(device) != mesh.device:
                raise ValueError(f"device {device} is not the mesh rank's device {mesh.device}")
            device = mesh.device
        self.mesh = mesh
        self.device = resolve_device(device)
        self.default_decode_steps = default_decode_steps
        self.eval_beam_width = eval_beam_width
        self.decode_cap_ratio = decode_cap_ratio
        self.grapheme_word_sep_id = grapheme_word_sep_id
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
        self._dims: Dict[str, Optional[int]] = {}
        self._work = None  # under a mesh: the gathered whole params of the step's forward
        if mesh is not None:
            self.shard_state_to_mesh()

    def shard_state_to_mesh(self) -> None:
        """Cut the whole state (fresh or restored, Adam moments included) to
        this rank's slices along ``sharded_dims``; the generator stays
        whole, the same on every rank. The constructor calls it once."""
        st, mesh = self.state, self.mesh
        self._dims = sharded_dims(st.params, mesh)
        keys = [k for k, _ in named_leaves(st.params)]
        cut = lambda ts: [shard_tensor(t, self._dims[k], mesh) for k, t in zip(keys, ts)]
        st.opt_state = AdamState(st.opt_state.count, cut(st.opt_state.mu), cut(st.opt_state.nu))
        st.params = shard_params(st.params, mesh)

    def whole_state(self) -> TrainState:
        """The state with whole leaves: under a mesh the slices all-gathered
        over each data row (a collective), else the state itself."""
        st, mesh = self.state, self.mesh
        if mesh is None:
            return st
        keys = [k for k, _ in named_leaves(st.params)]
        whole = lambda ts: [t if self._dims[k] is None else mesh.gather_model(t, self._dims[k])
                            for k, t in zip(keys, ts)]
        return TrainState(
            st.step, gather_params(st.params, mesh, self._dims),
            AdamState(st.opt_state.count, whole(st.opt_state.mu), whole(st.opt_state.nu)), st.generator,
        )

    def _scope(self):
        return matmul_precision_scope(self.model_cfg.matmul_precision)

    def warm_start(self, params: LASParams) -> None:
        """Set every leaf of the state's params (CMVN stats included) from
        ``params``, as the reference's CLI replaces ``state.params`` with a
        warm-start checkpoint before the first step."""
        if self.mesh is not None:
            params = shard_params(params, self.mesh)
        src = dict(named_leaves(params))
        with torch.no_grad():
            for key, t in named_leaves(self.state.params):
                t.copy_(src[key])

    def device_batch(self, batch: Dict) -> Dict[str, torch.Tensor]:
        return {k: torch.as_tensor(v).to(self.device) for k, v in batch.items() if k in _BATCH_SPECS}

    def _device_batch(self, batch: Dict) -> Dict[str, torch.Tensor]:
        """This rank's rows of a host batch on the device (a batch the
        prefetcher already moved is taken as it is)."""
        if isinstance(batch, _DeviceBatch):
            return batch
        return self.device_batch(batch if self.mesh is None else local_rows(batch, self.mesh))

    def _global_count(self, count: torch.Tensor) -> torch.Tensor:
        return self.mesh.sum_data(count.clone())

    def _step_generator(self) -> torch.Generator:
        """The step's random draws: the state's generator; under a mesh with
        several data ranks, a generator of this data rank's own, seeded by
        ``data_rank_seed`` (its rows need draws of their own; the ranks of a
        data row draw alike). The state's generator then stays as it is."""
        gen = self.state.generator
        if self.mesh is None or self.mesh.data == 1:
            return gen
        seed = data_rank_seed(gen, self.state.step, self.mesh.data_index)
        return torch.Generator(device=self.device).manual_seed(seed)

    def loss(self, batch: Dict, train: bool = True):
        """The forward half of a step: ``compute_loss(train=train)`` with the
        state's generator and the scheduled-sampling ramp → (loss, aux).
        Under a mesh: on the gathered whole params, over this rank's rows,
        the loss being this rank's share of the global batch's
        (``compute_loss``'s ``global_count``)."""
        st, cfg, tc = self.state, self.model_cfg, self.train_cfg
        sp = None
        if tc.sampling_ramp_steps > 0:
            sp = cfg.speller.sampling_probability * min(1.0, st.step / tc.sampling_ramp_steps)
        if self.mesh is not None:
            self._work = gather_params(st.params, self.mesh, self._dims)
        with self._scope():
            return compute_loss(
                self._whole_params(), cfg, self._device_batch(batch), train=train,
                generator=self._step_generator() if train else None, sampling_probability=sp, prec=self.prec,
                global_count=None if self.mesh is None else self._global_count,
            )

    def _whole_params(self) -> LASParams:
        """The params the step's forward runs on and its gradients land on."""
        return self.state.params if self.mesh is None else self._work

    def gradients(self) -> Dict[str, torch.Tensor]:
        """{leaf path: the masked gradient of the global batch's loss, whole}
        after ``loss(...).backward()``: under a mesh the ranks' gradients
        summed over the data ranks (the ranks of a data row computed the
        same rows, so the sum runs over one model column)."""
        leaves = list(named_leaves(self._whole_params()))
        grads = mask_grads({k: t.grad for k, t in leaves}, self._whole_params())
        if self.mesh is None:
            return grads
        flat = self.mesh.sum_data(torch.cat([grads[k].reshape(-1) for k, _ in leaves]))
        out, ofs = {}, 0
        for k, t in leaves:
            out[k] = flat[ofs: ofs + t.numel()].view_as(t)
            ofs += t.numel()
        return out

    def _grad_norm(self, g: List[torch.Tensor]) -> torch.Tensor:
        """The global norm of this rank's gradient slices: the squares of the
        sharded slices summed over the data row, plus the replicated leaves'."""
        if self.mesh is None or self.mesh.model == 1:
            return global_norm(g)
        keys = [k for k, _ in named_leaves(self.state.params)]
        sq = lambda sharded: sum((torch.sum(t * t) for k, t in zip(keys, g) if (self._dims[k] is not None) == sharded),
                                 torch.zeros((), device=self.device))
        return torch.sqrt(self.mesh.sum_model(sq(True)) + sq(False))

    def apply_gradients(self, grads: Optional[Dict[str, torch.Tensor]] = None) -> Dict:
        """The optimizer half of a step, on ``grads`` (``gradients()`` when
        None): clip by global norm, Adam, ``-lr(step)`` on this rank's
        slices; then step += 1 and the gradients are cleared →
        {'grad_norm' (of the masked gradients, before clipping), 'lr'}."""
        st = self.state
        if grads is None:
            grads = self.gradients()
        leaves = list(named_leaves(st.params))
        g = [grads[k] if self.mesh is None else shard_tensor(grads[k], self._dims[k], self.mesh) for k, _ in leaves]
        g_norm = self._grad_norm(g)
        lr = lr_schedule(self.train_cfg)(st.step)
        updates, st.opt_state = self.tx.update(g, st.opt_state, g_norm)
        apply_updates([t for _, t in leaves], updates)
        for _, t in named_leaves(self._whole_params()):
            t.grad = None
        self._work = None
        st.step += 1
        return {"grad_norm": g_norm, "lr": lr}

    def train_step(self, batch: Dict) -> Dict:
        """One optimizer step (``loss``, its backward, ``apply_gradients``)
        → {'loss', 'grad_norm', 'lr', and the per-head losses}, losses as
        detached tensors (no device sync); under a mesh, the global batch's
        (the ranks' shares summed). Under a mesh ``batch`` is a host batch."""
        for _, t in named_leaves(self.state.params):
            t.grad = None
        with self._scope():
            loss, aux = self.loss(batch)
            loss.backward()
            out = {"loss": loss.detach(), **self.apply_gradients()}
        for k in ("phone_loss", "grapheme_loss", "binf_loss", "ctc_loss"):
            if k in aux:
                out[k] = aux[k].detach()
        if self.mesh is not None:
            keys = [k for k in out if k.endswith("loss")]
            out.update(zip(keys, self.mesh.sum_data(torch.stack([out[k] for k in keys]))))
        return out

    def _save_due(self, step: int, first: bool) -> bool:
        """Whether step ``step`` of the loop asks the checkpoint policy at
        all: every step without a mesh; under one only the steps that every
        rank names alike, so that the others start no collective and make
        the host wait for no device: the loop's first step (a fresh workdir
        saves it), multiples of ``checkpoint_every`` and, with
        ``checkpoint_every_secs``, the log steps, where rank 0's clock is
        read."""
        tc = self.train_cfg
        return (self.mesh is None or first or step % self.ckpt.save_every == 0
                or (tc.checkpoint_every_secs > 0 and step % tc.log_every == 0))

    def _save(self, step: int, epoch: int, force: bool = False) -> bool:
        """``CheckpointManager.save`` of the whole state; under a mesh on
        rank 0's decision, written by rank 0 while the others wait."""
        if self.mesh is None:
            return self.ckpt.save(step, self.state, epoch=epoch, force=force)
        if not self.mesh.agree(self.ckpt.should_save(step, force)):
            return False
        whole = self.whole_state()
        if self.mesh.rank == 0:
            self.ckpt.save(step, whole, epoch=epoch, force=True)
        self.mesh.barrier()
        return True

    # ------------------------------------------------------------------
    def _prefetched(self, batches: Iterable[Dict]) -> Iterator[Tuple[Dict, Dict[str, torch.Tensor]]]:
        """→ (host batch, device batch) pairs, with batch N+1's host→device
        copy started before batch N is handed out, so it runs while step N
        does. On CUDA the host arrays are pinned and copied without
        blocking on a stream of their own; the step's stream waits for the
        copy's event before it uses the tensors. The pinned tensors live in
        the pair until the step that consumes it. Audio stays int16. Under
        a mesh only this rank's rows are copied."""
        cuda = self.device.type == "cuda"
        copy_stream = torch.cuda.Stream(self.device) if cuda else None

        def start(batch):
            rows = batch if self.mesh is None else local_rows(batch, self.mesh)
            host = _DeviceBatch({k: torch.as_tensor(np.asarray(v)) for k, v in rows.items() if k in _BATCH_SPECS})
            if not cuda:
                return batch, host, None
            pinned = {k: t.pin_memory() for k, t in host.items()}
            with torch.cuda.stream(copy_stream):
                dev = _DeviceBatch({k: t.to(self.device, non_blocking=True) for k, t in pinned.items()})
                done = copy_stream.record_event()
            return batch, dev, (done, pinned)

        def finish(item):
            batch, dev, pending = item
            if pending is not None:
                stream = torch.cuda.current_stream(self.device)
                stream.wait_event(pending[0])
                for t in dev.values():
                    t.record_stream(stream)  # allocated on the copy stream, used on this one
            return batch, dev

        prev = None
        for b in batches:
            item = start(b)
            if prev is not None:
                yield finish(prev)
            prev = item
        if prev is not None:
            yield finish(prev)

    def fit(
        self,
        batches,
        *,
        eval_batches_fn: Optional[Callable[[], Iterable[Dict]]] = None,
        writer=None,
        log_fn=print,
    ) -> TrainState:
        """Train until ``num_steps``. ``batches`` is a plain batch iterator
        or a ``DataSource``. Over a ``DataSource`` the data epoch is tracked
        and saved with each checkpoint, and a resumed trainer replays its
        ``start_epoch`` from the epoch's first batch, as the reference does
        (a save at the last step of epoch e records e, so a run resumed
        from it trains epoch e again). A plain iterator saves epoch 0.

        Each window of ``log_every`` steps logs its mean loss and utt/s;
        every ``eval_every`` steps, with ``eval_batches_fn``, the eval leg
        runs (beam search at ``eval_beam_width`` when it is > 0). With a
        workdir each step is saved under the manager's policy
        (``checkpoint_every``), and also when ``checkpoint_every_secs``
        have passed since the last save; the last step is saved at the end.
        ``writer`` (any object with ``write_scalars(step, dict)`` and
        ``write_images(step, dict)``) receives the train and ``eval/``
        scalars and the eval's attention image."""
        kw = dict(eval_batches_fn=eval_batches_fn, writer=writer, log_fn=log_fn)
        if hasattr(batches, "epoch") and hasattr(batches, "repeat"):
            return self._fit_source(batches, **kw)
        return self._fit_iter(batches, None, **kw)

    def _fit_source(self, source, **kw) -> TrainState:
        epoch = self.start_epoch
        while self.state.step < self.train_cfg.num_steps:
            before = self.state.step
            self._fit_iter(source.epoch(epoch), epoch, final_save=False, **kw)
            if self.state.step == before:
                raise ValueError(f"epoch {epoch} of the data source gave no batch: nothing to train on")
            epoch += 1
        if self.ckpt is not None:
            self._save(self.state.step, epoch, force=True)
            self.ckpt.wait()
        return self.state

    def _fit_iter(
        self,
        batches: Iterable[Dict],
        epoch: Optional[int],
        *,
        eval_batches_fn=None,
        writer=None,
        log_fn=print,
        final_save: bool = True,
    ) -> TrainState:
        tc = self.train_cfg
        t0, window = time.time(), []
        last_ckpt_time = time.time()
        step = first = self.state.step
        # utterances a step: the global batch (under --multihost, data ranks × this process's)
        per_process = self.mesh is not None and self.mesh.local_batches
        rows_per = self.mesh.data if per_process else 1
        pairs = self._prefetched(batches)
        try:
            for batch, dbatch in pairs:
                if step >= tc.num_steps:
                    break
                out = self.train_step(dbatch)
                # losses stay on the device until a log line needs them
                window.append(out["loss"])
                step += 1
                if step % tc.log_every == 0 or step == tc.num_steps:
                    msg = {
                        "step": step, "loss": float(torch.stack(window).mean()),
                        "utt_per_sec": round(len(window) * len(batch["audio"]) * rows_per / (time.time() - t0), 2),
                        "lr": float(out["lr"]), "grad_norm": float(out["grad_norm"]),
                    }
                    log_fn({"tag": "train", **msg})
                    if writer is not None:
                        writer.write_scalars(step, {k: v for k, v in msg.items() if k != "step"})
                    t0, window = time.time(), []
                if eval_batches_fn is not None and step % tc.eval_every == 0:
                    ev = self.evaluate(eval_batches_fn(), writer=writer, step=step, beam_width=self.eval_beam_width)
                    log_fn({"tag": "eval", "step": step, **ev})
                    if writer is not None:
                        writer.write_scalars(step, {f"eval/{k}": v for k, v in ev.items()})
                if self.ckpt is not None and self._save_due(step, step == first + 1):
                    force = (
                        tc.checkpoint_every_secs > 0
                        and time.time() - last_ckpt_time >= tc.checkpoint_every_secs
                        and self.ckpt.latest_step() != step
                    )
                    if self._save(step, epoch or 0, force=force):
                        last_ckpt_time = time.time()
        finally:
            pairs.close()  # an abandoned DataSource epoch cancels its producer
        if final_save and self.ckpt is not None:
            self._save(self.state.step, epoch or 0, force=True)
            self.ckpt.wait()
        return self.state

    # ------------------------------------------------------------------
    def evaluate(
        self,
        batches: Iterable[Dict],
        max_steps: Optional[int] = None,
        *,
        writer=None,
        step: Optional[int] = None,
        beam_width: int = 0,
    ) -> Dict:
        """Eval leg: the teacher-forced loss on the same encoding, then a
        greedy decode (or a beam search when ``beam_width`` > 0) at
        ``max_steps`` or the batch's ``decode_cap``, scored by edit-distance
        PER (under ``score_fold``), with the rate of rows that hit the cap.
        Greedy also scores the grapheme head (CER, and WER with
        ``grapheme_word_sep_id``) and, given a ``writer``, writes the
        attention image of the first batch's row 0 at ``step``. Under a
        mesh every rank runs it: each decodes its rows on the whole params
        and the counts are summed over the data ranks."""
        if beam_width:
            return self._evaluate_beam(batches, max_steps, beam_width)
        return self._evaluate_greedy(batches, max_steps, writer, step)

    def _eval_params(self):
        """The whole params for a local decode (under a mesh, gathered once
        an ``evaluate``)."""
        if self.mesh is None:
            return self.state.params
        return gather_params(self.state.params, self.mesh, self._dims)

    def _eval_rows(self, batch: Dict) -> Dict:
        return batch if self.mesh is None else local_rows(batch, self.mesh)

    def _allreduce_metrics(self, values) -> np.ndarray:
        """Sum a small metric vector over the data ranks, in float64."""
        vec = np.asarray(values, np.float64)
        if self.mesh is None:
            return vec
        return self.mesh.sum_data(torch.as_tensor(vec, device=self.device)).cpu().numpy()

    def _encode_eval(self, params, batch: Dict):
        """→ (device batch, (memory, enc_lens, enc_mask), teacher-forced loss,
        under a mesh this rank's share of the global batch's)."""
        cfg = self.model_cfg
        b = self.device_batch(batch)
        encoded = encode(params, cfg, b["audio"], b["audio_lengths"], prec=self.prec)
        loss, _ = compute_loss(params, cfg, b, train=False, encoded=encoded, prec=self.prec,
                               global_count=None if self.mesh is None else self._global_count)
        return b, encoded, float(loss)

    @staticmethod
    def _num_real(batch: Dict, rows: int) -> int:
        n_real = batch.get("num_real")
        return rows if n_real is None else int(n_real)

    def _evaluate_beam(self, batches: Iterable[Dict], max_steps: Optional[int], beam_width: int) -> Dict:
        cfg = self.model_cfg
        dist = tokens = cap_hits = eval_utts = 0
        losses = []
        with torch.no_grad(), self._scope():
            params = self._eval_params()
            for batch in batches:
                batch = self._eval_rows(batch)
                steps_cap = max_steps or self.decode_cap(batch)
                _, (memory, _, enc_mask), loss = self._encode_eval(params, batch)
                losses.append(loss)
                res = beam_decode(
                    params.speller, cfg.speller, memory, enc_mask, steps_cap, beam_width=beam_width, prec=self.prec
                )
                toks, lens = res.tokens.cpu().numpy(), res.lengths.cpu().numpy()
                n_real = self._num_real(batch, lens.shape[0])
                cap_hits += int((lens[:n_real] >= steps_cap).sum())
                eval_utts += n_real
                d, t = M.edit_distance_stats(
                    toks, lens, np.asarray(batch["targets"]), np.asarray(batch["target_lengths"]) - 1,
                    num_real=batch.get("num_real"), fold=self.score_fold,
                )
                dist, tokens = dist + d, tokens + t
        *counts, loss_sum = self._allreduce_metrics([dist, tokens, cap_hits, eval_utts, np.sum(losses)])
        dist, tokens, cap_hits, eval_utts = (int(x) for x in counts)
        res = {
            "loss": float(loss_sum) / len(losses) if losses else float("nan"),
            "per": M.per_from_stats(dist, tokens),
            "ref_tokens": tokens,
        }
        if eval_utts:
            res["cap_hit_rate"] = cap_hits / eval_utts
        return res

    def _evaluate_greedy(
        self, batches: Iterable[Dict], max_steps: Optional[int], writer=None, step: Optional[int] = None
    ) -> Dict:
        cfg = self.model_cfg
        dist = tokens = g_dist = g_tokens = w_dist = w_words = cap_hits = eval_utts = 0
        losses = []
        first_image = None
        with torch.no_grad(), self._scope():
            params = self._eval_params()
            for batch in batches:
                batch = self._eval_rows(batch)
                steps_cap = max_steps or self.decode_cap(batch)
                _, (memory, enc_lens, enc_mask), loss = self._encode_eval(params, batch)
                losses.append(loss)
                # tokens through the fused kernel on CUDA, which returns no
                # alignments; the image re-decodes one row in the loop
                toks, lens, _ = greedy_decode(params.speller, cfg.speller, memory, enc_mask, steps_cap, prec=self.prec)
                toks, lens = toks.cpu().numpy(), lens.cpu().numpy()
                n_real = self._num_real(batch, lens.shape[0])
                # derailment signal: a decode that never emitted <eos> ran to the cap
                cap_hits += int((lens[:n_real] >= steps_cap).sum())
                eval_utts += n_real
                if writer is not None and first_image is None and batch.get("num_real", 1) > 0:
                    _, row_len, aligns = greedy_decode_steps(
                        params.speller, cfg.speller, memory[:1], enc_mask[:1], steps_cap,
                        return_alignments=True, prec=self.prec,
                    )
                    first_image = M.attention_image(
                        aligns[0].cpu().numpy(), int(row_len[0]) or 1, int(enc_lens[0])
                    )
                d, t = M.edit_distance_stats(
                    toks, lens, np.asarray(batch["targets"]),
                    np.asarray(batch["target_lengths"]) - 1,  # exclude <eos>
                    num_real=batch.get("num_real"), fold=self.score_fold,
                )
                dist, tokens = dist + d, tokens + t
                if params.grapheme_speller is not None and "grapheme_targets" in batch:
                    gt, gl, _ = greedy_decode(
                        params.grapheme_speller, cfg.grapheme_speller, memory, enc_mask, steps_cap, prec=self.prec
                    )
                    gt, gl = gt.cpu().numpy(), gl.cpu().numpy()
                    g_ref = np.asarray(batch["grapheme_targets"])
                    g_ref_lens = np.asarray(batch["grapheme_lengths"]) - 1
                    d, t = M.edit_distance_stats(gt, gl, g_ref, g_ref_lens, num_real=batch.get("num_real"))
                    g_dist, g_tokens = g_dist + d, g_tokens + t
                    if self.grapheme_word_sep_id is not None:
                        d, t = M.word_error_stats(
                            gt, gl, g_ref, g_ref_lens, self.grapheme_word_sep_id, num_real=batch.get("num_real")
                        )
                        w_dist, w_words = w_dist + d, w_words + t
        if writer is not None and first_image is not None:
            writer.write_images(
                step if step is not None else self.state.step, {"attention_alignment": first_image[None]}
            )
        *counts, loss_sum = self._allreduce_metrics(
            [dist, tokens, g_dist, g_tokens, w_dist, w_words, cap_hits, eval_utts, np.sum(losses)]
        )
        dist, tokens, g_dist, g_tokens, w_dist, w_words, cap_hits, eval_utts = (int(x) for x in counts)
        res = {
            "loss": float(loss_sum) / len(losses) if losses else float("nan"),
            "per": M.per_from_stats(dist, tokens),
            "ref_tokens": tokens,
        }
        if eval_utts:
            res["cap_hit_rate"] = cap_hits / eval_utts
        if g_tokens:
            res["cer"] = M.per_from_stats(g_dist, g_tokens)
            res["grapheme_ref_tokens"] = g_tokens
        if w_words:
            res["wer"] = M.per_from_stats(w_dist, w_words)
            res["ref_words"] = w_words
        return res

    def decode_cap(self, batch: Dict) -> int:
        """Per-batch decode-step cap: ``decode_cap_ratio`` × the batch's
        encoder frames, at least 16 (the reference's rule)."""
        cfg = self.model_cfg
        audio = batch["audio"]
        if cfg.input_is_pcm and getattr(audio, "ndim", 2) == 2:
            t = frames_for_samples(audio.shape[1], cfg.frontend)
        else:
            t = audio.shape[1]
        for _ in range(cfg.listener.num_layers - 1):
            t = (t + 1) // 2
        return max(16, int(self.decode_cap_ratio * t))
