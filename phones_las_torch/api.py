"""Library API: load a model artifact and transcribe audio (port of the
artifact path of ``phones_las_tpu/api.py``).

Example::

    from phones_las_torch.api import Transcriber

    t = Transcriber("runs/timit", beam_width=8)                # a training workdir, on CUDA
    t = Transcriber.from_artifact("model.npz", beam_width=8)   # or one exported file
    print(t.transcribe(pcm_int16_array))                      # ['sil', 'ʃ', ...]
    print(t.transcribe_long(one_hour_of_pcm))
    t.export_artifact("model.npz")                            # workdir → one file

``device=None`` means CUDA and raises without one; ``device="cpu"`` runs the
plain PyTorch path. On CUDA the front-end and the listener run their CUDA
kernels, and greedy decoding of a configuration the fused decoder takes
runs its kernel (at every batch size, float32 in both numerics modes);
beam search, the speller-step loop, CTC and LM fusion are plain PyTorch
on either device. Every decode runs inside the config's
``matmul_precision`` scope (``utils/device.py::matmul_precision_scope``).

Several cards: ``data_parallel=N`` splits each wave into N equal shards,
each decoded on its own card with its own copy of the parameters, all
launched from one thread and gathered on the host (one giant offline
batch); ``replicate(N)`` makes N single-card copies for a server whose
drainers take whole micro-batches each (``cli/serve.py``). Both take a
``devices=`` list that may name one device more than once. The reference's
``implementation`` switch has no counterpart: the port has one.
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import json
import os
import threading
from typing import List, Optional, Sequence

import numpy as np
import torch

from phones_las_torch.utils.diagnostics import annotate


def _smoothed_energy(audio: np.ndarray, frame: int, smooth: int) -> np.ndarray:
    """Per-frame RMS energy, mean-smoothed over ``smooth`` frames.

    The smoothing is edge-adaptive (the mean over the neighbours that
    exist), so interior frames get the same values whether the array is a
    whole recording or a streaming buffer slice.
    """
    nf = audio.shape[0] // frame
    x = audio[: nf * frame].astype(np.float64).reshape(nf, frame)
    e = np.sqrt((x * x).mean(axis=1))
    if smooth > 1 and nf > 0:
        c = np.concatenate([[0.0], np.cumsum(e)])
        half = smooth // 2
        lo = np.maximum(np.arange(nf) - half, 0)
        hi = np.minimum(np.arange(nf) + half + 1, nf)
        e = (c[hi] - c[lo]) / (hi - lo)
    return e


class PauseSegmenter:
    """Cut-point rule for pause-snapped long-form segmentation.

    Nominal cuts sit every ``window_samples``; each is snapped to the
    centre of the longest low-energy run of the smoothed short-time energy
    within ±``search_samples`` of its nominal position, so segments start
    and end in silence, like training utterances. The threshold between
    "quiet" and "speech" comes from the search region alone (min + 25 % of
    the min→median spread). Framing is absolute (frame k covers samples
    ``[k·f, (k+1)·f)`` of the recording), so a streaming caller that holds
    back ``margin`` samples of lookahead picks the offline cuts.
    """

    def __init__(self, sample_rate: int, window_samples: int,
                 search_samples: int, *, frame_seconds: float = 0.010,
                 smooth_frames: int = 5):
        if not 0 < search_samples < window_samples // 2:
            raise ValueError(
                f"need 0 < search ({search_samples}) < window/2 "
                f"({window_samples // 2})"
            )
        self.f = max(1, int(frame_seconds * sample_rate))
        self.win = int(window_samples)
        self.search = int(search_samples)
        self.smooth = int(smooth_frames)
        # lookahead past target+search before a cut is final
        self.margin = (self.smooth // 2 + 1) * self.f
        # longest segment two snapped cuts can produce: the decode pad length
        self.max_segment = self.win + 2 * self.search

    def next_cut(self, audio: np.ndarray, base: int, prev_cut: int,
                 total: int, ended: bool) -> Optional[int]:
        """Next absolute cut after ``prev_cut``, or None.

        ``audio`` covers absolute samples ``[base, base + len(audio))``
        with ``base % f == 0`` and ``base <= prev_cut``; ``total`` is the
        stream length so far. None means: need more audio
        (``ended=False``), or the remainder is the final tail segment.
        """
        assert base % self.f == 0 and base <= prev_cut, (base, prev_cut)
        target = prev_cut + self.win
        if ended:
            if total <= target + self.search:
                return None
        elif total < target + self.search + self.margin:
            return None
        e = _smoothed_energy(audio, self.f, self.smooth)
        b0 = base // self.f
        # frames fully inside [target-search, target+search] ∩ (prev_cut, total]
        lo = max(-(-(target - self.search) // self.f), prev_cut // self.f + 1)
        hi = min((target + self.search) // self.f, b0 + e.shape[0])
        if hi <= lo:  # degenerate (tiny window/search): cut at nominal
            return min(target, total)
        region = e[lo - b0 : hi - b0]
        thr = region.min() + 0.25 * (np.median(region) - region.min())
        quiet = np.flatnonzero(region <= thr)
        if quiet.size == 0:  # flat region: median == min
            k = lo + int(np.argmin(region))
        else:
            # maximal runs of consecutive quiet frames; the widest wins,
            # ties broken by lower mean energy
            starts = np.flatnonzero(np.diff(quiet, prepend=quiet[0] - 2) > 1)
            runs = np.split(quiet, starts[1:]) if starts.size else [quiet]
            best = min(runs, key=lambda r: (-r.size, region[r].mean()))
            k = lo + int(best[best.size // 2])
        return k * self.f + self.f // 2


def find_pause_cuts(audio: np.ndarray, sample_rate: int,
                    window_samples: int, search_samples: int) -> List[int]:
    """Pause-snapped segment boundaries of a whole recording:
    ``[0, cut_1, ..., len(audio)]`` (see ``PauseSegmenter``)."""
    audio = np.asarray(audio)
    n = int(audio.shape[0])
    seg = PauseSegmenter(sample_rate, window_samples, search_samples)
    cuts = [0]
    while True:
        c = seg.next_cut(audio, 0, cuts[-1], n, ended=True)
        if c is None:
            break
        cuts.append(int(c))
    cuts.append(n)
    return cuts


def merge_window_hypotheses(
    per_window: Sequence, starts: Sequence[int], overlap: int
) -> List[int]:
    """Merge per-window ``(token_ids, token_times)`` into one sequence.

    ``times`` are absolute sample positions; consecutive windows overlap
    by ``overlap`` samples and are cut at the overlap's midpoint: window i
    contributes tokens strictly before it, window i+1 from it on.
    """
    merged: List[int] = []
    n = len(per_window)
    for i, (ids, times) in enumerate(per_window):
        lo = -np.inf if i == 0 else starts[i] + overlap / 2.0
        hi = np.inf if i == n - 1 else starts[i + 1] + overlap / 2.0
        for tok, tm in zip(ids, times):
            if lo <= tm < hi:
                merged.append(int(tok))
    return merged


# the rows one copy to the card takes on the pinned path: about 4 MB, so the
# copy of one group overlaps the filling of the next
STAGE_GROUP_BYTES = 4 << 20
# the wire dtypes (``Transcriber._wire_dtype``) as torch's
_TORCH_DTYPE = {np.dtype(np.int16): torch.int16, np.dtype(np.float32): torch.float32}


class _Slot:
    """One host buffer of a ``StagingRing``: its bytes, the lock a thread
    holds from filling it to recording the event behind its copies, and
    that event."""

    def __init__(self):
        self.buf: Optional[torch.Tensor] = None  # flat uint8
        self.lock = threading.Lock()
        self.copied = None  # a CUDA event behind the last copy out of it


class StagingRing:
    """Host buffers reused wave after wave, pinned (plain memory where
    there is no CUDA to pin it). A thread takes the next free slot (or
    waits for the next in turn), waits for the last copy out of it to end,
    fills it, queues its copies and gives it back; two slots, so one
    wave's filling does not wait for the previous wave's copy."""

    def __init__(self):
        self.slots = [_Slot(), _Slot()]
        self._next = 0
        self._choose = threading.Lock()

    @contextlib.contextmanager
    def hold(self, nbytes: int):
        """A slot of at least ``nbytes`` bytes, held by this thread alone,
        no copy out of it in flight; grown where it is smaller."""
        with self._choose:
            order = self.slots[self._next:] + self.slots[: self._next]
            slot = next((s for s in order if s.lock.acquire(blocking=False)), None)
            if slot is None:  # every slot held: wait for the next in turn
                slot = order[0]
                slot.lock.acquire()
            self._next = (self.slots.index(slot) + 1) % len(self.slots)
        try:
            if slot.copied is not None:
                slot.copied.synchronize()
            if slot.buf is None or slot.buf.numel() < nbytes:
                slot.buf = None  # the old one freed before the new is made
                slot.buf = torch.empty(nbytes, dtype=torch.uint8, pin_memory=torch.cuda.is_available())
                stage_wave.growths += 1
            yield slot
        finally:
            slot.lock.release()


def stage_wave(rows: Sequence, wave: int, pad: int, dtype, device=None, ring: Optional[StagingRing] = None):
    """One wave's rows (1-D, at most ``wave`` of them, none longer than
    ``pad``) → ``Transcriber._decode``'s inputs: ``audio`` [wave, pad] in
    ``dtype`` (each row's samples, then zeros; rows past the last all zero)
    and ``lengths`` [wave] int32.

    Through ``ring``: the rows are filled into a slot a group of about
    ``STAGE_GROUP_BYTES`` at a time, each group's copy to ``device`` queued
    as soon as it is filled (asynchronous and stream-ordered from pinned
    memory, so the copy of one group overlaps the filling of the next),
    the lengths copied from the same slot, and a CUDA event recorded
    behind the copies before the slot is given back. Without a ring: a
    fresh array, copied with ``.to(device)``, or left on the host where
    ``device`` is None. Counts the waves each way (``pinned_waves``,
    ``plain_waves``) and the slots' allocations (``growths``)."""
    n = len(rows)
    if ring is None:
        stage_wave.plain_waves += 1
        audio = np.zeros((wave, pad), dtype)
        lengths = np.zeros((wave,), np.int32)
        for i, a in enumerate(rows):
            audio[i, : len(a)] = a
            lengths[i] = len(a)
        if device is None:
            return audio, lengths
        return torch.from_numpy(audio).to(device), torch.from_numpy(lengths).to(device)
    stage_wave.pinned_waves += 1
    tdt = _TORCH_DTYPE[np.dtype(dtype)]
    row_bytes = pad * np.dtype(dtype).itemsize
    ofs = -(-wave * 4 // 64) * 64  # the lengths first, the rows 64-byte aligned after them
    audio = torch.empty((wave, pad), dtype=tdt, device=device)
    lengths = torch.empty((wave,), dtype=torch.int32, device=device)
    group = max(1, STAGE_GROUP_BYTES // max(1, row_bytes))
    with ring.hold(ofs + wave * row_bytes) as slot:
        h_lengths = slot.buf[: wave * 4].view(torch.int32)
        h_audio = slot.buf[ofs : ofs + wave * row_bytes].view(tdt).view(wave, pad)
        a_lengths, a_audio = h_lengths.numpy(), h_audio.numpy()
        a_lengths[:n] = [len(a) for a in rows]
        a_lengths[n:] = 0
        lengths.copy_(h_lengths, non_blocking=True)
        for g in range(0, wave, group):
            end = min(g + group, wave)
            for i in range(g, min(end, n)):
                a = rows[i]
                a_audio[i, : len(a)] = a
                a_audio[i, len(a) :] = 0
            a_audio[max(g, n) : end] = 0
            audio[g:end].copy_(h_audio[g:end], non_blocking=True)
        if audio.is_cuda:
            if slot.copied is None:
                slot.copied = torch.cuda.Event()
            slot.copied.record(torch.cuda.current_stream(audio.device))
    return audio, lengths


stage_wave.pinned_waves = 0
stage_wave.plain_waves = 0
stage_wave.growths = 0


def _staging_ring(devices: list) -> Optional[StagingRing]:
    """The pinned ring of a transcriber on one CUDA card; none on the CPU
    (a fresh array a wave: ``.to('cpu')`` would alias a reused buffer) or
    with ``data_parallel`` shards (host arrays, ``map_row_shards``)."""
    if len(devices) == 1 and torch.device(devices[0]).type == "cuda":
        return StagingRing()
    return None


def _devices(data_parallel: int, devices: Optional[Sequence], device) -> list:
    """The devices a transcriber decodes on (see ``Transcriber.__init__``)."""
    from phones_las_torch.parallel.mesh import pick_devices
    from phones_las_torch.utils.device import resolve_device

    if devices is not None and device is not None:
        raise ValueError("give device= or devices=, not both")
    if data_parallel == 1 and devices is None:
        return [resolve_device(device)]
    return pick_devices(data_parallel, devices, device)


class Transcriber:
    """A loaded model and its decode settings: from a training workdir
    (``Transcriber(workdir)``) or from one artifact file
    (``Transcriber.from_artifact``)."""

    def __init__(
        self,
        workdir: str,
        *,
        beam_width: Optional[int] = None,
        length_penalty: float = 0.0,
        head: str = "phone",
        max_device_batch: int = 64,
        data_parallel: int = 1,
        average_checkpoints: int = 1,
        lm: Optional[str] = None,
        lm_weight: float = 0.3,
        ctc_joint: Optional[float] = None,
        device=None,
        devices: Optional[Sequence] = None,
    ):
        """Serve a training run: replay its ``config.json`` (preset, data
        dir, overrides, precision) through ``resolve_preset``, read the
        params of the latest checkpoint (or the mean of the newest
        ``average_checkpoints``), whatever device type wrote it. ``beam_width=None`` takes the preset's;
        ``head='grapheme'`` decodes the multitask grapheme speller; ``lm``
        is an n-gram table file fused into beam search at ``lm_weight``;
        ``ctc_joint`` α turns on joint CTC/attention beam decoding.
        ``data_parallel`` > 1 shards each wave over that many devices (0:
        every card): the first of ``devices`` or else of the cards
        (``parallel/mesh.py::pick_devices``; more than there are raises)."""
        from phones_las_torch.cli.common import resolve_preset
        from phones_las_torch.train.checkpoint import load_averaged_params
        from phones_las_torch.train.loop import Trainer
        from phones_las_torch.utils.param_io import named_leaves

        devs = _devices(data_parallel, devices, device)
        if head not in ("phone", "grapheme"):
            raise ValueError(f"head must be 'phone' or 'grapheme', got {head!r}")
        with open(os.path.join(workdir, "config.json")) as f:
            cfg_file = json.load(f)
        # replay the overrides the run was trained with (shapes must match)
        preset, vocab, gvocab, _, binf_codes = resolve_preset(
            cfg_file["preset"], cfg_file["data"], cfg_file.get("overrides") or None
        )
        if cfg_file.get("precision"):
            preset = dataclasses.replace(
                preset, model=dataclasses.replace(preset.model, matmul_precision=cfg_file["precision"])
            )
        trainer = Trainer(preset.model, preset.train, binf_codes=binf_codes, device=devs[0])
        # the params alone (no optimizer state, no generator), so a checkpoint
        # written on one device type serves on another
        params, used = load_averaged_params(workdir, trainer.state, max(1, average_checkpoints))
        for _, t in named_leaves(params):
            t.requires_grad_(False)
        self._setup(params.eval(), preset.model, devs, max_device_batch,
                    preset.beam_width if beam_width is None else beam_width, length_penalty)
        self.head = head
        if lm is not None:
            if not self.beam:
                raise ValueError("lm fusion requires beam decoding (beam_width > 0)")
            from phones_las_torch.decode.lm import load_lm

            self.lm_logp = torch.from_numpy(load_lm(lm)).to(self.device)
            self.lm_weight = float(lm_weight)
        if ctc_joint is not None and head != "phone":
            raise ValueError("the CTC head scores phone targets: ctc_joint needs head='phone'")
        self._set_ctc_joint(ctc_joint)
        if head == "grapheme":
            if preset.model.grapheme_speller is None:
                raise ValueError(f"preset {cfg_file['preset']!r} has no grapheme speller")
            self.speller_cfg, self.vocab = preset.model.grapheme_speller, gvocab
            self.max_steps = preset.pipeline.max_grapheme_len or preset.pipeline.max_target_len
        else:
            self.speller_cfg, self.vocab = preset.model.speller, vocab
            self.max_steps = preset.pipeline.max_target_len
        self._set_buckets(preset.pipeline.buckets)
        self.step = used[-1]
        self.preset_name = cfg_file["preset"]

    def _setup(self, params, cfg, devices, max_device_batch, beam_width, length_penalty) -> None:
        from phones_las_torch.ops.lstm import resolve_rnn_precision

        self.max_device_batch = max_device_batch
        self._set_devices(devices, params)
        self.model_cfg = cfg
        self.prec = resolve_rnn_precision(cfg.matmul_precision)
        self.beam = beam_width
        self.length_penalty = length_penalty
        self.lm_logp = None  # an n-gram table (decode/lm.py) for beam fusion
        self.lm_weight = 0.0
        self.head = "phone"
        self._sample_rate = cfg.frontend.sample_rate

    def _set_devices(self, devices, params) -> None:
        """Decode on ``devices``: ``params`` on the first, a copy on each
        other (a shard of every wave each)."""
        from phones_las_torch.parallel.mesh import replicate

        self.devices = list(devices)
        self.device = self.devices[0]
        self.data_parallel = len(self.devices)
        self.params = params
        self._shard_params = [params] + replicate(params, self.devices[1:])
        self._ring = _staging_ring(self.devices)  # each transcriber its own, replicas too

    def _set_ctc_joint(self, ctc_joint: Optional[float]) -> None:
        self.ctc_joint = None if ctc_joint is None else float(ctc_joint)
        if self.ctc_joint is not None:
            if not self.beam:
                raise ValueError("ctc_joint requires beam decoding (beam_width > 0)")
            if self.params.ctc_w is None:
                raise ValueError("ctc_joint needs a model trained with ctc_weight > 0")

    def _set_buckets(self, buckets) -> None:
        self.buckets = [int(b) for b in buckets]
        # the longest audio of one training example: long-form windows are
        # sized to it
        self.train_max_samples = max(self.buckets)

    @classmethod
    def from_artifact(
        cls,
        path: str,
        *,
        beam_width: int = 0,
        length_penalty: float = 0.0,
        max_device_batch: int = 64,
        ctc_joint: Optional[float] = None,
        device=None,
        data_parallel: int = 1,
        devices: Optional[Sequence] = None,
    ) -> "Transcriber":
        """Serve from a flat-npz artifact whose ``__extras__`` carry
        vocab, buckets and max_target_len (read with numpy alone).
        ``beam_width`` 0 decodes greedily; ``ctc_joint`` α turns on
        one-pass joint CTC/attention beam decoding (needs the CTC head);
        ``device=None`` means CUDA; ``data_parallel`` and ``devices`` as
        for a workdir."""
        from phones_las_torch.data.vocab import Vocab
        from phones_las_torch.utils.param_io import load_artifact

        devs = _devices(data_parallel, devices, device)
        params, cfg, extras = load_artifact(path, device=devs[0])
        for k in ("vocab", "buckets", "max_target_len"):
            if k not in extras:
                raise ValueError(f"{path}: artifact has no '{k}' in __extras__")
        t = object.__new__(cls)
        t._setup(params, cfg, devs, max_device_batch, beam_width, length_penalty)
        t._set_ctc_joint(ctc_joint)
        t.speller_cfg = cfg.speller
        t.vocab = Vocab(list(extras["vocab"]))
        t.max_steps = int(extras["max_target_len"])
        t._set_buckets(extras["buckets"])
        t.step = extras.get("step")
        t.preset_name = extras.get("preset")
        return t

    def export_artifact(self, path: str) -> dict:
        """Write the served model as one flat-npz artifact that
        ``from_artifact`` (and the JAX package's ``load_artifact``) reads:
        the params, the config, and as extras the preset, vocab, training
        buckets, target cap and step → the extras."""
        from phones_las_torch.utils.param_io import save_params_npz

        if self.head != "phone":
            raise ValueError("an artifact serves the phone head; export with head='phone'")
        extras = {
            "preset": self.preset_name,
            "vocab": list(self.vocab.tokens),
            "buckets": self.buckets,
            "max_target_len": int(self.max_steps),
            "step": self.step,
        }
        save_params_npz(path, self.params, self.model_cfg, extras=extras)
        return extras

    def _speller(self, params):
        return params.grapheme_speller if self.head == "grapheme" else params.speller

    @property
    def sample_rate(self) -> int:
        return self._sample_rate

    def replicate(self, n: int = 0, devices: Optional[Sequence] = None) -> List["Transcriber"]:
        """``n`` single-device copies of this transcriber (0: one a card),
        each with its own copy of the parameters: on the first ``n`` of
        ``devices`` (which may repeat one) or of the cards of this one's
        device type. Replica-per-card serving: each copy takes whole
        micro-batches (``cli/serve.py::BatchingWorker``), where
        ``data_parallel`` shards one batch over all of them; the two are
        exclusive."""
        import copy

        from phones_las_torch.parallel.mesh import pick_devices, replicate

        if self.data_parallel > 1:
            raise ValueError("replicate() and data_parallel batch sharding are exclusive")
        devs = pick_devices(n, devices, None if devices is not None else self.device)
        out = []
        for d, params in zip(devs, replicate(self.params, devs)):
            t = copy.copy(self)
            t._set_devices([d], params)
            if self.lm_logp is not None:
                t.lm_logp = self.lm_logp.to(d)
            out.append(t)
        return out

    def _wave_size(self, n: int) -> int:
        """Utterances per dispatch: up to ``max_device_batch`` a device,
        a multiple of the data-parallel shards so they split evenly."""
        dp = self.data_parallel
        wave = min(n, self.max_device_batch * dp)
        return -(-wave // dp) * dp

    def _stage(self, rows: Sequence, wave: int, pad: int, dtype):
        """One wave's rows → its inputs to ``_decode`` (``stage_wave``): on
        the device (one device; through this transcriber's pinned ring on a
        card), or left on the host for ``data_parallel`` shards, which
        ``map_row_shards`` copies shard by shard."""
        return stage_wave(rows, wave, pad, dtype, None if self.data_parallel > 1 else self.device, self._ring)

    def _decode(self, audio, lengths, max_steps: int, params=None, aligned: bool = False):
        """One wave, as ``_stage`` gives it → (tokens [B, S], lengths [B],
        attention peaks [B, S] or None): on the device, as device tensors
        (not fetched); with ``data_parallel`` shards, gathered on the host."""
        from phones_las_torch.parallel.mesh import map_row_shards, replicate

        if self.data_parallel == 1:
            p = self.params if params is None else params
            return self._decode_on(p, audio, lengths, max_steps, aligned)
        if params is None:
            shard_params = self._shard_params
        else:  # stream-adapted params: one copy for each shard's device
            shard_params = [params] + replicate(params, self.devices[1:])
        return map_row_shards(
            lambda p, audio, lengths: self._decode_on(p, audio, lengths, max_steps, aligned),
            list(zip(self.devices, shard_params)), audio, lengths,
        )

    def _decode_on(self, p, audio: torch.Tensor, lengths: torch.Tensor, max_steps: int, aligned: bool):
        """One wave on ``audio``'s device with the params ``p`` there."""
        from phones_las_torch.decode import beam_decode, greedy_decode
        from phones_las_torch.models.las import ctc_logp, encode
        from phones_las_torch.utils.device import matmul_precision_scope

        lm_logp = None if self.lm_logp is None else self.lm_logp.to(audio.device)
        with torch.no_grad(), matmul_precision_scope(self.model_cfg.matmul_precision):
            with annotate("plt.encode"):
                memory, _, enc_mask = encode(p, self.model_cfg, audio, lengths, prec=self.prec)
            with annotate("plt.decode"):
                if self.beam:
                    res = beam_decode(
                        self._speller(p), self.speller_cfg, memory, enc_mask, max_steps,
                        beam_width=self.beam, length_penalty=self.length_penalty,
                        lm_logp=lm_logp, lm_weight=self.lm_weight,
                        ctc_logp=None if self.ctc_joint is None else ctc_logp(p, memory),
                        ctc_alpha=1.0 if self.ctc_joint is None else self.ctc_joint,
                        prec=self.prec,
                    )
                    return res.tokens, res.lengths, res.peaks
                toks, lens, aligns = greedy_decode(
                    self._speller(p), self.speller_cfg, memory, enc_mask, max_steps,
                    return_alignments=aligned, prec=self.prec,
                )
                peaks = torch.argmax(aligns, dim=-1).to(torch.int32) if aligned else None
                return toks, lens, peaks

    @staticmethod
    def _wire_dtype(audio: Sequence[np.ndarray]):
        """int16 when every input is int16 (half the host→device bytes;
        the front-end takes raw PCM values either way), else float32."""
        return np.int16 if all(np.asarray(a).dtype == np.int16 for a in audio) else np.float32

    def transcribe_batch(
        self, audio: Sequence[np.ndarray], *, pad_quantum: int = 32000
    ) -> List[List[str]]:
        """PCM int16/float arrays → token sequences, one per utterance.

        The batch is padded to a multiple of ``pad_quantum`` samples;
        batches beyond ``max_device_batch`` go as waves of that size (the
        tail wave zero-padded), all dispatched before any result is
        fetched. Each stage is a span (``annotate``), all within
        ``plt.transcribe_batch``: a wave's ``plt.stage`` (``_stage``: the
        rows padded into a reused pinned buffer on a card, and the copies
        to the device), ``plt.encode`` and ``plt.decode``, then after
        every dispatch a wave's ``plt.fetch`` and ``plt.strings``."""
        with annotate("plt.transcribe_batch"):
            b = len(audio)
            lens = np.asarray([a.shape[0] for a in audio], np.int32)
            pad = ((int(lens.max()) + pad_quantum - 1) // pad_quantum) * pad_quantum
            wave = self._wave_size(b)
            dt = self._wire_dtype(audio)
            results = []
            for ofs in range(0, b, wave):
                n = min(wave, b - ofs)
                with annotate("plt.stage"):
                    staged = self._stage(audio[ofs : ofs + n], wave, pad, dt)
                results.append((n, self._decode(*staged, self.max_steps)))
            out: List[List[str]] = []
            for n, (toks, out_lens, _) in results:  # fetch after all dispatches
                with annotate("plt.fetch"):
                    toks, out_lens = toks.cpu().numpy(), out_lens.cpu().numpy()
                with annotate("plt.strings"):
                    out += [self.vocab.decode(toks[i][: out_lens[i]]) for i in range(n)]
            return out

    def transcribe(self, audio: np.ndarray) -> List[str]:
        return self.transcribe_batch([audio])[0]

    def transcribe_files(self, paths: Sequence[str]) -> List[List[str]]:
        """Audio files (WAV, SPHERE, FLAC, MP3) → token sequences; other
        sample rates are resampled to the model rate (the native polyphase
        resampler, ``data/audio_io.py``)."""
        from phones_las_torch.data.audio_io import read_audio

        return self.transcribe_batch([read_audio(p, target_rate=self._sample_rate)[0] for p in paths])

    def frame_samples(self) -> float:
        """Input samples per encoder frame (front-end hop × pyramid
        stride): the unit of attention-peak timestamps."""
        return (
            self.model_cfg.frontend.hop_ms / 1000.0 * self._sample_rate
        ) * self.model_cfg.listener.time_reduction()

    def _stream_adapted_params(self, audio: np.ndarray):
        """Per-stream CMVN: the model with the corpus feature mean/std
        replaced by this stream's own. Features are computed on the device
        in chunks of ``train_max_samples``, masked to their true frame
        counts, and summed on the host in float64; the std is floored at
        1e-3."""
        from phones_las_torch.frontend.features import num_frames
        from phones_las_torch.frontend.fused_frontend import extract_features_fused
        from phones_las_torch.utils.device import matmul_precision_scope

        cfg = self.model_cfg
        if not cfg.cmvn:
            return self.params
        chunk = int(self.train_max_samples)
        audio = np.asarray(audio)
        s = s2 = np.zeros((), np.float64)
        cnt = 0
        for ofs in range(0, len(audio), chunk):
            seg = audio[ofs : ofs + chunk]
            n = len(seg)
            if n < chunk:
                seg = np.pad(seg, (0, chunk - n))
            wav = torch.from_numpy(np.ascontiguousarray(seg)).to(self.device)[None]
            n_t = torch.tensor([n], dtype=torch.int32, device=self.device)
            with torch.no_grad(), matmul_precision_scope(cfg.matmul_precision):
                feats = extract_features_fused(wav, cfg.frontend, sample_lengths=n_t)
            f = num_frames(n, cfg.frontend)
            m = (torch.arange(feats.shape[1], device=self.device) < f)[None, :, None]
            feats = feats * m.to(feats.dtype)
            s = s + feats.sum((0, 1)).double().cpu().numpy()
            s2 = s2 + (feats * feats).sum((0, 1)).double().cpu().numpy()
            cnt += int(f)
        mean = s / max(cnt, 1)
        std = np.sqrt(np.maximum(s2 / max(cnt, 1) - mean * mean, 1e-6))
        std = np.maximum(std, 1e-3)
        p = copy.copy(self.params)  # shares every weight; buffers replaced below
        p._buffers = dict(self.params._buffers)
        p.cmvn_mean = torch.as_tensor(mean, dtype=self.params.cmvn_mean.dtype, device=self.device)
        p.cmvn_std = torch.as_tensor(std, dtype=self.params.cmvn_std.dtype, device=self.device)
        return p

    def decode_aligned(
        self,
        windows: Sequence[np.ndarray],
        *,
        window_samples: int,
        max_tokens_per_second: float = 25.0,
        steps_cap: Optional[int] = None,
        params=None,
    ) -> List:
        """Decode equal-capacity audio windows with per-token timestamps
        → one ``(ids, times)`` pair per window; ``times`` are sample
        positions relative to the window start (attention-peak encoder
        frames mapped back through the pyramid stride and the front-end
        hop). Greedy or beam, as configured."""
        sr = self._sample_rate
        fs = self.frame_samples()
        enc_frames = max(1, int(window_samples / fs))
        if steps_cap is None:
            steps_cap = int(window_samples / sr * max_tokens_per_second)
        steps_cap = max(16, min(enc_frames, steps_cap))
        # a power-of-two dispatch batch (≤ the wave cap), so a session
        # decoding 1, 3, then 5 windows meets few distinct shapes
        wave = self._wave_size(len(windows))
        cap = self._wave_size(1 << 30)
        if wave < cap:
            wave = self._wave_size(min(cap, 1 << (wave - 1).bit_length()))
        dt = self._wire_dtype(windows)
        dispatched = []
        for ofs in range(0, len(windows), wave):
            chunk = windows[ofs : ofs + wave]
            for seg in chunk:
                if len(seg) > window_samples:
                    raise ValueError(f"window of {len(seg)} samples exceeds {window_samples}")
            staged = self._stage(chunk, wave, window_samples, dt)
            dispatched.append((len(chunk), self._decode(*staged, steps_cap, params=params, aligned=True)))
        out = []
        for n, (toks, lens, peaks) in dispatched:  # fetch after dispatch
            toks, lens, peaks = toks.cpu().numpy(), lens.cpu().numpy(), peaks.cpu().numpy()
            for i in range(n):
                k = int(lens[i])
                out.append((toks[i][:k], (peaks[i][:k] + 0.5) * fs))
        return out

    def _long_form_cap(self, pad_samples: int, max_tokens_per_second: float) -> int:
        """Per-segment step cap of pause-mode long form: the trained target
        cap scaled by how much longer the segment pad is than the longest
        training bucket, never above the rate cap (a generous cap turns one
        unstable segment into hundreds of insertions)."""
        scaled = self.max_steps * pad_samples / self.train_max_samples
        rate = pad_samples / self._sample_rate * max_tokens_per_second
        return int(np.ceil(min(max(self.max_steps, scaled), rate)))

    def long_form_geometry(self, overlap_seconds: float = 2.0):
        """Default pause-mode geometry ``(window_seconds, search_seconds)``:
        the longest possible segment (window + 2 × search) equals the
        longest training bucket; the search half-width is the requested
        overlap clamped to ⅛ of the bucket (always search < window/2)."""
        sr = self._sample_rate
        m = self.train_max_samples
        search = min(int(overlap_seconds * sr), m // 8)
        return (m - 2 * search) / sr, search / sr

    def transcribe_long(
        self,
        audio: np.ndarray,
        *,
        window_seconds: Optional[float] = None,
        overlap_seconds: float = 2.0,
        max_tokens_per_second: float = 25.0,
        segmentation: str = "pause",
        adapt_cmvn: bool = False,
    ) -> List[str]:
        """Transcribe audio of any length by segments.

        ``segmentation="pause"`` (default): cuts every ``window_seconds``
        snapped into the widest pause within ±``overlap_seconds``; the
        transcript is the concatenation of the segment decodes.
        ``"overlap"``: fixed-stride overlapping windows stitched at the
        overlap midpoints by token timestamps. ``adapt_cmvn`` normalises
        with this stream's own feature statistics. Segments go in
        ``max_device_batch`` waves; the per-segment step cap scales with
        the segment length."""
        audio = np.asarray(audio)
        sr = self._sample_rate
        if window_seconds is None:
            if segmentation == "pause":
                window_seconds, overlap_seconds = self.long_form_geometry(overlap_seconds)
            else:
                window_seconds = 20.0
        win = int(window_seconds * sr)
        ov = int(overlap_seconds * sr)
        if not 0 < ov < win:
            raise ValueError(f"need 0 < overlap ({ov}) < window ({win})")
        if audio.shape[0] <= win:
            return self.transcribe(audio)
        params = self._stream_adapted_params(audio) if adapt_cmvn else None
        if segmentation == "pause":
            pad = win + 2 * ov
            cuts = find_pause_cuts(audio, sr, win, ov)
            decoded = self.decode_aligned(
                [audio[a:b] for a, b in zip(cuts[:-1], cuts[1:])],
                window_samples=pad,
                max_tokens_per_second=max_tokens_per_second,
                steps_cap=self._long_form_cap(pad, max_tokens_per_second),
                params=params,
            )
            ids = [int(t) for seg_ids, _ in decoded for t in seg_ids]
            return self.vocab.decode(np.asarray(ids, np.int32))
        if segmentation != "overlap":
            raise ValueError(f"unknown segmentation {segmentation!r}")
        hop = win - ov
        starts = list(range(0, audio.shape[0] - ov, hop))
        decoded = self.decode_aligned(
            [audio[s : s + win] for s in starts],
            window_samples=win,
            max_tokens_per_second=max_tokens_per_second,
            params=params,
        )
        per_window = [(ids, s0 + times) for s0, (ids, times) in zip(starts, decoded)]
        ids = merge_window_hypotheses(per_window, starts, ov)
        return self.vocab.decode(np.asarray(ids, np.int32))

    def align(self, audio: np.ndarray, tokens: Sequence) -> List:
        """Forced alignment: teacher-force the decoder on ``tokens``
        (strings or ids) and read each step's attention-peak encoder frame
        back through the pyramid stride and front-end hop →
        ``[(token, time_seconds), ...]``, one entry per token."""
        from phones_las_torch.models.las import encode
        from phones_las_torch.models.speller import teacher_forced_decode
        from phones_las_torch.utils.device import matmul_precision_scope

        tokens = list(tokens)
        as_strings = len(tokens) > 0 and isinstance(tokens[0], str)
        ids = np.asarray(self.vocab.encode(tokens) if as_strings else tokens, np.int32)
        n = int(ids.shape[0])
        if n == 0:
            raise ValueError("align needs at least one token")
        audio = np.asarray(audio)
        # both axes padded to quanta, as the reference (the length mask
        # hides audio pad; step i reads only dec_in[:i+1])
        pad_samples = ((audio.shape[0] + 31999) // 32000) * 32000
        pad_n = ((n + 15) // 16) * 16
        dec_in = np.full((1, pad_n), self.speller_cfg.eos_id, np.int32)
        dec_in[0, 0] = self.speller_cfg.bos_id
        dec_in[0, 1:n] = ids[:-1]
        audio_b = np.zeros((1, pad_samples), audio.dtype)
        audio_b[0, : audio.shape[0]] = audio
        dev = self.device
        with torch.no_grad(), matmul_precision_scope(self.model_cfg.matmul_precision):
            memory, _, enc_mask = encode(
                self.params, self.model_cfg, torch.from_numpy(audio_b).to(dev),
                torch.tensor([audio.shape[0]], dtype=torch.int32, device=dev), prec=self.prec,
            )
            _, probs, _ = teacher_forced_decode(
                self._speller(self.params), self.speller_cfg, torch.from_numpy(dec_in).to(dev),
                memory, enc_mask, prec=self.prec,
            )
        peaks = torch.argmax(probs, dim=-1)[0, :n].cpu().numpy()
        fs = self.frame_samples() / self._sample_rate
        toks = tokens if as_strings else self.vocab.decode(ids, strip_specials=False)
        return [(t, float((p + 0.5) * fs)) for t, p in zip(toks, peaks)]
