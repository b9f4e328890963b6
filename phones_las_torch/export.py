"""Serving artifacts: a trained run frozen into ``torch.export`` programs
(port of ``phones_las_tpu/export.py``, which writes StableHLO).

The whole inference function (front-end → pBLSTM encoder → greedy or
beam decode, as the JAX ``Transcriber._infer_fn``) is traced once per
serving shape with the trained weights inside and saved as
``infer_b{batch}_t{pad}.pt2``. The port's kernels are ``torch.library``
operators (``phones_las_torch::fused_logmel``, ``::bidir_recurrence``,
``::greedy_decode_fused``), so a program holds one node per kernel call
and, on the card, launches the same kernels as the live ``Transcriber``;
on the CPU the same nodes run the kernels' plain versions. Loading a
program needs those operators registered and nothing else of the model
code: ``ExportedTranscriber`` imports the three modules that register
them, ``torch.export`` and the vocabulary from ``export.json``.

    python -m phones_las_torch.cli.export --workdir runs/ls --out runs/ls/export
    ...
    t = ExportedTranscriber("runs/ls/export")
    t.transcribe_batch([pcm_int16])        # same tokens as Transcriber

Programs are made per (batch, pad_samples) serving shape; the loader
picks the smallest one that fits a request and zero-pads into it. A
program is saved with the device it was traced on and moved at load time
(``torch.export.passes.move_to_device_pass``) to a device that the
export's ``platforms`` lists. Make and load ``.pt2`` files with the same
PyTorch version.
"""

from __future__ import annotations

import importlib
import json
import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

_META_NAME = "export.json"
RUNTIME = "torch.export"
PLATFORMS = ("cuda", "cpu")
# the modules whose import registers the operators a program names
OP_MODULES = (
    "phones_las_torch.frontend.fused_frontend",
    "phones_las_torch.ops.lstm",
    "phones_las_torch.decode.fused_greedy",
)


class InferenceProgram(torch.nn.Module):
    """A ``Transcriber``'s decode as one module: (audio int16 [b, pad],
    lengths int32 [b]) → (tokens int32 [b, max_steps], lengths int32 [b]).
    Greedy decoding of a configuration the fused decoder takes goes through
    its operator on every device, as the reference's ``_infer_fn`` takes
    the fused kernel where it can."""

    def __init__(self, t):
        super().__init__()
        from phones_las_torch.decode.fused_greedy import supports

        self.t = t
        self.params = t.params
        self.register_buffer("lm_logp", t.lm_logp)
        self.fused = not t.beam and supports(t.speller_cfg)

    def forward(self, audio: torch.Tensor, lengths: torch.Tensor):
        from phones_las_torch.decode import beam_decode, greedy_decode
        from phones_las_torch.decode.fused_greedy import greedy_decode_fused
        from phones_las_torch.models.las import ctc_logp, encode

        t, p = self.t, self.params
        memory, _, enc_mask = encode(p, t.model_cfg, audio, lengths, prec=t.prec)
        sp = t._speller(p)
        if t.beam:
            res = beam_decode(
                sp, t.speller_cfg, memory, enc_mask, t.max_steps, beam_width=t.beam,
                length_penalty=t.length_penalty, lm_logp=self.lm_logp, lm_weight=t.lm_weight,
                ctc_logp=None if t.ctc_joint is None else ctc_logp(p, memory),
                ctc_alpha=1.0 if t.ctc_joint is None else t.ctc_joint, prec=t.prec,
            )
            return res.tokens, res.lengths
        if self.fused:
            return greedy_decode_fused(sp, t.speller_cfg, memory, enc_mask, t.max_steps)
        toks, lens, _ = greedy_decode(sp, t.speller_cfg, memory, enc_mask, t.max_steps, prec=t.prec)
        return toks, lens


def export_model(
    workdir: str,
    out_dir: str,
    *,
    batch_sizes: Sequence[int] = (1, 8, 64),
    pad_seconds: Sequence[float] = (10.0,),
    beam_width: Optional[int] = None,
    head: str = "phone",
    platforms: Optional[Sequence[str]] = None,
    average_checkpoints: int = 1,
    lm: Optional[str] = None,
    lm_weight: float = 0.3,
    device=None,
) -> dict:
    """Trace and save the inference program for each serving shape, on
    ``device`` (None → CUDA) → the metadata (also ``<out_dir>/export.json``).
    ``platforms`` lists the devices the programs may be served on (default:
    the one they were traced on)."""
    from phones_las_torch.api import Transcriber

    t = Transcriber(
        workdir, beam_width=beam_width, head=head, average_checkpoints=average_checkpoints,
        lm=lm, lm_weight=lm_weight, device=device,
    )
    platforms = list(platforms) if platforms else [t.device.type]
    bad = sorted(set(platforms) - set(PLATFORMS))
    if bad:
        raise ValueError(f"unknown platforms {bad}; a program serves on {list(PLATFORMS)}")
    sr = t.sample_rate
    os.makedirs(out_dir, exist_ok=True)
    program = InferenceProgram(t).eval()
    entries = []
    for secs in pad_seconds:
        pad = int(round(secs * sr))
        for b in sorted(batch_sizes):
            args = (
                torch.zeros((b, pad), dtype=torch.int16, device=t.device),
                torch.full((b,), pad, dtype=torch.int32, device=t.device),
            )
            with torch.no_grad():
                ep = torch.export.export(program, args)
            name = f"infer_b{b}_t{pad}.pt2"
            torch.export.save(ep, os.path.join(out_dir, name))
            entries.append({"batch": b, "pad_samples": pad, "file": name})

    meta = {
        "format": 1,
        "runtime": RUNTIME,
        "torch": torch.__version__,
        "workdir": os.path.abspath(workdir),
        "sample_rate": sr,
        "head": head,
        "beam_width": t.beam,
        "matmul_precision": t.model_cfg.matmul_precision,
        "prec": t.prec,
        "device": t.device.type,
        "platforms": platforms,
        "tokens": list(t.vocab.tokens),
        "entries": entries,
    }
    with open(os.path.join(out_dir, _META_NAME), "w") as f:
        json.dump(meta, f, indent=1)
    return meta


class ExportedTranscriber:
    """Serve from an export directory: saved programs and the vocabulary,
    no model code, config or checkpoint. ``device=None`` means CUDA; the
    device must be one the export's ``platforms`` lists."""

    def __init__(self, export_dir: str, device=None):
        from phones_las_torch.utils.device import resolve_device

        with open(os.path.join(export_dir, _META_NAME)) as f:
            meta = json.load(f)
        files = [e["file"] for e in meta.get("entries", [])]
        if meta.get("runtime") != RUNTIME or any(f.endswith(".shlo") for f in files):
            raise ValueError(
                f"{export_dir} is not a torch.export directory (runtime {meta.get('runtime')!r}, "
                f"files {files}): StableHLO exports are served by phones_las_tpu.export.ExportedTranscriber"
            )
        if meta.get("format") != 1:
            raise ValueError(f"unknown export format {meta.get('format')!r} in {export_dir}")
        self.device = resolve_device(device)
        if self.device.type not in meta["platforms"]:
            raise ValueError(
                f"{export_dir} was exported for {meta['platforms']}, not for {self.device.type!r}"
            )
        for name in OP_MODULES:
            importlib.import_module(name)
        self.meta = meta
        self.sample_rate = meta["sample_rate"]
        self.tokens: List[str] = meta["tokens"]
        self._dir = export_dir
        self._fns: Dict[Tuple[int, int], torch.nn.Module] = {}  # (batch, pad) → loaded program
        self._shapes = sorted((e["batch"], e["pad_samples"], e["file"]) for e in meta["entries"])

    def _pick(self, n: int, samples: int) -> Tuple[int, int, str]:
        """Smallest exported (batch, pad) that fits; batch-first so a
        single long request doesn't land on the widest batch program."""
        fitting = [(b, p, f) for b, p, f in self._shapes if b >= n and p >= samples]
        if not fitting:
            raise ValueError(
                f"no exported shape fits batch={n}, samples={samples}; "
                f"have {[(b, p) for b, p, _ in self._shapes]}"
            )
        return min(fitting, key=lambda e: (e[0], e[1]))

    def program(self, b: int, pad: int, fname: str) -> torch.nn.Module:
        """The loaded program of one shape, on this transcriber's device."""
        key = (b, pad)
        if key not in self._fns:
            ep = torch.export.load(os.path.join(self._dir, fname))
            if self.device.type != self.meta["device"]:
                from torch.export.passes import move_to_device_pass

                ep = move_to_device_pass(ep, self.device)
            self._fns[key] = ep.module()
        return self._fns[key]

    @staticmethod
    def _to_int16(a: np.ndarray) -> np.ndarray:
        a = np.asarray(a)
        if a.dtype == np.int16:
            return a
        # the library convention is PCM-scale values regardless of dtype
        # (the Transcriber ships float inputs at the same scale)
        return np.clip(np.round(a), -32768, 32767).astype(np.int16)

    def transcribe_batch(self, audio: Sequence[np.ndarray]) -> List[List[str]]:
        from phones_las_torch.utils.device import matmul_precision_scope

        lens = [int(np.asarray(a).shape[0]) for a in audio]
        b, pad, fname = self._pick(len(audio), max(lens))
        wav = np.zeros((b, pad), np.int16)
        for i, a in enumerate(audio):
            wav[i, : lens[i]] = self._to_int16(a)
        wav_lens = np.zeros((b,), np.int32)
        wav_lens[: len(audio)] = lens
        fn = self.program(b, pad, fname)
        with torch.no_grad(), matmul_precision_scope(self.meta["matmul_precision"]):
            toks, out_lens = fn(torch.from_numpy(wav).to(self.device), torch.from_numpy(wav_lens).to(self.device))
        toks, out_lens = toks.cpu().numpy(), out_lens.cpu().numpy()
        specials = set(self.tokens[:4])  # <pad>/<sos>/<eos>/<unk>
        return [
            [self.tokens[tid] for tid in toks[i][: out_lens[i]] if self.tokens[tid] not in specials]
            for i in range(len(audio))
        ]

    def transcribe(self, audio: np.ndarray) -> List[str]:
        return self.transcribe_batch([audio])[0]
