"""Shared CLI wiring (port of ``phones_las_tpu/cli/common.py``): bind a
named preset to a prepared data directory (its vocabularies, CMVN stats
and binf codes), apply the hparam overrides a run was trained with, the
TIMIT scoring fold, and the ``--device`` argument every CLI that touches
a device takes (the counterpart of ``honor_jax_platforms_env``: no
environment variable moves work to the CPU)."""

from __future__ import annotations

import argparse
import dataclasses
import os
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from phones_las_torch.data.ipa import ARPABET_TO_IPA, BINF_FEATURES, TIMIT_FOLD_39, binf_matrix
from phones_las_torch.data.vocab import Vocab
from phones_las_torch.frontend.cmvn import CmvnStats
from phones_las_torch.frontend.specaugment import SpecAugmentConfig
from phones_las_torch.models.las import LASParams
from phones_las_torch.utils.config import Preset, get_preset

# the reference's flag names: encoder_/decoder_-prefixed keys route into
# the listener/speller sub-configs
_LISTENER_KEYS = {"encoder_layers": "num_layers", "encoder_units": "units", "dropout": "dropout"}
_SPELLER_KEYS = {
    "decoder_layers": "num_layers", "decoder_units": "units", "embedding_dim": "embedding_dim",
    "attention_type": "attention_type", "attention_units": "attention_units",
    "attention_layer_size": "attention_layer_size", "sampling_probability": "sampling_probability",
    "monotonic_mode": "monotonic_mode", "monotonic_noise": "monotonic_noise",
    "monotonic_bias": "monotonic_bias",
}


def add_device_arg(p: argparse.ArgumentParser) -> None:
    """``--device``: unset means CUDA (the command fails without a card);
    ``--device cpu`` runs the plain PyTorch path, as the tests do."""
    p.add_argument("--device", default=None,
                   help="torch device to run on (default: cuda, which must be present; "
                        "'cpu' runs the plain PyTorch path)")


def parse_devices(text: Optional[str], device: Optional[str] = None) -> Optional[List[torch.device]]:
    """``--devices cuda:0,cuda:0`` → the devices, in order (one may repeat:
    ranks, shards or replicas that share a card), or None when unset. With
    ``--device`` beside it, every entry must be of its type."""
    if text is None:
        return None
    devs = [torch.device(d.strip()) for d in text.split(",") if d.strip()]
    if not devs:
        raise ValueError(f"--devices {text!r} names no device")
    if device is not None and any(d.type != torch.device(device).type for d in devs):
        raise ValueError(f"--devices {text} are not all of --device {device}'s type")
    return devs


def load_data_dir(data_dir: str):
    """→ (vocab, grapheme vocab or None, CMVN stats or None) of a prepared
    data directory (``vocab.txt``, ``grapheme_vocab.txt``, ``cmvn.json``)."""
    vocab = Vocab.load(os.path.join(data_dir, "vocab.txt"))
    gpath = os.path.join(data_dir, "grapheme_vocab.txt")
    grapheme_vocab = Vocab.load(gpath) if os.path.exists(gpath) else None
    cpath = os.path.join(data_dir, "cmvn.json")
    cmvn = CmvnStats.load(cpath) if os.path.exists(cpath) else None
    return vocab, grapheme_vocab, cmvn


def resolve_preset(
    name: str, data_dir: str, overrides: Optional[Dict] = None
) -> Tuple[Preset, Vocab, Optional[Vocab], Optional[CmvnStats], Optional[np.ndarray]]:
    """Bind a named preset to the vocab sizes, special ids, binf codes and
    CMVN of a prepared data dir, then apply ``overrides`` (None values are
    skipped) → (preset, vocab, grapheme vocab, CMVN stats, binf codes)."""
    vocab, grapheme_vocab, cmvn = load_data_dir(data_dir)
    preset = get_preset(name)
    model = preset.model
    speller = dataclasses.replace(
        model.speller, vocab_size=len(vocab), bos_id=vocab.sos_id, eos_id=vocab.eos_id,
        memory_dim=2 * model.listener.units,
    )
    binf_codes = None
    if speller.binf_mode != "none":
        binf_codes = binf_matrix(vocab.tokens)
        speller = dataclasses.replace(speller, num_binf=len(BINF_FEATURES))
    g_speller = model.grapheme_speller
    if g_speller is not None:
        if grapheme_vocab is None:
            raise ValueError(f"preset {name!r} needs grapheme_vocab.txt in {data_dir}")
        g_speller = dataclasses.replace(
            g_speller, vocab_size=len(grapheme_vocab), bos_id=grapheme_vocab.sos_id,
            eos_id=grapheme_vocab.eos_id, memory_dim=2 * model.listener.units,
        )
    model = dataclasses.replace(model, speller=speller, grapheme_speller=g_speller)
    pipeline = dataclasses.replace(
        preset.pipeline, eos_id=vocab.eos_id, pad_id=vocab.pad_id,
        max_grapheme_len=preset.pipeline.max_grapheme_len if g_speller else 0,
    )
    train = preset.train
    for k, v in (overrides or {}).items():
        if v is None:
            continue
        if k == "specaugment":
            sa = v if isinstance(v, SpecAugmentConfig) else SpecAugmentConfig(**(v if isinstance(v, dict) else {}))
            model = dataclasses.replace(model, specaugment=sa)
        elif k == "frontend_precision":
            model = dataclasses.replace(model, frontend=dataclasses.replace(model.frontend, precision=v))
        elif k in _LISTENER_KEYS:
            model = dataclasses.replace(
                model, listener=dataclasses.replace(model.listener, **{_LISTENER_KEYS[k]: v})
            )
        elif k in _SPELLER_KEYS:
            model = dataclasses.replace(
                model, speller=dataclasses.replace(model.speller, **{_SPELLER_KEYS[k]: v})
            )
        elif hasattr(train, k):
            train = dataclasses.replace(train, **{k: v})
        elif hasattr(pipeline, k):
            pipeline = dataclasses.replace(pipeline, **{k: v})
        elif hasattr(model, k):
            model = dataclasses.replace(model, **{k: v})
        else:
            raise ValueError(f"unknown config override {k!r}")
    if any((overrides or {}).get(k) is not None for k in ("encoder_layers", "encoder_units")):
        # keep the heads' memory width equal to the encoder's output width
        mem = 2 * model.listener.units
        model = dataclasses.replace(
            model,
            speller=dataclasses.replace(model.speller, memory_dim=mem),
            grapheme_speller=(
                None if model.grapheme_speller is None
                else dataclasses.replace(model.grapheme_speller, memory_dim=mem)
            ),
        )
    preset = dataclasses.replace(preset, model=model, pipeline=pipeline, train=train)
    return preset, vocab, grapheme_vocab, cmvn, binf_codes


def apply_cmvn_to_params(params: LASParams, cmvn: Optional[CmvnStats]) -> LASParams:
    """Set the model's CMVN mean/std from the corpus stats, in place (None
    leaves the params as they are) → the same params."""
    if cmvn is None:
        return params
    with torch.no_grad():
        params.cmvn_mean.copy_(torch.as_tensor(cmvn.mean, dtype=torch.float32))
        params.cmvn_std.copy_(torch.as_tensor(cmvn.std, dtype=torch.float32))
    return params


def timit_score_fold(vocab: Vocab, output_ipa: bool) -> Dict[int, Optional[int]]:
    """The Lee & Hon 61 → 39 fold as an id → id map for scoring (None
    deletes); for IPA vocabs the fold goes through the ARPAbet → IPA map."""
    fold: Dict[int, Optional[int]] = {}
    for src, dst in TIMIT_FOLD_39.items():
        s = ARPABET_TO_IPA.get(src, src) if output_ipa else src
        d = (ARPABET_TO_IPA.get(dst, dst) if output_ipa else dst) if dst else None
        if s in vocab and (d is None or d in vocab):
            fold[vocab.encode([s])[0]] = None if d is None else vocab.encode([d])[0]
    return fold
