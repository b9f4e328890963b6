"""The flat-npz model artifact (port of ``phones_las_tpu/utils/param_io.py``).

The artifact holds each parameter leaf under its JAX ``keystr`` tree path
(``'.listener.layers[0][1].wh'``, ``'.speller.cells[0].wx'``, ...), the
``LASConfig`` as ``dataclasses.asdict`` JSON bytes in ``__config__`` and
optional decode metadata as JSON bytes in ``__extras__``.
``params_from_numpy`` carries such a flat dict of arrays into the port's
``LASParams`` modules; ``load_artifact`` reads the file with numpy alone
and ``save_params_npz`` writes one (the JAX package's ``load_artifact``
reads it). A missing or misshapen leaf fails loudly.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Dict, Iterable, Iterator, Optional, Tuple

import numpy as np
import torch

from phones_las_torch.frontend.features import FrontendConfig
from phones_las_torch.models.las import LASConfig, LASParams, SpecAugmentConfig
from phones_las_torch.models.listener import ListenerConfig
from phones_las_torch.models.speller import SpellerConfig, SpellerParams
from phones_las_torch.ops.lstm import LSTMParams
from phones_las_torch.utils.device import DeviceLike, resolve_device


def config_from_dict(d: dict) -> LASConfig:
    """Rebuild a ``LASConfig`` from ``dataclasses.asdict`` output."""
    d = dict(d)
    d["frontend"] = FrontendConfig(**d["frontend"])
    d["listener"] = ListenerConfig(**d["listener"])
    d["speller"] = SpellerConfig(**d["speller"])
    if d.get("grapheme_speller"):
        d["grapheme_speller"] = SpellerConfig(**d["grapheme_speller"])
    if d.get("specaugment"):
        d["specaugment"] = SpecAugmentConfig(**d["specaugment"])
    return LASConfig(**d)


def _lstm_leaves(p: LSTMParams, prefix: str) -> Iterator[Tuple[str, torch.Tensor]]:
    for name in ("wx", "wh", "b"):
        yield f"{prefix}.{name}", getattr(p, name)


def _speller_leaves(p: SpellerParams, prefix: str) -> Iterator[Tuple[str, torch.Tensor]]:
    yield f"{prefix}.embedding", p.embedding
    for i, cell in enumerate(p.cells):
        yield from _lstm_leaves(cell, f"{prefix}.cells[{i}]")
    for name in ("wq", "wk", "v", "b", "score_bias", "g"):
        t = getattr(p.attention, name)
        if t is not None:
            yield f"{prefix}.attention.{name}", t
    for name in ("attention_layer", "out_w", "out_b", "binf_w", "binf_b", "binf_codes"):
        t = getattr(p, name)
        if t is not None:
            yield f"{prefix}.{name}", t


def named_leaves(params: LASParams) -> Iterator[Tuple[str, torch.Tensor]]:
    """(JAX keystr path, tensor) for every leaf of the model, the same set
    of paths as ``jax.tree_util.tree_flatten_with_path`` of ``LASParams``."""
    for l, (pf, pb) in enumerate(params.listener.layers):
        yield from _lstm_leaves(pf, f".listener.layers[{l}][0]")
        yield from _lstm_leaves(pb, f".listener.layers[{l}][1]")
    yield from _speller_leaves(params.speller, ".speller")
    if params.grapheme_speller is not None:
        yield from _speller_leaves(params.grapheme_speller, ".grapheme_speller")
    yield ".cmvn_mean", params.cmvn_mean
    yield ".cmvn_std", params.cmvn_std
    for name in ("ctc_w", "ctc_b"):
        t = getattr(params, name)
        if t is not None:
            yield f".{name}", t


def params_to_numpy(params: LASParams) -> Dict[str, np.ndarray]:
    """{keystr path: float32 array} of every leaf, fetched to the host."""
    return {key: t.detach().cpu().numpy() for key, t in named_leaves(params)}


def _json_bytes(obj) -> np.ndarray:
    return np.frombuffer(json.dumps(obj).encode(), dtype=np.uint8)


def save_params_npz(path: str, params: LASParams, cfg: LASConfig, extras: Optional[dict] = None) -> None:
    """Write the artifact: the leaves under their paths, the config in
    ``__config__`` and ``extras`` (JSON-serialisable decode metadata:
    vocab, buckets, max_target_len) in ``__extras__``."""
    flat = params_to_numpy(params)
    flat["__config__"] = _json_bytes(dataclasses.asdict(cfg))
    if extras is not None:
        flat["__extras__"] = _json_bytes(extras)
    np.savez_compressed(path, **flat)


def copy_arrays_(leaves: Iterable[Tuple[str, torch.Tensor]], flat: Dict[str, np.ndarray]) -> None:
    """Copy ``flat[key]`` (cast to float32) into each ``(key, tensor)`` of
    ``leaves``, in place; a missing or misshapen array raises, naming it."""
    with torch.no_grad():
        for key, t in leaves:
            if key not in flat:
                raise KeyError(f"missing leaf {key}")
            arr = np.asarray(flat[key])
            if tuple(arr.shape) != tuple(t.shape):
                raise ValueError(f"leaf {key}: shape {arr.shape}, model expects {tuple(t.shape)}")
            t.copy_(torch.from_numpy(arr.astype(np.float32)))


def params_from_numpy(
    flat: Dict[str, np.ndarray], cfg: LASConfig, device: DeviceLike = None
) -> LASParams:
    """Carry the JAX model's leaves, keyed by ``keystr`` path, into a
    ``LASParams`` on ``device`` (``None`` → CUDA). Leaves are cast to
    float32, as the JAX loader casts them to its template's dtype."""
    params = LASParams(cfg, device=resolve_device(device))
    copy_arrays_(named_leaves(params), flat)
    return params.eval()


def load_artifact(path: str, device: DeviceLike = None) -> Tuple[LASParams, LASConfig, dict]:
    """→ (LASParams on ``device`` (``None`` → CUDA), LASConfig, extras
    dict — empty when absent). Reads the npz with numpy alone."""
    dev = resolve_device(device)
    with np.load(path, allow_pickle=False) as data:
        cfg = config_from_dict(json.loads(bytes(data["__config__"].tobytes()).decode()))
        extras = (
            json.loads(bytes(data["__extras__"].tobytes()).decode())
            if "__extras__" in data else {}
        )
        flat = {k: data[k] for k in data.files if not k.startswith("__")}
    try:
        params = params_from_numpy(flat, cfg, dev)
    except (KeyError, ValueError) as e:
        raise ValueError(f"{path}: {e}") from e
    return params, cfg, extras


def load_params_npz(path: str, device: DeviceLike = None) -> Tuple[LASParams, LASConfig]:
    """→ (LASParams on ``device`` (``None`` → CUDA), LASConfig)."""
    params, cfg, _ = load_artifact(path, device)
    return params, cfg
