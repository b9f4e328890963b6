"""The system under test, as a user reaches it: the port's artifact and its
``Transcriber``. Everything the harness takes from ``phones_las_torch`` is
here."""

from __future__ import annotations

from typing import Dict

import torch

NUMERICS = ("parity", "production")

# the precision each layer's kernels compute in, by numerics mode (the
# peak a layer's roofline is taken against): production runs the
# listener's recurrent dots in bf16 and keeps the front-end's and the
# decoder's kernels in float32
KERNEL_PRECISION = {
    "parity": {"frontend": "float32", "listener": "float32", "decoder": "float32"},
    "production": {"frontend": "float32", "listener": "bf16", "decoder": "float32"},
}


def las_config(cfg: dict, numerics: str):
    """The port's ``LASConfig`` of a configuration file, in a numerics mode:
    parity (float32, TF32 off) or production (``matmul_precision
    'default'``: bf16 recurrent dots, TF32 elsewhere; the front-end at
    ``precision='high'``), as the port's bench builds its rows."""
    from phones_las_torch.frontend.features import FrontendConfig
    from phones_las_torch.models.las import LASConfig
    from phones_las_torch.models.listener import ListenerConfig
    from phones_las_torch.models.speller import SpellerConfig

    if numerics not in NUMERICS:
        raise ValueError(f"numerics must be one of {NUMERICS}, got {numerics!r}")
    prod = numerics == "production"
    fe = {k: v for k, v in cfg["frontend"].items()}
    fe["precision"] = "high" if prod else "highest"
    li = cfg["listener"]
    sp = {k: cfg["speller"][k] for k in ("vocab_size", "embedding_dim", "num_layers", "units", "memory_dim",
                                        "attention_type", "attention_units", "attention_layer_size",
                                        "bos_id", "eos_id")}
    return LASConfig(
        frontend=FrontendConfig(**fe),
        listener=ListenerConfig(input_dim=li["input_dim"], num_layers=li["num_layers"], units=li["units"]),
        speller=SpellerConfig(**sp),
        cmvn=cfg.get("cmvn", True),
        matmul_precision="default" if prod else "highest",
    )


def write_artifact(path: str, weights: Dict[str, torch.Tensor], pcfg, extras: dict) -> None:
    """The weights as the port's artifact, through its own writer."""
    from phones_las_torch.models.las import LASParams
    from phones_las_torch.utils.param_io import named_leaves, save_params_npz

    dev = next(iter(weights.values())).device
    params = LASParams(pcfg, device=dev)
    with torch.no_grad():
        for key, t in named_leaves(params):
            if tuple(weights[key].shape) != tuple(t.shape):
                raise ValueError(f"leaf {key}: {tuple(weights[key].shape)} made, {tuple(t.shape)} expected")
            t.copy_(weights[key])
    save_params_npz(path, params, pcfg, extras=extras)


def load(path: str, device, max_device_batch: int):
    """``Transcriber.from_artifact``, greedy."""
    from phones_las_torch.api import Transcriber

    return Transcriber.from_artifact(path, beam_width=0, max_device_batch=max_device_batch,
                                     device=None if str(device).startswith("cuda") else device)


def build_seconds() -> float:
    """The seconds the port's build of its CUDA library took in this
    process (0 where it found the library built)."""
    from phones_las_torch.csrc import _build

    return _build.last_build_seconds
