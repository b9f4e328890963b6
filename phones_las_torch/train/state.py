"""Train state: params + Adam with global-norm clipping and masking of
non-trainable leaves (port of ``phones_las_tpu/train/state.py``).

The optimizer is the reference's optax chain written out, so that it
matches it step for step:

    clip_by_global_norm(clip_norm)   g ← g if ‖g‖ < clip else (g / ‖g‖)·clip
    scale_by_adam(b1, b2, eps)       bias-corrected, eps outside the square root
    scale_by_schedule(-lr(step))

``torch.optim.Adam`` with ``clip_grad_norm_`` differs (the clip's 1e-6)
and is not used. CMVN stats and static binf codes are data: their
gradients are zeroed (``mask_grads``), so their Adam moments stay zero
and their update is exactly 0.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from phones_las_torch.models.las import LASConfig, LASParams, init_las, trainable_filter
from phones_las_torch.utils.device import DeviceLike, resolve_device


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Same fields and defaults as the reference's."""

    learning_rate: float = 1e-3
    lr_decay_rate: float = 1.0  # 1.0 → constant lr
    lr_decay_steps: int = 10000
    warmup_steps: int = 0
    clip_norm: float = 5.0
    # scheduled sampling ramps linearly from 0 to the speller's
    # sampling_probability over this many steps (0 → constant)
    sampling_ramp_steps: int = 0
    adam_b1: float = 0.9
    adam_b2: float = 0.999
    adam_eps: float = 1e-8
    num_steps: int = 10000
    eval_every: int = 1000
    checkpoint_every: int = 1000
    checkpoint_every_secs: float = 0.0
    keep_checkpoints: int = 5
    log_every: int = 100
    seed: int = 0


@dataclasses.dataclass
class AdamState:
    count: int  # updates applied so far (optax's count, shared by the schedule)
    mu: List[torch.Tensor]
    nu: List[torch.Tensor]


@dataclasses.dataclass
class TrainState:
    step: int
    params: LASParams
    opt_state: AdamState
    generator: torch.Generator  # dropout and scheduled-sampling bits, on the params' device


def lr_schedule(cfg: TrainConfig) -> Callable[[int], float]:
    """Linear warmup over ``warmup_steps``, then exponential decay by
    ``lr_decay_rate`` every ``lr_decay_steps``."""

    def schedule(step: int) -> float:
        lr = cfg.learning_rate
        if cfg.warmup_steps > 0:
            lr = lr * min(1.0, (step + 1) / cfg.warmup_steps)
        if cfg.lr_decay_rate != 1.0:
            lr = lr * cfg.lr_decay_rate ** (max(step - cfg.warmup_steps, 0) / cfg.lr_decay_steps)
        return lr

    return schedule


def global_norm(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(t * t) for t in tensors))


class Optimizer:
    """``optax.chain(clip_by_global_norm, scale_by_adam, scale_by_schedule(-lr))``
    of ``phones_las_tpu/train/state.py::make_optimizer``, over a list of leaves."""

    def __init__(self, cfg: TrainConfig):
        self.cfg = cfg
        self.schedule = lr_schedule(cfg)

    def init(self, params: Sequence[torch.Tensor]) -> AdamState:
        zeros = lambda: [torch.zeros_like(p, dtype=torch.float32) for p in params]
        return AdamState(0, zeros(), zeros())

    def update(
        self, grads: Sequence[torch.Tensor], state: AdamState, g_norm: Optional[torch.Tensor] = None
    ) -> Tuple[List[torch.Tensor], AdamState]:
        """→ (updates to add to the params, new state). ``g_norm`` is the
        global norm to clip by, ``global_norm(grads)`` when None; under a
        model-sharded mesh ``grads`` are this rank's slices (Adam works
        element by element) and the norm runs over every rank's slices
        (``Trainer._grad_norm``), or each rank would clip by a part of it."""
        c = self.cfg
        if g_norm is None:
            g_norm = global_norm(grads)
        clip = lambda g: torch.where(g_norm < c.clip_norm, g, (g / g_norm) * c.clip_norm)
        grads = [clip(g) for g in grads]
        mu = [(1.0 - c.adam_b1) * g + c.adam_b1 * m for g, m in zip(grads, state.mu)]
        nu = [(1.0 - c.adam_b2) * (g * g) + c.adam_b2 * v for g, v in zip(grads, state.nu)]
        count = state.count + 1
        bc1 = 1.0 - c.adam_b1 ** count
        bc2 = 1.0 - c.adam_b2 ** count
        step_size = -self.schedule(state.count)
        updates = [
            step_size * ((m / bc1) / (torch.sqrt(v / bc2) + c.adam_eps)) for m, v in zip(mu, nu)
        ]
        return updates, AdamState(count, mu, nu)


def apply_updates(params: Sequence[torch.Tensor], updates: Sequence[torch.Tensor]) -> None:
    """params += updates, in place."""
    with torch.no_grad():
        for p, u in zip(params, updates):
            p.add_(u)


def mask_grads(grads: Dict[str, Optional[torch.Tensor]], params: LASParams) -> Dict[str, torch.Tensor]:
    """Zero the gradients of non-trainable leaves (CMVN stats, binf codes);
    a leaf without a gradient gets zeros. Keys are leaf paths."""
    mask = trainable_filter(params)
    from phones_las_torch.utils.param_io import named_leaves

    leaves = dict(named_leaves(params))
    return {
        k: (g if mask[k] and g is not None else torch.zeros_like(leaves[k]))
        for k, g in grads.items()
    }


def create_train_state(
    model_cfg: LASConfig,
    train_cfg: TrainConfig,
    binf_codes=None,
    device: DeviceLike = None,
) -> TrainState:
    """Random params from ``train_cfg.seed`` on ``device`` (None → CUDA),
    gradients on for exactly the trainable leaves, fresh Adam state, and
    the generator of the training randomness."""
    from phones_las_torch.utils.param_io import named_leaves

    dev = resolve_device(device)
    params = init_las(model_cfg, seed=train_cfg.seed, binf_codes=binf_codes, device=dev)
    trainable = trainable_filter(params)
    leaves = []
    for key, t in named_leaves(params):
        t.requires_grad_(trainable[key])
        leaves.append(t)
    gen = torch.Generator(device=dev).manual_seed(train_cfg.seed + 1)
    return TrainState(0, params, Optimizer(train_cfg).init(leaves), gen)


def state_arrays(state: TrainState) -> Dict[str, np.ndarray]:
    """The state as host arrays: each param leaf under its keystr path, its
    Adam moments under ``mu<path>`` and ``nu<path>``, the optimizer's
    ``count`` and the generator's state bytes as uint8 (``generator``).
    The step is not among them: a checkpoint keeps it beside the arrays."""
    from phones_las_torch.utils.param_io import named_leaves

    out = {}
    for (key, t), m, v in zip(named_leaves(state.params), state.opt_state.mu, state.opt_state.nu):
        out[key] = t.detach().cpu().numpy()
        out["mu" + key] = m.cpu().numpy()
        out["nu" + key] = v.cpu().numpy()
    out["count"] = np.asarray(state.opt_state.count, np.int64)
    out["generator"] = state.generator.get_state().numpy()
    return out


def load_state_arrays(state: TrainState, arrays: Dict[str, np.ndarray]) -> None:
    """Fill ``state`` in place from ``state_arrays`` output (the step is
    the caller's). A missing or misshapen leaf, moment or generator state
    raises, naming it."""
    from phones_las_torch.utils.param_io import copy_arrays_, named_leaves

    leaves = list(named_leaves(state.params))
    copy_arrays_(leaves, arrays)
    for prefix, moments in (("mu", state.opt_state.mu), ("nu", state.opt_state.nu)):
        copy_arrays_([(prefix + key, m) for (key, _), m in zip(leaves, moments)], arrays)
    for key in ("count", "generator"):
        if key not in arrays:
            raise KeyError(f"missing leaf {key}")
    state.opt_state.count = int(arrays["count"])
    gen = torch.from_numpy(np.asarray(arrays["generator"], np.uint8).copy())
    have = state.generator.get_state().numel()
    if gen.numel() != have:
        raise ValueError(
            f"leaf generator: {gen.numel()} state bytes, the state's {state.generator.device.type} "
            f"generator holds {have} (a checkpoint resumes on the device type it was written on)"
        )
    state.generator.set_state(gen)
