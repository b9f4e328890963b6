"""Checkpoints: periodic saves, keep-N, silent resume, averaging and warm
start (port of ``phones_las_tpu/train/checkpoint.py``, in the port's own
format; the reference writes orbax, a JAX package).

Layout: ``<workdir>/checkpoints/<step>/`` holds ``state.npz`` (the
params under their keystr paths, the Adam moments under ``mu<path>`` /
``nu<path>``, the optimizer ``count`` and the generator's state bytes,
``train/state.py::state_arrays``) and ``meta.json`` (the step and the data
epoch). A step is written into a temporary directory beside it and moved
into place with ``os.replace``, so a directory named by a step is whole.
A run of the reference reaches the port through the flat npz of
``tools/export_artifact.py``, not through its checkpoints.
"""

from __future__ import annotations

import copy
import json
import os
import shutil
from typing import Dict, List, Optional, Tuple

import numpy as np

from phones_las_torch.models.las import LASParams
from phones_las_torch.train.state import TrainState, load_state_arrays, state_arrays
from phones_las_torch.utils.param_io import copy_arrays_, named_leaves

_STATE, _META = "state.npz", "meta.json"


class CheckpointManager:
    """``keep`` newest checkpoints of a workdir, one every ``save_every``
    steps (orbax's save decision under the reference's options: never at
    or below the latest saved step; else when forced, when the step is a
    multiple of ``save_every``, or when the workdir holds no checkpoint
    yet, so a fresh run saves the first step it offers).
    Writes are synchronous; ``wait`` and ``close`` exist for the
    reference's call sites."""

    def __init__(self, workdir: str, keep: int = 5, save_every: int = 1000):
        self.directory = os.path.join(os.path.abspath(workdir), "checkpoints")
        os.makedirs(self.directory, exist_ok=True)
        self.keep = keep
        self.save_every = save_every

    def all_steps(self) -> List[int]:
        return sorted(
            int(n) for n in os.listdir(self.directory)
            if n.isdigit() and os.path.isfile(os.path.join(self.directory, n, _META))
        )

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def should_save(self, step: int, force: bool = False) -> bool:
        latest = self.latest_step()
        if latest is None:
            return True
        if step <= latest:
            return False
        return force or step % self.save_every == 0

    def save(self, step: int, state: TrainState, epoch: int = 0, force: bool = False) -> bool:
        """Write ``state`` as checkpoint ``step`` when the policy says so
        → whether it was written; then delete the oldest beyond ``keep``."""
        if not self.should_save(step, force):
            return False
        final = os.path.join(self.directory, str(step))
        tmp = os.path.join(self.directory, f".tmp-{step}-{os.getpid()}")
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        np.savez(os.path.join(tmp, _STATE), **state_arrays(state))
        with open(os.path.join(tmp, _META), "w") as f:
            json.dump({"step": int(step), "epoch": int(epoch)}, f)
        os.replace(tmp, final)
        for old in self.all_steps()[: -self.keep] if self.keep > 0 else []:
            shutil.rmtree(os.path.join(self.directory, str(old)))
        return True

    def _step_or_latest(self, step: Optional[int]) -> int:
        step = self.latest_step() if step is None else step
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {self.directory}")
        return step

    def read(self, step: Optional[int] = None) -> Tuple[Dict[str, np.ndarray], dict]:
        """→ (the arrays of checkpoint ``step`` (None → latest), its meta)."""
        path = os.path.join(self.directory, str(self._step_or_latest(step)))
        with open(os.path.join(path, _META)) as f:
            meta = json.load(f)
        with np.load(os.path.join(path, _STATE), allow_pickle=False) as data:
            arrays = {k: data[k] for k in data.files}
        return arrays, meta

    def restore(self, state: TrainState, step: Optional[int] = None) -> Tuple[TrainState, int]:
        """Fill ``state`` in place from checkpoint ``step`` (None → latest)
        → (state, data epoch). A missing or misshapen leaf raises, naming it."""
        arrays, meta = self.read(step)
        load_state_arrays(state, arrays)
        state.step = int(meta["step"])
        return state, int(meta.get("epoch", 0))

    def wait(self) -> None:
        pass

    def close(self) -> None:
        pass


def _params_like(template: LASParams) -> LASParams:
    """A detached copy of ``template``'s modules, without gradients."""
    p = copy.deepcopy(template)
    for _, t in named_leaves(p):
        t.requires_grad_(False)
    return p.eval()


def load_averaged_params(workdir: str, state: TrainState, last_k: int) -> Tuple[LASParams, List[int]]:
    """The mean of the params of the newest ``last_k`` checkpoints →
    (params shaped as ``state.params``, on its device; the steps used).
    The sums are taken on the host in float64."""
    if last_k < 1:
        raise ValueError(f"last_k must be at least 1, got {last_k}")
    mgr = CheckpointManager(workdir)
    steps = mgr.all_steps()
    if not steps:
        raise FileNotFoundError(f"no checkpoint in {workdir}")
    use = steps[-last_k:]
    avg = _params_like(state.params)
    acc: Dict[str, np.ndarray] = {}
    for s in use:
        arrays, _ = mgr.read(s)
        copy_arrays_(named_leaves(avg), arrays)  # checks every leaf's presence and shape
        for k, _ in named_leaves(avg):
            acc[k] = acc.get(k, 0.0) + np.asarray(arrays[k], np.float64)
    copy_arrays_(named_leaves(avg), {k: a / float(len(use)) for k, a in acc.items()})
    return avg, use


def load_params_for_warm_start(
    workdir: str,
    state: TrainState,
    step: Optional[int] = None,
    scope: str = "all",  # 'all' | 'encoder'
    target_params: Optional[LASParams] = None,
) -> LASParams:
    """Another run's params for a warm start → new params. ``scope='all'``
    reads every leaf, shaped as ``state.params``; ``scope='encoder'``
    reads only the listener and the CMVN stats into a copy of
    ``target_params`` (the cross-language recipe: the decoders' shapes
    differ between phone sets, the encoder transfers)."""
    arrays, _ = CheckpointManager(workdir).read(step)
    if scope == "all":
        out = _params_like(state.params)
        copy_arrays_(named_leaves(out), arrays)
        return out
    if scope != "encoder" or target_params is None:
        raise ValueError("warm start takes scope 'all', or 'encoder' with target_params")
    out = _params_like(target_params)
    enc = {k for k, _ in named_leaves(out) if k.startswith(".listener.") or k in (".cmvn_mean", ".cmvn_std")}
    src = {k for k in arrays if k.startswith(".listener.")}
    dst = {k for k in enc if k.startswith(".listener.")}
    if src != dst:
        raise ValueError(f"encoder layer-count mismatch: listener leaves {sorted(src ^ dst)} differ")
    copy_arrays_([(k, t) for k, t in named_leaves(out) if k in enc], arrays)
    return out
