"""The ('data', 'model') mesh and its sharding rules (port of
``phones_las_tpu/parallel/mesh.py``).

The reference lays the mesh over the devices of one controller and lets
GSPMD insert the collectives. The port runs one process a rank of a
``torch.distributed`` world and says each collective itself, over plain
process groups (one for each data row, one for each model column), with
only ``all_reduce``, ``all_gather`` and ``broadcast``, which gloo also
takes on CUDA tensors:

  * 'data': each data rank computes its contiguous rows of the global
    batch (``local_rows``); the losses divide by counts summed over the
    data ranks, and the gradients are summed over them;
  * 'model': parameters and Adam moments are stored sharded along the
    gate, vocab or feature dimension of ``param_sharding_rules`` and
    all-gathered into whole tensors before the forward, so the kernels
    run on whole weights, as the Pallas calls do under GSPMD. The ranks
    of one data row hold the same rows and compute the same gradients.

A rank is a process with one device; ranks may share a card over gloo
(NCCL refuses two ranks on one card, and ``make_mesh`` says so first).
Without a process group the mesh is the 1 × 1 no-op. Data-parallel
serving needs no process group: ``map_row_shards`` splits a wave over
devices of this process (``Transcriber(data_parallel=)``, ``cli.infer
--mesh``).
"""

from __future__ import annotations

import copy
import os
import re
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

from phones_las_torch.models.las import LASParams
from phones_las_torch.utils.device import DeviceLike, resolve_device
from phones_las_torch.utils.param_io import named_leaves

# the dimension of each leaf that 'model' shards, by leaf name; every other
# leaf is replicated
_SHARDED_DIM = {
    # LSTM cells (listener and speller): the 4U gate dimension
    "wx": 1, "wh": 1, "b": 0,
    # attention: the attention-units dimension ("b" of bahdanau_norm above;
    # "v" only when it is a vector)
    "wq": 1, "wk": 1, "v": 0,
    # speller heads and the CTC head: the output (vocab, binf, feature) dimension
    "attention_layer": 1, "out_w": 1, "out_b": 0, "binf_w": 1, "binf_b": 0,
    "ctc_w": 1, "ctc_b": 0,
}
# replicated on purpose: the embedding (its lookup indexes the vocab axis, so
# sharding it would turn every decode step's gather into a collective), the
# scalar attention leaves, the static binf codes and the CMVN stats


class Mesh:
    """A ('data', 'model') grid over the ranks of the process group (rank
    r sits at data row r // model, model column r % model), this rank's
    device, and the collectives the sharded step needs. ``local_batches``
    says that each process feeds its own rows (``--multihost``, a global
    batch of data × the per-process batch) instead of the global batch
    that every process holds (``--mesh``)."""

    def __init__(self, data: int, model: int, devices: Sequence[DeviceLike], *,
                 local_batches: bool = False):
        self.distributed = dist.is_available() and dist.is_initialized()
        self.rank = dist.get_rank() if self.distributed else 0
        self.data, self.model = data, model
        self.devices = [torch.device(d) for d in devices]
        self.device = self.devices[self.rank]
        self.local_batches = local_batches
        self.data_group = self.model_group = None
        if self.distributed:
            # every rank creates every group, in one order
            for d in range(data):
                g = dist.new_group([d * model + m for m in range(model)])
                if d == self.data_index:
                    self.model_group = g
            for m in range(model):
                g = dist.new_group([d * model + m for d in range(data)])
                if m == self.model_index:
                    self.data_group = g

    @property
    def shape(self) -> Dict[str, int]:
        return {"data": self.data, "model": self.model}

    @property
    def data_index(self) -> int:
        return self.rank // self.model

    @property
    def model_index(self) -> int:
        return self.rank % self.model

    def sum_data(self, t: torch.Tensor) -> torch.Tensor:
        """Sum ``t`` over the ranks of this model column (the data ranks
        that hold the other rows), in place → ``t``."""
        if self.distributed:
            dist.all_reduce(t, group=self.data_group)
        return t

    def sum_model(self, t: torch.Tensor) -> torch.Tensor:
        """Sum ``t`` over the ranks of this data row, in place → ``t``."""
        if self.distributed:
            dist.all_reduce(t, group=self.model_group)
        return t

    def gather_model(self, t: torch.Tensor, dim: int) -> torch.Tensor:
        """The whole tensor of which each rank of this data row holds the
        slice ``t`` along ``dim``, in model-column order."""
        if not self.distributed or self.model == 1:
            return t
        parts = [torch.empty_like(t) for _ in range(self.model)]
        dist.all_gather(parts, t.contiguous(), group=self.model_group)
        return torch.cat(parts, dim)

    def agree(self, flag: bool) -> bool:
        """Rank 0's ``flag``, on every rank: a decision that starts
        collectives (a checkpoint save) must be the same everywhere."""
        if not self.distributed:
            return flag
        t = torch.tensor([int(flag)], device=self.device)
        dist.broadcast(t, 0)
        return bool(t.item())

    def barrier(self) -> None:
        """Wait for every rank (an all-reduce, which every backend takes)."""
        if self.distributed:
            t = torch.zeros(1, device=self.device)
            dist.all_reduce(t)
            t.item()


def local_devices(device: DeviceLike = None) -> List[torch.device]:
    """Every device of ``device``'s type in this process: each CUDA card
    (``None`` means CUDA and raises without one), or the one CPU."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    return [dev]


def pick_devices(n: int, devices: Optional[Sequence[DeviceLike]] = None,
                 device: DeviceLike = None) -> List[torch.device]:
    """``n`` devices (0: all of them): the first ``n`` of ``devices``, a
    list that may name one device more than once (ranks, shards or
    replicas that share a card), or else of ``local_devices(device)``.
    Asking for more than there are raises ``ValueError``, naming the count."""
    have = [torch.device(d) for d in devices] if devices is not None else local_devices(device)
    n = n or len(have)
    if n > len(have):
        where = "given" if devices is not None else f"{have[0].type} device(s) present"
        raise ValueError(f"{n} devices asked for, but only {len(have)} {where}")
    return have[:n]


def make_mesh(
    data: Optional[int] = None,
    model: int = 1,
    devices: Optional[Sequence[DeviceLike]] = None,
    *,
    local_batches: bool = False,
) -> Mesh:
    """The ('data', 'model') mesh over the process group's ranks (1 × 1
    without one). ``devices`` gives each rank's device, in rank order, and
    may repeat one over gloo; by default rank r takes card ``LOCAL_RANK``
    (else r). Under NCCL two ranks on one card raise."""
    distributed = dist.is_available() and dist.is_initialized()
    world = dist.get_world_size() if distributed else 1
    rank = dist.get_rank() if distributed else 0
    if data is None:
        if world % model:
            raise ValueError(f"model={model} does not divide the {world} ranks")
        data = world // model
    if data * model != world:
        raise ValueError(f"a {data} x {model} mesh needs {data * model} ranks, the world has {world}"
                         + ("" if distributed else " (no process group: call initialize_distributed)"))
    if devices is None:
        local = int(os.environ.get("LOCAL_RANK", rank))
        cards = local_devices()
        if local >= len(cards):
            raise ValueError(f"rank {rank} (local rank {local}) has no card: {len(cards)} present")
        devs = [None] * world
        devs[rank] = cards[local]
    else:
        devs = [torch.device(d) for d in devices]
        if len(devs) != world:
            raise ValueError(f"{len(devs)} devices given for {world} ranks")
        if distributed and dist.get_backend() == "nccl" and len(set(map(str, devs))) < len(devs):
            raise ValueError(
                f"NCCL takes one card a rank, and these ranks share one: {[str(d) for d in devs]} "
                "(ranks that share a card need backend='gloo')"
            )
    if devs[rank].type == "cuda" and devs[rank].index is not None:
        torch.cuda.set_device(devs[rank])  # NCCL works on the current card
    return Mesh(data, model, devs, local_batches=local_batches)


def param_sharding_rules(params: LASParams) -> Dict[str, Optional[int]]:
    """{leaf path: the dimension sharded over 'model', or None where the
    leaf is replicated}, over ``named_leaves``."""
    out = {}
    for path, t in named_leaves(params):
        name = path.rsplit(".", 1)[-1]
        dim = _SHARDED_DIM.get(name)
        out[path] = None if dim is None or t.ndim <= dim else dim
    return out


def _compatible_spec(x: torch.Tensor, dim: Optional[int], mesh: Mesh) -> Optional[int]:
    """``dim``, or None where ``x`` cannot be split evenly over 'model'
    (an odd vocab over model 2): such a leaf is replicated instead of
    refusing the mesh."""
    return dim if dim is not None and x.shape[dim] % mesh.model == 0 else None


def sharded_dims(params: LASParams, mesh: Mesh) -> Dict[str, Optional[int]]:
    """{leaf path: the dimension this mesh shards, or None} of whole params."""
    rules = param_sharding_rules(params)
    return {k: _compatible_spec(t, rules[k], mesh) for k, t in named_leaves(params)}


def shard_tensor(t: torch.Tensor, dim: Optional[int], mesh: Mesh) -> torch.Tensor:
    """This model column's slice of the whole ``t`` along ``dim`` (``t``
    itself where ``dim`` is None)."""
    if dim is None or mesh.model == 1:
        return t
    size = t.shape[dim] // mesh.model
    return t.detach().narrow(dim, mesh.model_index * size, size).clone()


_PATH_TOKEN = re.compile(r"\.(\w+)|\[(\d+)\]")


def _set_leaf(root: nn.Module, path: str, t: torch.Tensor) -> None:
    """Replace the leaf at keystr ``path`` by ``t`` (a parameter keeps its
    ``requires_grad``)."""
    tokens = _PATH_TOKEN.findall(path)
    obj = root
    for name, idx in tokens[:-1]:
        obj = obj[int(idx)] if idx else getattr(obj, name)
    name = tokens[-1][0]
    old = getattr(obj, name)
    setattr(obj, name, nn.Parameter(t, requires_grad=old.requires_grad) if isinstance(old, nn.Parameter) else t)


def _map_leaves(params: LASParams, fn) -> LASParams:
    out = copy.deepcopy(params)
    for path, t in list(named_leaves(out)):
        new = fn(path, t)
        if new is not t:
            _set_leaf(out, path, new)
    return out


def shard_params(params: LASParams, mesh: Mesh) -> LASParams:
    """A copy of whole ``params`` holding this rank's slice of every leaf
    that the mesh shards."""
    dims = sharded_dims(params, mesh)
    return _map_leaves(params, lambda k, t: shard_tensor(t, dims[k], mesh))


def gather_params(params: LASParams, mesh: Mesh, dims: Dict[str, Optional[int]]) -> LASParams:
    """The inverse of ``shard_params``: a copy with every sharded leaf
    all-gathered whole over the data row (``dims`` from ``sharded_dims``
    of the whole params; a collective). With a model axis of 1 every rank
    holds whole leaves, and ``params`` itself is returned."""
    if mesh.model == 1:
        return params
    return _map_leaves(
        params, lambda k, t: t if dims[k] is None else mesh.gather_model(t.detach(), dims[k])
    )


# the keys of a batch that go to the device; the batch axis (dimension 0)
# of each is split over 'data'
_BATCH_SPECS = {
    "audio": 0, "audio_lengths": 0, "targets": 0, "target_lengths": 0,
    "grapheme_targets": 0, "grapheme_lengths": 0,
}


def batch_specs(batch_keys) -> Dict[str, int]:
    return {k: _BATCH_SPECS[k] for k in batch_keys if k in _BATCH_SPECS}


def row_range(rows: int, parts: int, index: int) -> Tuple[int, int]:
    """[lo, hi) of part ``index`` of ``rows`` split into ``parts`` equal
    contiguous parts (the rows must divide evenly)."""
    if rows % parts:
        raise ValueError(f"a batch of {rows} rows does not split evenly over {parts} data ranks")
    size = rows // parts
    return index * size, (index + 1) * size


def local_rows(batch: dict, mesh: Mesh) -> dict:
    """This rank's rows of a host batch: its contiguous part of the global
    batch (every key of ``_BATCH_SPECS``; ``num_real``, the count of real
    rows at the batch's head, cut to them), or under ``local_batches`` the
    process's batch as it is."""
    if mesh.local_batches or mesh.data == 1:
        return batch
    lo, hi = row_range(len(batch["audio"]), mesh.data, mesh.data_index)
    out = dict(batch)
    for k in batch_specs(batch):
        out[k] = batch[k][lo:hi]
    if batch.get("num_real") is not None:
        out["num_real"] = int(min(max(int(batch["num_real"]) - lo, 0), hi - lo))
    return out


def replicate(params: LASParams, devices: Sequence[DeviceLike]) -> List[LASParams]:
    """One copy of ``params`` on each of ``devices`` (a device named twice
    gets two copies)."""
    return [copy.deepcopy(params).to(torch.device(d)) for d in devices]


def _join_rows(parts: Sequence[Optional[torch.Tensor]]) -> Optional[torch.Tensor]:
    """Concatenate host tensors along the rows, zero-padding the other
    dimensions to the largest."""
    if parts[0] is None:
        return None
    shape = [max(p.shape[i] for p in parts) for i in range(1, parts[0].ndim)]
    padded = []
    for p in parts:
        pad = []
        for have, want in reversed(list(zip(p.shape[1:], shape))):
            pad += [0, want - have]
        padded.append(torch.nn.functional.pad(p, pad) if any(pad) else p)
    return torch.cat(padded, 0)


def map_row_shards(
    fn: Callable[..., Tuple[Optional[torch.Tensor], ...]],
    shards: Sequence[Tuple[torch.device, object]],
    *arrays: np.ndarray,
) -> Tuple[Optional[torch.Tensor], ...]:
    """Data-parallel over devices of this process: split the rows of each
    host array into ``len(shards)`` equal parts, call ``fn(state, *parts)``
    with part i on shard i's device and shard i's state (its copy of the
    parameters), all launched from this thread before any result is
    fetched, then join each output (a tensor whose dimension 0 is the
    rows, or None) on the host in row order."""
    n = len(shards)
    outs = []
    for i, (dev, state) in enumerate(shards):
        lo, hi = row_range(len(arrays[0]), n, i)
        outs.append(fn(state, *(torch.from_numpy(np.ascontiguousarray(a[lo:hi])).to(dev) for a in arrays)))
    fetched = [[None if o is None else o.cpu() for o in out] for out in outs]
    return tuple(_join_rows(col) for col in zip(*fetched))
