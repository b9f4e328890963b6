"""Parallelism: the ('data', 'model') mesh over ``torch.distributed``
ranks, its sharding rules, the process-group set-up, and the
data-parallel split of a wave over devices (port of
``phones_las_tpu/parallel/``). The names resolve lazily. The reference's
``shard_batch`` and ``shard_batch_global`` have no counterpart: a torch
process holds no global array (``mesh.local_rows`` gives a rank its rows)."""

from phones_las_torch._lazy import lazy_exports

_LAZY = {
    "Mesh": "mesh",
    "gather_params": "mesh",
    "make_mesh": "mesh",
    "map_row_shards": "mesh",
    "param_sharding_rules": "mesh",
    "replicate": "mesh",
    "shard_params": "mesh",
    "initialize_distributed": "multihost",
}

__getattr__, __dir__ = lazy_exports(__name__, _LAZY)
