"""Parallelism: the ('data', 'model') mesh over ``torch.distributed``
ranks, its sharding rules, the process-group set-up, and the
data-parallel split of a wave over devices (port of
``phones_las_tpu/parallel/``)."""

from phones_las_torch.parallel.mesh import (  # noqa: F401
    Mesh,
    gather_params,
    make_mesh,
    map_row_shards,
    param_sharding_rules,
    replicate,
    shard_params,
)
from phones_las_torch.parallel.multihost import initialize_distributed  # noqa: F401
