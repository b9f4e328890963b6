"""Training layer (port of ``phones_las_tpu/train``): ``state`` (config,
Adam with clipping, gradient masking), ``loop`` (the Trainer),
``checkpoint`` and ``metrics``. The reference's re-exports resolve lazily."""

from phones_las_torch._lazy import lazy_exports

_LAZY = {
    "TrainState": "state",
    "TrainConfig": "state",
    "create_train_state": "state",
    "Trainer": "loop",
    "edit_distance_stats": "metrics",
    "per_from_stats": "metrics",
}

__getattr__, __dir__ = lazy_exports(__name__, _LAZY)
