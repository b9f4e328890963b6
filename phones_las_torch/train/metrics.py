"""The reference's module path ``train.metrics``. The metrics live in
``utils/metrics.py`` (the serving side uses them without the training
layer); this module re-exports them."""

from phones_las_torch.utils.metrics import (  # noqa: F401
    _edit_distance,
    attention_image,
    edit_distance_stats,
    per_from_stats,
    word_error_stats,
)
