"""Device rule, artifact loading, presets and metrics of the port. The
reference's re-exports resolve lazily."""

from phones_las_torch._lazy import lazy_exports

_LAZY = {"Preset": "config", "PRESETS": "config", "get_preset": "config"}

__getattr__, __dir__ = lazy_exports(__name__, _LAZY)
