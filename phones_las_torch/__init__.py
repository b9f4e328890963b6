"""PyTorch/CUDA port of ``phones_las_tpu`` for one NVIDIA H100.

The JAX package is the reference; each module here mirrors the JAX
module of the same name. Plain tensor code is PyTorch, and every Pallas
kernel of the ported path is a hand-written CUDA kernel under ``csrc/``
(built at first use by ``csrc/_build.py``). A kernel wrapper given a CPU
tensor runs the kernel's plain PyTorch version; given a CUDA tensor it
launches the kernel or raises.

This package imports ``torch`` and numpy, never ``jax`` and nothing of
``phones_las_tpu``. ``Transcriber``, ``Trainer`` and ``PRESETS`` resolve
lazily, as the reference's top level does, so a bare import stays light.
"""

from phones_las_torch._lazy import lazy_exports

_LAZY = {"Transcriber": "api", "Trainer": "train", "PRESETS": "utils.config"}

__getattr__, __dir__ = lazy_exports(__name__, _LAZY)
