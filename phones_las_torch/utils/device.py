"""Device resolution and numerics switches shared by the port's entry points.

Rule: ``device=None`` means CUDA. Without a CUDA device that raises; the
plain PyTorch path on the CPU runs only when the caller asks for it
(``device="cpu"``), as the CPU tests do. Nothing falls back quietly.
"""

from __future__ import annotations

import contextlib
from typing import Iterator, Optional, Union

import torch

DeviceLike = Optional[Union[str, torch.device]]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` → ``cuda`` (raises without a CUDA device); else as given."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "phones_las_torch runs on CUDA by default and no CUDA device "
                "is available; pass device='cpu' to run the plain PyTorch path"
            )
        return torch.device("cuda")
    return torch.device(device)


def set_parity_mode() -> dict:
    """Parity mode (the JAX package's ``matmul_precision='highest'``):
    float32 matrix products and cuDNN calls without TF32.

    Sets ``torch.backends.cuda.matmul.allow_tf32 = False`` and
    ``torch.backends.cudnn.allow_tf32 = False`` (the latter is True by
    default in PyTorch) and returns both settings so a caller can print
    them."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return {
        "cuda.matmul.allow_tf32": torch.backends.cuda.matmul.allow_tf32,
        "cudnn.allow_tf32": torch.backends.cudnn.allow_tf32,
    }


@contextlib.contextmanager
def matmul_precision_scope(matmul_precision: str) -> Iterator[None]:
    """The counterpart of ``jax.default_matmul_precision`` for the GEMMs
    outside the recurrences: 'highest' (parity mode) turns TF32 off for
    matrix products and cuDNN; any other value ('default', production
    mode) allows it, as XLA runs float32 dots as TF32 under 'default' on
    an NVIDIA GPU. The recurrent dots take their precision from ``prec``
    instead. Both flags are restored on exit, so process-wide state is
    never left changed."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    tf32 = matmul_precision != "highest"
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def check_kernel_device(*tensors: torch.Tensor) -> bool:
    """→ True when every tensor lies on CUDA (the kernel runs), False when
    every tensor lies on the CPU (the plain version runs). Anything else —
    mixed devices, or another device type — raises."""
    kinds = {t.device.type for t in tensors}
    if kinds == {"cuda"}:
        return True
    if kinds == {"cpu"}:
        return False
    raise ValueError(f"tensors must all lie on CUDA or all on the CPU, got {sorted(kinds)}")
