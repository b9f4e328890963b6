"""Device resolution and numerics switches shared by the port's entry points.

Rule: ``device=None`` means CUDA. Without a CUDA device that raises; the
plain PyTorch path on the CPU runs only when the caller asks for it
(``device="cpu"``), as the CPU tests do. Nothing falls back quietly.
"""

from __future__ import annotations

import contextlib
import threading
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


class _PrecisionScopes:
    """The process's open precision scopes. The TF32 flags are process-wide
    (``jax.default_matmul_precision`` is thread-local), so scopes held by
    several threads at once must agree: one lock, one depth count, the
    flags saved and set by the first scope to enter and restored by the
    last to leave."""

    def __init__(self):
        self.lock = threading.Lock()
        self.depth = 0
        self.tf32: Optional[bool] = None
        self.saved = (False, False)

    def enter(self, tf32: bool) -> None:
        with self.lock:
            if self.depth == 0:
                self.saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
                torch.backends.cuda.matmul.allow_tf32 = tf32
                torch.backends.cudnn.allow_tf32 = tf32
                self.tf32 = tf32
            elif tf32 != self.tf32:
                raise RuntimeError(
                    f"a matmul precision scope with TF32 {'on' if self.tf32 else 'off'} is open "
                    f"(in this thread or another); one with TF32 {'on' if tf32 else 'off'} cannot "
                    "enter while it is: the flags are process-wide"
                )
            self.depth += 1

    def leave(self) -> None:
        with self.lock:
            self.depth -= 1
            if self.depth == 0:
                torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = self.saved
                self.tf32 = None


_SCOPES = _PrecisionScopes()


@contextlib.contextmanager
def matmul_precision_scope(matmul_precision: str) -> Iterator[None]:
    """The counterpart of ``jax.default_matmul_precision`` for the GEMMs
    outside the recurrences: 'highest' (parity mode) turns TF32 off for
    matrix products and cuDNN; any other value ('default', production
    mode) allows it, as XLA runs float32 dots as TF32 under 'default' on
    an NVIDIA GPU. The recurrent dots take their precision from ``prec``
    instead.

    Scopes may be held by several threads at once (a server's drainer and
    its request threads) as long as they ask for the same TF32 setting;
    asking for the other one while a scope is open raises. The flags are
    set when the first scope enters and restored when the last one leaves,
    so process-wide state is never left changed."""
    _SCOPES.enter(matmul_precision != "highest")
    try:
        yield
    finally:
        _SCOPES.leave()


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
