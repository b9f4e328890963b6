"""Lazy re-exports for the package ``__init__`` files (PEP 562).

A package lists the names it re-exports in a ``_LAZY`` table, name →
module path relative to the package, and takes ``__getattr__`` and
``__dir__`` from ``lazy_exports``. A name's module is imported on first
access, so importing a package pulls in none of the modules behind its
names (an exported program's loader imports ``decode.fused_greedy`` and
must not load the model code)."""

import importlib
import sys
from typing import Callable, Dict, List, Tuple


def lazy_exports(package: str, table: Dict[str, str]) -> Tuple[Callable, Callable]:
    """→ (``__getattr__``, ``__dir__``) of ``package`` over ``table``."""

    def __getattr__(name: str):
        if name in table:
            return getattr(importlib.import_module(f"{package}.{table[name]}"), name)
        raise AttributeError(f"module {package!r} has no attribute {name!r}")

    def __dir__() -> List[str]:
        return sorted(set(vars(sys.modules[package])) | set(table))

    return __getattr__, __dir__
