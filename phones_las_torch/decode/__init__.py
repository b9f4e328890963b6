"""Decoding: greedy (the fused CUDA decoder or the speller-step loop) and
the vectorised beam search with optional joint CTC and n-gram fusion.

``beam_decode`` and ``greedy_decode`` load their modules on first use, so
importing ``decode.fused_greedy`` alone (an exported program's loader
does, for the decoder's operator) brings in no model code."""

import importlib

_LAZY = {"beam_decode": "beam", "greedy_decode": "greedy"}


def __getattr__(name):
    if name in _LAZY:
        return getattr(importlib.import_module(f"{__name__}.{_LAZY[name]}"), name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
