"""Decoding: greedy (the fused CUDA decoder or the speller-step loop) and
the vectorised beam search with optional joint CTC and n-gram fusion.

``beam_decode`` and ``greedy_decode`` load their modules on first use, so
importing ``decode.fused_greedy`` alone (an exported program's loader
does, for the decoder's operator) brings in no model code."""

from phones_las_torch._lazy import lazy_exports

_LAZY = {"beam_decode": "beam", "greedy_decode": "greedy"}

__getattr__, __dir__ = lazy_exports(__name__, _LAZY)
