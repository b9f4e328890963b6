"""LibriSpeech text helpers (the part of ``phones_las_tpu/data/
librispeech.py`` that needs no G2P): ``text_to_chars``, the character
targets of a transcript, which TIMIT prep also uses for its grapheme
stream. ``prepare_librispeech`` itself imports the G2P module at module
level in the reference and comes with the port's G2P."""

from __future__ import annotations

from typing import List


def text_to_chars(text: str) -> List[str]:
    """Lower-cased letters and apostrophes of each word, words joined by
    ``<space>``; characters of no other kind are dropped."""
    words = []
    for w in text.lower().split():
        kept = [ch for ch in w if ch.isalpha() or ch == "'"]
        if kept:
            words.append(kept)
    out: List[str] = []
    for i, w in enumerate(words):
        if i:
            out.append("<space>")
        out.extend(w)
    return out
