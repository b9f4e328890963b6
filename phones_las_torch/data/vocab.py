"""Token vocabulary (a copy of ``phones_las_tpu/data/vocab.py``): forward
and reverse lookup with ``<pad>``/``<sos>``/``<eos>``/``<unk>`` at ids 0–3;
on disk, plain text, one token per line (ids are line order after the
four specials).
"""

from __future__ import annotations

from typing import Iterable, List, Sequence

PAD, SOS, EOS, UNK = "<pad>", "<sos>", "<eos>", "<unk>"
SPECIALS = [PAD, SOS, EOS, UNK]


class Vocab:
    def __init__(self, tokens: Sequence[str]):
        """``tokens`` excludes specials; specials always occupy ids 0–3."""
        self.tokens: List[str] = SPECIALS + [t for t in tokens if t not in SPECIALS]
        self._index = {t: i for i, t in enumerate(self.tokens)}

    pad_id, sos_id, eos_id, unk_id = 0, 1, 2, 3

    def __len__(self) -> int:
        return len(self.tokens)

    def __contains__(self, tok: str) -> bool:
        return tok in self._index

    def encode(self, toks: Iterable[str]) -> List[int]:
        return [self._index.get(t, self.unk_id) for t in toks]

    def decode(self, ids: Iterable[int], *, strip_specials: bool = True) -> List[str]:
        out = []
        for i in ids:
            t = self.tokens[int(i)]
            if strip_specials and t in SPECIALS:
                continue
            out.append(t)
        return out

    @property
    def real_tokens(self) -> List[str]:
        return self.tokens[len(SPECIALS):]

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            for t in self.real_tokens:
                f.write(t + "\n")

    @classmethod
    def load(cls, path: str) -> "Vocab":
        with open(path) as f:
            return cls([ln.rstrip("\n") for ln in f if ln.rstrip("\n")])

    @classmethod
    def from_corpus(cls, token_iter: Iterable[Iterable[str]]) -> "Vocab":
        seen = {}
        for seq in token_iter:
            for t in seq:
                seen.setdefault(t, len(seen))
        return cls(sorted(seen, key=seen.get))
