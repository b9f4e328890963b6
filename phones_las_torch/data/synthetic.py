"""Synthetic learnable corpus for integration tests and benchmarks (a copy
of ``phones_las_tpu/data/synthetic.py``; the same seeds give bitwise the
same audio and targets).

SURVEY.md §5 item 3 calls for a ~30-utterance synthetic corpus on which a
tiny model demonstrably learns. Each "phone" is a pure tone at a
phone-specific frequency; an utterance is a random phone sequence with
random per-phone durations, so the audio→label mapping is learnable from
spectral features alone.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

from phones_las_torch.data.records import RecordWriter, Utterance
from phones_las_torch.data.vocab import Vocab


def synth_phone_inventory(n: int = 10) -> List[str]:
    return [f"ph{i}" for i in range(n)]


def synth_grapheme_inventory() -> List[str]:
    return ["p", "h"] + [str(d) for d in range(10)] + ["|"]


def synth_utterance(
    rng: np.random.RandomState,
    vocab: Vocab,
    utt_id: str,
    *,
    n_phones_range=(3, 8),
    dur_range_ms=(60, 160),
    sample_rate=16000,
    amplitude=3000.0,
    grapheme_vocab: Optional[Vocab] = None,
) -> Utterance:
    phones = vocab.real_tokens
    n = rng.randint(*n_phones_range)
    seq = rng.randint(0, len(phones), n)
    pieces = []
    for p in seq:
        dur = rng.randint(*dur_range_ms) * sample_rate // 1000
        freq = 200.0 + 300.0 * p  # distinct, well below Nyquist for ≤20 phones
        t = np.arange(dur) / sample_rate
        tone = amplitude * np.sin(2 * np.pi * freq * t + rng.uniform(0, 2 * np.pi))
        pieces.append(tone)
    audio = np.concatenate(pieces) + rng.randn(sum(p.shape[0] for p in pieces)) * 50.0
    targets = np.asarray(vocab.encode([phones[p] for p in seq]), np.int32)
    graphemes = None
    text = " ".join(phones[p] for p in seq)
    if grapheme_vocab is not None:
        # spell each phone name out ('ph3' → p h 3) with '|' separators: a
        # learnable 1:many grapheme task over the same audio (multitask)
        chars: List[str] = []
        for j, p in enumerate(seq):
            if j:
                chars.append("|")
            chars += list(phones[p])
        graphemes = np.asarray(grapheme_vocab.encode(chars), np.int32)
    return Utterance(utt_id, audio.astype(np.int16), targets, graphemes, text)


def write_synth_corpus(
    path: str,
    *,
    n_utts: int = 32,
    n_phones: int = 10,
    seed: int = 0,
    vocab_path: Optional[str] = None,
    graphemes: bool = False,
    n_phones_range: Tuple[int, int] = (3, 8),
) -> Tuple[str, Vocab]:
    vocab = Vocab(synth_phone_inventory(n_phones))
    gvocab = Vocab(synth_grapheme_inventory()) if graphemes else None
    rng = np.random.RandomState(seed)
    with RecordWriter(path, meta={"corpus": "synthetic", "sample_rate": 16000}) as w:
        for i in range(n_utts):
            w.write(synth_utterance(rng, vocab, f"synth-{i:04d}",
                                    n_phones_range=n_phones_range,
                                    grapheme_vocab=gvocab))
    if vocab_path:
        vocab.save(vocab_path)
    return path, vocab
