"""LibriSpeech corpus preparation (port of ``phones_las_tpu/data/
librispeech.py``).

Walk ``<root>/<split>/<speaker>/<chapter>/``, read the ``*.trans.txt``
transcript lists and the FLAC audio (the native decoder), and write
character targets or phone targets from the lexicon and rules, with the
seq2seq G2P for out-of-lexicon words when a model is given. The G2P model
and the CMVN pass (the front-end kernel) run on ``device``.
``text_to_chars`` also gives TIMIT prep its grapheme stream.
"""

from __future__ import annotations

import os
from typing import Iterator, List, Optional, Tuple

from phones_las_torch.data.g2p import text_to_ipa
from phones_las_torch.data.prep_common import finalize_split_dir, write_corpus_split
from phones_las_torch.data.vocab import Vocab
from phones_las_torch.frontend.features import FrontendConfig
from phones_las_torch.utils.device import DeviceLike

_CHARS = list("abcdefghijklmnopqrstuvwxyz'") + ["<space>"]


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


def iter_librispeech_split(root: str, split: str) -> Iterator[Tuple[str, str, str]]:
    """→ (utt_id, flac_path, transcript)."""
    split_dir = os.path.join(root, split)
    if not os.path.isdir(split_dir):
        raise FileNotFoundError(f"missing {split_dir}")
    for dirpath, _, files in sorted(os.walk(split_dir)):
        for fn in sorted(files):
            if not fn.endswith(".trans.txt"):
                continue
            with open(os.path.join(dirpath, fn)) as f:
                for line in f:
                    utt_id, _, text = line.strip().partition(" ")
                    if not text:
                        continue
                    flac = os.path.join(dirpath, utt_id + ".flac")
                    if os.path.exists(flac):
                        yield utt_id, flac, text


def _ipa_phone_inventory() -> List[str]:
    from phones_las_torch.data.g2p import _EN_LEXICON, _EN_RULES

    phones = set()
    for ps in _EN_LEXICON.values():
        phones.update(ps)
    for rule in _EN_RULES:
        phones.update(rule[1])
    return sorted(phones)


def load_g2p_model(g2p_model: str, device: DeviceLike = None):
    """``'bundled'`` or a model file → ``NeuralG2P`` on ``device``."""
    from phones_las_torch.models.g2p_model import NeuralG2P

    return NeuralG2P.bundled(device=device) if g2p_model == "bundled" else NeuralG2P(g2p_model, device=device)


def prepare_librispeech(
    root: str,
    out_dir: str,
    *,
    splits: Tuple[str, ...] = ("train-clean-100", "dev-clean", "test-clean"),
    targets: str = "char",  # 'char' | 'phone'
    frontend_cfg: Optional[FrontendConfig] = None,
    cmvn_max_utts: Optional[int] = 500,
    g2p_model: Optional[str] = None,
    log=print,
    device: DeviceLike = None,
) -> dict:
    """LibriSpeech splits → ``<split>.plu`` + vocab + grapheme vocab + CMVN
    stats of the first ``train*`` split; the G2P model (phone targets) and
    the CMVN pass run on ``device`` (None → CUDA)."""
    os.makedirs(out_dir, exist_ok=True)
    model = load_g2p_model(g2p_model, device) if g2p_model and targets == "phone" else None
    if targets == "char":
        vocab = Vocab(_CHARS)
    else:
        inv = set(_ipa_phone_inventory())
        if model is not None:  # the seq2seq may emit phones the rules do not
            inv.update(model.vocab_p.real_tokens)
        vocab = Vocab(sorted(inv))
    grapheme_vocab = Vocab(_CHARS)

    counts = {}
    train_split = None
    for split in splits:
        def items():
            for utt_id, flac, text in iter_librispeech_split(root, split):
                if targets == "char":
                    tokens = text_to_chars(text)
                else:
                    tokens = text_to_ipa(text, "en", model=model)
                yield utt_id, flac, tokens, text_to_chars(text), text

        out_path = os.path.join(out_dir, split.replace("/", "_") + ".plu")
        counts[split] = write_corpus_split(
            out_path, items(), vocab, grapheme_vocab,
            meta={"corpus": "librispeech", "split": split, "targets": targets, "sample_rate": 16000},
            log=log,
        )
        if train_split is None and split.startswith("train"):
            train_split = out_path
        log(f"librispeech {split}: {counts[split]} utterances")

    finalize_split_dir(
        out_dir, vocab, grapheme_vocab=grapheme_vocab,
        cmvn_from=train_split,
        frontend_cfg=frontend_cfg,
        cmvn_max_utts=cmvn_max_utts,
        meta={"corpus": "librispeech", "counts": counts, "targets": targets},
        device=device,
    )
    return counts
