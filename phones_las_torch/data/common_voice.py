"""Common Voice corpus preparation, multilingual IPA (port of
``phones_las_tpu/data/common_voice.py``).

Read ``validated.tsv`` per language, decode the clips (distribution
.mp3 through the native decoder and polyphase resampler, or WAV/FLAC),
normalise the text and convert it to IPA with the rule tables of
``data.g2p`` (English also through the seq2seq G2P when a model is
given), and merge the languages' phone inventories into one shared IPA
vocabulary. The G2P model and the CMVN pass (the front-end kernel) run
on ``device``.
"""

from __future__ import annotations

import csv
import os
from typing import Iterator, List, Optional, Sequence, Tuple

from phones_las_torch.data.g2p import text_to_ipa
from phones_las_torch.data.prep_common import finalize_split_dir, write_corpus_split
from phones_las_torch.data.vocab import Vocab
from phones_las_torch.frontend.features import FrontendConfig
from phones_las_torch.utils.device import DeviceLike

_CLIP_EXTS = (".wav", ".flac", ".mp3")


def _resolve_clip(clips_dir: str, name: str) -> Optional[str]:
    base = os.path.join(clips_dir, os.path.splitext(name)[0])
    for ext in _CLIP_EXTS:
        if os.path.exists(base + ext):
            return base + ext
    p = os.path.join(clips_dir, name)
    return p if os.path.exists(p) and p.lower().endswith(_CLIP_EXTS) else None


def iter_common_voice(lang_root: str, tsv: str = "validated.tsv") -> Iterator[Tuple[str, str, str]]:
    """→ (utt_id, clip_path, sentence)."""
    tsv_path = os.path.join(lang_root, tsv)
    clips = os.path.join(lang_root, "clips")
    with open(tsv_path, newline="", encoding="utf-8") as f:
        for row in csv.DictReader(f, delimiter="\t"):
            sent = (row.get("sentence") or "").strip()
            name = row.get("path") or ""
            if not sent or not name:
                continue
            clip = _resolve_clip(clips, name)
            if clip is None:
                continue
            yield os.path.splitext(name)[0], clip, sent


def _graphemes(text: str) -> List[str]:
    from phones_las_torch.data.librispeech import text_to_chars

    return text_to_chars(text)


def prepare_common_voice(
    root: str,
    out_dir: str,
    langs: Sequence[str],
    *,
    tsv: str = "validated.tsv",
    frontend_cfg: Optional[FrontendConfig] = None,
    cmvn_max_utts: Optional[int] = 500,
    max_per_lang: Optional[int] = None,
    g2p_model: Optional[str] = None,
    log=print,
    device: DeviceLike = None,
) -> dict:
    """``root`` holds one directory per language code. Builds ONE merged
    IPA vocabulary over all languages and a record file per language; the
    G2P model (English text only) and the CMVN pass run on ``device``
    (None → CUDA)."""
    from phones_las_torch.data.librispeech import load_g2p_model

    os.makedirs(out_dir, exist_ok=True)
    # trained on English; other languages keep the rules
    model = load_g2p_model(g2p_model, device) if g2p_model else None

    # pass 1: every (lang, utt) token sequence, to build the shared vocab
    parsed = {}
    phone_set, seen = [], set()
    grapheme_set, gseen = [], set()
    for lang in langs:
        items = []
        for utt_id, clip, sent in iter_common_voice(os.path.join(root, lang), tsv):
            phones = text_to_ipa(sent, lang, model=model if lang == "en" else None)
            if not phones:
                continue
            graphemes = _graphemes(sent)
            items.append((f"{lang}-{utt_id}", clip, phones, graphemes, sent))
            for p in phones:
                if p not in seen:
                    seen.add(p)
                    phone_set.append(p)
            for g in graphemes:
                if g not in gseen:
                    gseen.add(g)
                    grapheme_set.append(g)
            if max_per_lang and len(items) >= max_per_lang:
                break
        parsed[lang] = items
        log(f"common_voice {lang}: {len(items)} clips parsed")

    vocab = Vocab(sorted(phone_set))
    grapheme_vocab = Vocab(sorted(grapheme_set))

    counts = {}
    first_path = None
    for lang, items in parsed.items():
        out_path = os.path.join(out_dir, f"{lang}.plu")
        counts[lang] = write_corpus_split(
            out_path, iter(items), vocab, grapheme_vocab,
            meta={"corpus": "common_voice", "lang": lang, "sample_rate": 16000},
            log=log,
        )
        first_path = first_path or out_path

    finalize_split_dir(
        out_dir, vocab, grapheme_vocab=grapheme_vocab,
        cmvn_from=first_path,
        frontend_cfg=frontend_cfg,
        cmvn_max_utts=cmvn_max_utts,
        meta={"corpus": "common_voice", "langs": list(langs), "counts": counts},
        device=device,
    )
    return counts
