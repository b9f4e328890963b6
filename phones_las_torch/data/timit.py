"""TIMIT corpus preparation (port of ``phones_las_tpu/data/timit.py``).

Walk the TIMIT directories, read NIST-sphere audio and ``.PHN`` phone
intervals, map the 61-label set to IPA (``output_ipa``) or keep ARPAbet,
and write records, vocabularies and CMVN stats (computed on ``device``).
SA sentences are excluded by default (identical across speakers). Scoring
uses the 61→39 fold (``data.ipa.TIMIT_FOLD_39``) at metric time, not here.
"""

from __future__ import annotations

import os
from typing import Iterator, List, Optional, Tuple

from phones_las_torch.data.ipa import ARPABET_TO_IPA
from phones_las_torch.data.librispeech import text_to_chars
from phones_las_torch.data.prep_common import finalize_split_dir, write_corpus_split
from phones_las_torch.data.vocab import Vocab
from phones_las_torch.frontend.features import FrontendConfig
from phones_las_torch.utils.device import DeviceLike

_GRAPHEMES = list("abcdefghijklmnopqrstuvwxyz'") + ["<space>"]


def parse_phn(path: str) -> List[str]:
    phones = []
    with open(path) as f:
        for line in f:
            parts = line.split()
            if len(parts) == 3:
                phones.append(parts[2].lower())
    return phones


def _find(path_noext: str, exts: Tuple[str, ...]) -> Optional[str]:
    for e in exts:
        for cand in (path_noext + e, path_noext + e.upper()):
            if os.path.exists(cand):
                return cand
    return None


def iter_timit_split(
    root: str, split: str, *, include_sa: bool = False
) -> Iterator[Tuple[str, str, str, str]]:
    """→ (utt_id, wav_path, phn_path, txt_path) for TRAIN or TEST."""
    split_dir = None
    for cand in (split, split.upper(), split.lower()):
        d = os.path.join(root, cand)
        if os.path.isdir(d):
            split_dir = d
            break
    if split_dir is None:
        raise FileNotFoundError(f"no {split} under {root}")
    for dirpath, _, files in sorted(os.walk(split_dir)):
        for fn in sorted(files):
            low = fn.lower()
            if not low.endswith(".phn"):
                continue
            base = fn[: -len(".phn")]
            if not include_sa and base.lower().startswith("sa"):
                continue
            noext = os.path.join(dirpath, base)
            wav = _find(noext, (".wav",))
            txt = _find(noext, (".txt",))
            if wav is None:
                continue
            speaker = os.path.basename(dirpath)
            utt_id = f"{speaker}-{base}".lower()
            yield utt_id, wav, os.path.join(dirpath, fn), txt


def _graphemes_from_txt(txt_path: Optional[str]) -> Optional[List[str]]:
    if txt_path is None:
        return None
    with open(txt_path) as f:
        line = f.read().strip()
    # TIMIT .TXT: "<start> <end> sentence text"
    return text_to_chars(" ".join(line.split()[2:]))


def timit_phone_inventory(output_ipa: bool) -> List[str]:
    arpa = sorted(ARPABET_TO_IPA)
    if not output_ipa:
        return arpa
    seen = []
    for a in arpa:
        p = ARPABET_TO_IPA[a]
        if p not in seen:
            seen.append(p)
    return seen


def prepare_timit(
    root: str,
    out_dir: str,
    *,
    output_ipa: bool = True,
    include_sa: bool = False,
    frontend_cfg: Optional[FrontendConfig] = None,
    cmvn_max_utts: Optional[int] = 500,
    log=print,
    device: DeviceLike = None,
) -> dict:
    """TIMIT → {train,test}.plu + vocab + grapheme vocab + CMVN stats, the
    stats computed on ``device`` (None → CUDA)."""
    os.makedirs(out_dir, exist_ok=True)
    vocab = Vocab(timit_phone_inventory(output_ipa))
    grapheme_vocab = Vocab(_GRAPHEMES)

    counts = {}
    for split in ("TRAIN", "TEST"):
        def items():
            for utt_id, wav, phn, txt in iter_timit_split(
                root, split, include_sa=include_sa
            ):
                phones = parse_phn(phn)
                tokens = (
                    [ARPABET_TO_IPA.get(p, "sil") for p in phones]
                    if output_ipa
                    else phones
                )
                yield utt_id, wav, tokens, _graphemes_from_txt(txt), ""

        out_path = os.path.join(out_dir, f"{split.lower()}.plu")
        counts[split.lower()] = write_corpus_split(
            out_path, items(), vocab, grapheme_vocab,
            meta={"corpus": "timit", "split": split.lower(),
                  "output_ipa": output_ipa, "sample_rate": 16000},
            log=log,
        )
        log(f"timit {split}: {counts[split.lower()]} utterances")

    finalize_split_dir(
        out_dir, vocab, grapheme_vocab=grapheme_vocab,
        cmvn_from=os.path.join(out_dir, "train.plu"),
        frontend_cfg=frontend_cfg,
        cmvn_max_utts=cmvn_max_utts,
        device=device,
        meta={"corpus": "timit", "counts": counts, "output_ipa": output_ipa},
    )
    return counts
