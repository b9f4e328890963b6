"""IPA phone inventory, binary phonological ("binf") features and the
TIMIT phone maps (a numpy-only copy of ``phones_las_tpu/data/ipa.py``).

Feature vectors are derived from articulatory descriptors (place, manner,
voicing for consonants; height, backness, rounding for vowels), so any
IPA segment built from known base symbols and diacritics gets one: 42
binary features in all (``BINF_FEATURES``). ``binf_matrix`` gives the
static code matrix of a phone list; ``ARPABET_TO_IPA`` and the Lee & Hon
61 → 39 fold ``TIMIT_FOLD_39`` serve TIMIT scoring.
"""

from __future__ import annotations

import functools
from typing import Dict, List, Sequence

import numpy as np

# ---------------------------------------------------------------------------
# Articulatory descriptor tables for base IPA segments
# ---------------------------------------------------------------------------

# consonants: ipa → (place, manner, voiced)
_CONSONANTS: Dict[str, tuple] = {
    # plosives
    "p": ("bilabial", "plosive", False), "b": ("bilabial", "plosive", True),
    "t": ("alveolar", "plosive", False), "d": ("alveolar", "plosive", True),
    "ʈ": ("retroflex", "plosive", False), "ɖ": ("retroflex", "plosive", True),
    "c": ("palatal", "plosive", False), "ɟ": ("palatal", "plosive", True),
    "k": ("velar", "plosive", False), "g": ("velar", "plosive", True),
    "ɡ": ("velar", "plosive", True),
    "q": ("uvular", "plosive", False), "ɢ": ("uvular", "plosive", True),
    "ʔ": ("glottal", "plosive", False),
    # nasals
    "m": ("bilabial", "nasal", True), "ɱ": ("labiodental", "nasal", True),
    "n": ("alveolar", "nasal", True), "ɳ": ("retroflex", "nasal", True),
    "ɲ": ("palatal", "nasal", True), "ŋ": ("velar", "nasal", True),
    "ɴ": ("uvular", "nasal", True),
    # trills / taps
    "ʙ": ("bilabial", "trill", True), "r": ("alveolar", "trill", True),
    "ʀ": ("uvular", "trill", True),
    "ɾ": ("alveolar", "tap", True), "ɽ": ("retroflex", "tap", True),
    # fricatives
    "ɸ": ("bilabial", "fricative", False), "β": ("bilabial", "fricative", True),
    "f": ("labiodental", "fricative", False), "v": ("labiodental", "fricative", True),
    "θ": ("dental", "fricative", False), "ð": ("dental", "fricative", True),
    "s": ("alveolar", "fricative", False), "z": ("alveolar", "fricative", True),
    "ʃ": ("postalveolar", "fricative", False), "ʒ": ("postalveolar", "fricative", True),
    "ʂ": ("retroflex", "fricative", False), "ʐ": ("retroflex", "fricative", True),
    "ɕ": ("palatal", "fricative", False), "ʑ": ("palatal", "fricative", True),
    "ç": ("palatal", "fricative", False), "ʝ": ("palatal", "fricative", True),
    "x": ("velar", "fricative", False), "ɣ": ("velar", "fricative", True),
    "χ": ("uvular", "fricative", False), "ʁ": ("uvular", "fricative", True),
    "ħ": ("pharyngeal", "fricative", False), "ʕ": ("pharyngeal", "fricative", True),
    "h": ("glottal", "fricative", False), "ɦ": ("glottal", "fricative", True),
    "ɬ": ("alveolar", "lateral_fricative", False),
    "ɮ": ("alveolar", "lateral_fricative", True),
    # approximants
    "ʋ": ("labiodental", "approximant", True),
    "ɹ": ("alveolar", "approximant", True),
    "ɻ": ("retroflex", "approximant", True),
    "j": ("palatal", "approximant", True),
    "ɰ": ("velar", "approximant", True),
    "w": ("labiovelar", "approximant", True),
    "ɥ": ("labiopalatal", "approximant", True),
    # lateral approximants
    "l": ("alveolar", "lateral", True), "ɭ": ("retroflex", "lateral", True),
    "ʎ": ("palatal", "lateral", True), "ʟ": ("velar", "lateral", True),
    "ɫ": ("alveolar", "lateral", True),  # velarized l
}

# affricates: ipa string → (place, voiced); manner = 'affricate'
_AFFRICATES: Dict[str, tuple] = {
    "tʃ": ("postalveolar", False), "dʒ": ("postalveolar", True),
    "ts": ("alveolar", False), "dz": ("alveolar", True),
    "tɕ": ("palatal", False), "dʑ": ("palatal", True),
    "ʈʂ": ("retroflex", False), "ɖʐ": ("retroflex", True),
    "pf": ("labiodental", False),
}

# vowels: ipa → (height, backness, rounded)
# heights: close, near_close, close_mid, mid, open_mid, near_open, open
_VOWELS: Dict[str, tuple] = {
    "i": ("close", "front", False), "y": ("close", "front", True),
    "ɨ": ("close", "central", False), "ʉ": ("close", "central", True),
    "ɯ": ("close", "back", False), "u": ("close", "back", True),
    "ɪ": ("near_close", "front", False), "ʏ": ("near_close", "front", True),
    "ʊ": ("near_close", "back", True),
    "e": ("close_mid", "front", False), "ø": ("close_mid", "front", True),
    "ɘ": ("close_mid", "central", False), "ɵ": ("close_mid", "central", True),
    "ɤ": ("close_mid", "back", False), "o": ("close_mid", "back", True),
    "ə": ("mid", "central", False),
    "ɛ": ("open_mid", "front", False), "œ": ("open_mid", "front", True),
    "ɜ": ("open_mid", "central", False), "ɞ": ("open_mid", "central", True),
    "ʌ": ("open_mid", "back", False), "ɔ": ("open_mid", "back", True),
    "æ": ("near_open", "front", False), "ɐ": ("near_open", "central", False),
    "a": ("open", "front", False), "ɶ": ("open", "front", True),
    "ɑ": ("open", "back", False), "ɒ": ("open", "back", True),
    # rhotacized
    "ɚ": ("mid", "central", False), "ɝ": ("open_mid", "central", False),
}

# diphthongs: features = nucleus vowel + 'diphthong'
_DIPHTHONGS: Dict[str, str] = {
    "eɪ": "e", "aɪ": "a", "ɔɪ": "ɔ", "aʊ": "a", "oʊ": "o",
    "ɛɪ": "ɛ", "œy": "œ", "ɔʏ": "ɔ", "ɛi": "ɛ", "ɑu": "ɑ", " øy": "ø",
    "ie": "i", "uo": "u", "ei": "e", "ou": "o", "ai": "a", "au": "a",
    "ɔi": "ɔ", "ui": "u", "iu": "i", "eu": "e", "oi": "o",
}

# combining diacritics (stripped off and turned into features)
_DIACRITICS = {
    "̩": "syllabic",       # ̩
    "̍": "syllabic",       # ̍
    "̥": "devoiced",       # ̥
    "̊": "devoiced",       # ̊
    "̃": "nasalized",      # ̃
    "ʰ": "aspirated",      # ʰ
    "ʲ": "palatalized",    # ʲ
    "ʷ": "labialized",     # ʷ
    "ˠ": "velarized",      # ˠ
    "ˤ": "pharyngealized", # ˤ
    "̴": "velarized",      # ̴
    "ː": "long",           # ː
    "̞": "lowered",        # ̞
    "̝": "raised",         # ̝
    "̠": "retracted",      # ̠
    "̟": "advanced",       # ̟
}

_PLACES = [
    "bilabial", "labiodental", "dental", "alveolar", "postalveolar",
    "retroflex", "palatal", "velar", "uvular", "pharyngeal", "glottal",
]
_HEIGHTS = ["close", "near_close", "close_mid", "mid", "open_mid", "near_open", "open"]
_BACKNESS = ["front", "central", "back"]

#: The binary feature inventory (order is the binf vector layout).
BINF_FEATURES: List[str] = (
    [
        "silence", "consonant", "vowel", "sonorant", "continuant", "voiced",
        "nasal", "lateral", "trill", "tap", "affricate", "strident",
        "approximant", "plosive", "fricative", "labial", "coronal", "dorsal",
        "anterior", "distributed",
    ]
    + ["place_" + p for p in _PLACES]
    + ["height_" + h for h in _HEIGHTS]
    + ["back_" + b for b in _BACKNESS]
    + ["rounded", "diphthong", "syllabic", "long", "aspirated", "rhotic"]
)

_FEATURE_INDEX = {f: i for i, f in enumerate(BINF_FEATURES)}

#: Labels treated as silence/non-speech (all-zeros except 'silence').
SILENCE_PHONES = {"sil", "<sil>", "sp", "spn", "pau", "h#", "epi", "nsn"}


def _consonant_features(place: str, manner: str, voiced: bool) -> set:
    f = {"consonant"}
    if voiced:
        f.add("voiced")
    if manner in ("nasal", "trill", "tap", "approximant", "lateral"):
        f.update(("sonorant",))
    if manner in ("fricative", "lateral_fricative", "approximant", "lateral", "trill", "tap"):
        f.add("continuant")
    if manner == "nasal":
        f.add("nasal")
    if manner in ("lateral", "lateral_fricative"):
        f.add("lateral")
    if manner == "trill":
        f.add("trill")
    if manner == "tap":
        f.add("tap")
    if manner == "plosive":
        f.add("plosive")
    if manner in ("fricative", "lateral_fricative"):
        f.add("fricative")
    if manner == "approximant":
        f.add("approximant")
    # strident obstruents
    if manner in ("fricative", "affricate") and place in (
        "labiodental", "alveolar", "postalveolar", "retroflex", "palatal", "uvular"
    ):
        f.add("strident")
    # place features
    if place in ("labiovelar", "labiopalatal"):
        f.update(("labial", "place_bilabial", "dorsal"))
        f.add("place_velar" if place == "labiovelar" else "place_palatal")
    else:
        f.add("place_" + place)
        if place in ("bilabial", "labiodental"):
            f.add("labial")
        if place in ("dental", "alveolar", "postalveolar", "retroflex"):
            f.add("coronal")
        if place in ("palatal", "velar", "uvular"):
            f.add("dorsal")
        if place in ("bilabial", "labiodental", "dental", "alveolar"):
            f.add("anterior")
        if place in ("postalveolar", "palatal"):
            f.add("distributed")
    return f


def _vowel_features(height: str, backness: str, rounded: bool) -> set:
    f = {"vowel", "sonorant", "continuant", "voiced", "syllabic"}
    f.add("height_" + height)
    f.add("back_" + backness)
    if rounded:
        f.add("rounded")
    return f


@functools.lru_cache(maxsize=None)
def phone_to_binf(phone: str) -> tuple:
    """IPA phone (base symbols + diacritics) → tuple of active feature
    names. Unknown/silence labels map to {'silence'}."""
    if phone in SILENCE_PHONES or phone in ("<pad>", "<sos>", "<eos>", "<unk>", "<space>"):
        return ("silence",)

    result = _phone_to_binf_composed(phone)
    if result != ("silence",):
        return result
    # retry with precomposed characters decomposed (e.g. õ → o + ̃);
    # only as a fallback — NFD would wrongly split base IPA letters
    # that happen to be precomposed (ç → c + cedilla).
    import unicodedata

    decomposed = unicodedata.normalize("NFD", phone)
    if decomposed != phone:
        return _phone_to_binf_composed(decomposed)
    return result


def _phone_to_binf_composed(phone: str) -> tuple:
    feats: set = set()
    # split off diacritics
    base = []
    for ch in phone:
        if ch in _DIACRITICS:
            d = _DIACRITICS[ch]
            if d == "devoiced":
                feats.add("_devoiced")
            elif d in ("syllabic", "nasalized", "aspirated", "long"):
                feats.add({"nasalized": "nasal"}.get(d, d))
            # secondary articulations currently not in the feature set
        else:
            base.append(ch)
    base_s = "".join(base)

    if base_s in _AFFRICATES:
        place, voiced = _AFFRICATES[base_s]
        feats |= _consonant_features(place, "plosive", voiced)
        feats.discard("plosive")
        feats.update(("affricate", "strident"))
    elif base_s in _DIPHTHONGS:
        h, b, r = _VOWELS[_DIPHTHONGS[base_s]]
        feats |= _vowel_features(h, b, r)
        feats.add("diphthong")
    elif base_s in _CONSONANTS:
        place, manner, voiced = _CONSONANTS[base_s]
        feats |= _consonant_features(place, manner, voiced)
    elif base_s in _VOWELS:
        h, b, r = _VOWELS[base_s]
        feats |= _vowel_features(h, b, r)
    elif len(base_s) == 2 and all(c in _VOWELS for c in base_s):
        # unlisted diphthong: nucleus = first vowel
        h, b, r = _VOWELS[base_s[0]]
        feats |= _vowel_features(h, b, r)
        feats.add("diphthong")
    else:
        return ("silence",)

    if "_devoiced" in feats:
        feats.discard("_devoiced")
        feats.discard("voiced")
    if base_s in ("ɚ", "ɝ", "ɹ", "ɻ", "ɽ", "r", "ɾ"):
        feats.add("rhotic")
    return tuple(sorted(feats))


def binf_matrix(phones: Sequence[str]) -> np.ndarray:
    """Phone list → static [V, len(BINF_FEATURES)] 0/1 code matrix."""
    mat = np.zeros((len(phones), len(BINF_FEATURES)), np.float32)
    for i, p in enumerate(phones):
        for f in phone_to_binf(p):
            mat[i, _FEATURE_INDEX[f]] = 1.0
    return mat


# ---------------------------------------------------------------------------
# TIMIT: ARPAbet(61) → IPA, and Lee & Hon 61→39 folding
# ---------------------------------------------------------------------------

ARPABET_TO_IPA: Dict[str, str] = {
    "iy": "i", "ih": "ɪ", "eh": "ɛ", "ey": "eɪ", "ae": "æ", "aa": "ɑ",
    "aw": "aʊ", "ay": "aɪ", "ah": "ʌ", "ao": "ɔ", "oy": "ɔɪ", "ow": "oʊ",
    "uh": "ʊ", "uw": "u", "ux": "ʉ", "er": "ɝ", "ax": "ə", "ix": "ɨ",
    "axr": "ɚ", "ax-h": "ə̥",
    "jh": "dʒ", "ch": "tʃ",
    "b": "b", "d": "d", "g": "ɡ", "p": "p", "t": "t", "k": "k", "dx": "ɾ",
    "s": "s", "sh": "ʃ", "z": "z", "zh": "ʒ", "f": "f", "th": "θ",
    "v": "v", "dh": "ð",
    "m": "m", "n": "n", "ng": "ŋ", "em": "m̩", "en": "n̩",
    "eng": "ŋ̩", "nx": "ɾ̃",
    "l": "l", "r": "ɹ", "w": "w", "y": "j", "hh": "h", "hv": "ɦ",
    "el": "l̩",
    "q": "ʔ",
    # closures and non-speech → silence
    "bcl": "sil", "dcl": "sil", "gcl": "sil", "pcl": "sil", "tcl": "sil",
    "kcl": "sil", "epi": "sil", "pau": "sil", "h#": "sil",
}

# Lee & Hon (1989) folding to 39 classes for scoring; 'q' is deleted.
TIMIT_FOLD_39: Dict[str, str] = {
    "ix": "ih", "ax": "ah", "ax-h": "ah", "ux": "uw", "axr": "er",
    "em": "m", "en": "n", "eng": "ng", "nx": "n", "hv": "hh", "el": "l",
    "zh": "sh", "ao": "aa",
    "bcl": "sil", "dcl": "sil", "gcl": "sil", "pcl": "sil", "tcl": "sil",
    "kcl": "sil", "epi": "sil", "pau": "sil", "h#": "sil",
    "q": "",  # deleted
}


def fold_timit(phones: Sequence[str]) -> List[str]:
    """Apply the 61→39 fold (for scoring); deletes 'q'."""
    out = []
    for p in phones:
        p = TIMIT_FOLD_39.get(p, p)
        if p:
            out.append(p)
    return out
