"""Grapheme → IPA conversion: rule tables and the English lexicon (a copy
of ``phones_las_tpu/data/g2p.py``, pure Python).

Longest-match rewrite tables for languages with (near-)phonemic
orthographies, and for English a lexicon of frequent and irregular words
in front of context-sensitive letter-to-sound rules. ``text_to_ipa`` takes
an optional trained model (``models.g2p_model.NeuralG2P``) for English
words outside the lexicon; the rules stay the fallback for what it does
not handle. A caller may pass its own ``rules`` or ``lexicon``.

Output phones use the inventory of ``data.ipa``, so binf features derive
from them.
"""

from __future__ import annotations

import re
import unicodedata
from typing import Dict, List, Optional, Sequence, Tuple

# Each rule: (grapheme string, ipa phones tuple). Applied longest-first at
# each position. Context-sensitive rules use a regex as the first element
# (matched at the current position) — kept rare for speed.

_ES_RULES = [
    ("ch", ("tʃ",)), ("ll", ("ʎ",)), ("rr", ("r",)), ("qu", ("k",)),
    ("gue", ("ɡ", "e")), ("gui", ("ɡ", "i")), ("güe", ("ɡ", "w", "e")),
    ("güi", ("ɡ", "w", "i")),
    ("ge", ("x", "e")), ("gi", ("x", "i")),
    ("ce", ("θ", "e")), ("ci", ("θ", "i")),
    ("ñ", ("ɲ",)), ("j", ("x",)), ("z", ("θ",)), ("v", ("b",)),
    ("h", ()), ("x", ("k", "s")), ("y", ("ʝ",)), ("w", ("w",)),
    ("á", ("a",)), ("é", ("e",)), ("í", ("i",)), ("ó", ("o",)), ("ú", ("u",)),
    ("ü", ("w",)),
    ("a", ("a",)), ("e", ("e",)), ("i", ("i",)), ("o", ("o",)), ("u", ("u",)),
    ("b", ("b",)), ("c", ("k",)), ("d", ("d",)), ("f", ("f",)), ("g", ("ɡ",)),
    ("k", ("k",)), ("l", ("l",)), ("m", ("m",)), ("n", ("n",)), ("p", ("p",)),
    ("q", ("k",)), ("r", ("ɾ",)), ("s", ("s",)), ("t", ("t",)),
]

_IT_RULES = [
    ("sch", ("s", "k")), ("sci", ("ʃ", "i")), ("sce", ("ʃ", "e")),
    ("gli", ("ʎ", "i")), ("gn", ("ɲ",)),
    ("chi", ("k", "i")), ("che", ("k", "e")),
    ("ghi", ("ɡ", "i")), ("ghe", ("ɡ", "e")),
    ("ci", ("tʃ", "i")), ("ce", ("tʃ", "e")),
    ("gi", ("dʒ", "i")), ("ge", ("dʒ", "e")),
    ("zz", ("ts",)), ("z", ("dz",)), ("h", ()),
    ("à", ("a",)), ("è", ("ɛ",)), ("é", ("e",)), ("ì", ("i",)),
    ("ò", ("ɔ",)), ("ó", ("o",)), ("ù", ("u",)),
    ("a", ("a",)), ("e", ("e",)), ("i", ("i",)), ("o", ("o",)), ("u", ("u",)),
    ("b", ("b",)), ("c", ("k",)), ("d", ("d",)), ("f", ("f",)), ("g", ("ɡ",)),
    ("l", ("l",)), ("m", ("m",)), ("n", ("n",)), ("p", ("p",)), ("q", ("k",)),
    ("r", ("r",)), ("s", ("s",)), ("t", ("t",)), ("v", ("v",)), ("w", ("w",)),
    ("x", ("k", "s")), ("y", ("j",)), ("k", ("k",)), ("j", ("j",)),
]

_DE_RULES = [
    ("sch", ("ʃ",)), ("tsch", ("tʃ",)), ("chs", ("k", "s")),
    ("ch", ("ç",)), ("ck", ("k",)), ("ph", ("f",)), ("th", ("t",)),
    ("qu", ("k", "v")), ("sp", ("ʃ", "p")), ("st", ("ʃ", "t")),
    ("ei", ("aɪ",)), ("ai", ("aɪ",)), ("au", ("aʊ",)), ("eu", ("ɔʏ",)),
    ("äu", ("ɔʏ",)), ("ie", ("iː",)),
    ("ä", ("ɛ",)), ("ö", ("ø",)), ("ü", ("y",)), ("ß", ("s",)),
    ("a", ("a",)), ("e", ("ə",)), ("i", ("ɪ",)), ("o", ("ɔ",)), ("u", ("ʊ",)),
    ("b", ("b",)), ("c", ("k",)), ("d", ("d",)), ("f", ("f",)), ("g", ("ɡ",)),
    ("h", ("h",)), ("j", ("j",)), ("k", ("k",)), ("l", ("l",)), ("m", ("m",)),
    ("n", ("n",)), ("p", ("p",)), ("r", ("ʁ",)), ("s", ("z",)), ("t", ("t",)),
    ("v", ("f",)), ("w", ("v",)), ("x", ("k", "s")), ("y", ("y",)), ("z", ("ts",)),
]

# English lexicon for frequent/irregular words; regular spellings go
# through the context-sensitive letter-to-sound rules below
_EN_LEXICON: Dict[str, Tuple[str, ...]] = {
    # numbers, function words, frequent irregulars
    "one": ("w", "ʌ", "n"), "two": ("t", "u"), "three": ("θ", "ɹ", "i"),
    "four": ("f", "ɔ", "ɹ"), "five": ("f", "aɪ", "v"), "six": ("s", "ɪ", "k", "s"),
    "seven": ("s", "ɛ", "v", "ə", "n"), "eight": ("eɪ", "t"),
    "nine": ("n", "aɪ", "n"), "ten": ("t", "ɛ", "n"),
    "people": ("p", "i", "p", "ə", "l"), "very": ("v", "ɛ", "ɹ", "i"),
    "only": ("oʊ", "n", "l", "i"), "over": ("oʊ", "v", "ɚ"),
    "also": ("ɔ", "l", "s", "oʊ"), "after": ("æ", "f", "t", "ɚ"),
    "first": ("f", "ɝ", "s", "t"), "because": ("b", "ɪ", "k", "ʌ", "z"),
    "does": ("d", "ʌ", "z"), "goes": ("ɡ", "oʊ", "z"), "gone": ("ɡ", "ɔ", "n"),
    "give": ("ɡ", "ɪ", "v"), "given": ("ɡ", "ɪ", "v", "ə", "n"),
    "live": ("l", "ɪ", "v"), "love": ("l", "ʌ", "v"), "move": ("m", "u", "v"),
    "none": ("n", "ʌ", "n"), "once": ("w", "ʌ", "n", "s"),
    "own": ("oʊ", "n"), "most": ("m", "oʊ", "s", "t"),
    "both": ("b", "oʊ", "θ"), "water": ("w", "ɔ", "t", "ɚ"),
    "great": ("ɡ", "ɹ", "eɪ", "t"), "through": ("θ", "ɹ", "u"),
    "though": ("ð", "oʊ"), "thought": ("θ", "ɔ", "t"),
    "enough": ("ɪ", "n", "ʌ", "f"), "again": ("ə", "ɡ", "ɛ", "n"),
    "against": ("ə", "ɡ", "ɛ", "n", "s", "t"), "any": ("ɛ", "n", "i"),
    "every": ("ɛ", "v", "ɹ", "i"), "never": ("n", "ɛ", "v", "ɚ"),
    "here": ("h", "ɪ", "ɹ"), "where": ("w", "ɛ", "ɹ"), "why": ("w", "aɪ"),
    "eye": ("aɪ",), "eyes": ("aɪ", "z"), "busy": ("b", "ɪ", "z", "i"),
    "business": ("b", "ɪ", "z", "n", "ə", "s"),
    "woman": ("w", "ʊ", "m", "ə", "n"), "women": ("w", "ɪ", "m", "ə", "n"),
    "says": ("s", "ɛ", "z"), "pretty": ("p", "ɹ", "ɪ", "t", "i"),
    "friend": ("f", "ɹ", "ɛ", "n", "d"), "should": ("ʃ", "ʊ", "d"),
    "world": ("w", "ɝ", "l", "d"), "work": ("w", "ɝ", "k"),
    "word": ("w", "ɝ", "d"), "warm": ("w", "ɔ", "ɹ", "m"),
    "war": ("w", "ɔ", "ɹ"), "want": ("w", "ɑ", "n", "t"),
    "watch": ("w", "ɑ", "tʃ"), "wash": ("w", "ɑ", "ʃ"),
    "whole": ("h", "oʊ", "l"), "whose": ("h", "u", "z"),
    "heart": ("h", "ɑ", "ɹ", "t"), "earth": ("ɝ", "θ"),
    "early": ("ɝ", "l", "i"), "learn": ("l", "ɝ", "n"),
    "laugh": ("l", "æ", "f"), "daughter": ("d", "ɔ", "t", "ɚ"),
    "father": ("f", "ɑ", "ð", "ɚ"), "mother": ("m", "ʌ", "ð", "ɚ"),
    "brother": ("b", "ɹ", "ʌ", "ð", "ɚ"), "another": ("ə", "n", "ʌ", "ð", "ɚ"),
    "money": ("m", "ʌ", "n", "i"), "month": ("m", "ʌ", "n", "θ"),
    "some": ("s", "ʌ", "m"), "come": ("k", "ʌ", "m"), "done": ("d", "ʌ", "n"),
    "son": ("s", "ʌ", "n"), "front": ("f", "ɹ", "ʌ", "n", "t"),
    "won": ("w", "ʌ", "n"), "today": ("t", "ə", "d", "eɪ"),
    "together": ("t", "ə", "ɡ", "ɛ", "ð", "ɚ"), "too": ("t", "u"),
    "shoe": ("ʃ", "u"), "shoes": ("ʃ", "u", "z"), "sure": ("ʃ", "ʊ", "ɹ"),
    "sugar": ("ʃ", "ʊ", "ɡ", "ɚ"), "usual": ("j", "u", "ʒ", "u", "ə", "l"),
    "young": ("j", "ʌ", "ŋ"), "touch": ("t", "ʌ", "tʃ"),
    "country": ("k", "ʌ", "n", "t", "ɹ", "i"),
    "cousin": ("k", "ʌ", "z", "ə", "n"), "double": ("d", "ʌ", "b", "ə", "l"),
    "trouble": ("t", "ɹ", "ʌ", "b", "ə", "l"), "blood": ("b", "l", "ʌ", "d"),
    "flood": ("f", "l", "ʌ", "d"), "door": ("d", "ɔ", "ɹ"),
    "floor": ("f", "l", "ɔ", "ɹ"), "poor": ("p", "ʊ", "ɹ"),
    "course": ("k", "ɔ", "ɹ", "s"), "court": ("k", "ɔ", "ɹ", "t"),
    "island": ("aɪ", "l", "ə", "n", "d"), "hour": ("aʊ", "ɚ"),
    "honest": ("ɑ", "n", "ə", "s", "t"), "answer": ("æ", "n", "s", "ɚ"),
    "often": ("ɔ", "f", "ə", "n"), "listen": ("l", "ɪ", "s", "ə", "n"),
    "half": ("h", "æ", "f"), "walk": ("w", "ɔ", "k"), "talk": ("t", "ɔ", "k"),
    "pull": ("p", "ʊ", "l"), "push": ("p", "ʊ", "ʃ"), "put": ("p", "ʊ", "t"),
    "full": ("f", "ʊ", "l"), "bush": ("b", "ʊ", "ʃ"), "wolf": ("w", "ʊ", "l", "f"),
    "off": ("ɔ", "f"), "use": ("j", "u", "z"), "used": ("j", "u", "z", "d"),
    "house": ("h", "aʊ", "s"), "read": ("ɹ", "i", "d"), "head": ("h", "ɛ", "d"),
    "dead": ("d", "ɛ", "d"), "bread": ("b", "ɹ", "ɛ", "d"),
    "heavy": ("h", "ɛ", "v", "i"), "weather": ("w", "ɛ", "ð", "ɚ"),
    "ready": ("ɹ", "ɛ", "d", "i"), "already": ("ɔ", "l", "ɹ", "ɛ", "d", "i"),
    "instead": ("ɪ", "n", "s", "t", "ɛ", "d"), "breath": ("b", "ɹ", "ɛ", "θ"),
    "heard": ("h", "ɝ", "d"), "year": ("j", "ɪ", "ɹ"),
    "years": ("j", "ɪ", "ɹ", "z"), "new": ("n", "u"), "knew": ("n", "u"),
    "how": ("h", "aʊ"), "now": ("n", "aʊ"), "down": ("d", "aʊ", "n"),
    "good": ("ɡ", "ʊ", "d"), "book": ("b", "ʊ", "k"), "took": ("t", "ʊ", "k"),
    "foot": ("f", "ʊ", "t"), "stood": ("s", "t", "ʊ", "d"),
    "something": ("s", "ʌ", "m", "θ", "ɪ", "ŋ"),
    "nothing": ("n", "ʌ", "θ", "ɪ", "ŋ"), "always": ("ɔ", "l", "w", "eɪ", "z"),
    "almost": ("ɔ", "l", "m", "oʊ", "s", "t"), "night": ("n", "aɪ", "t"),
    "light": ("l", "aɪ", "t"), "right": ("ɹ", "aɪ", "t"),
    "might": ("m", "aɪ", "t"), "high": ("h", "aɪ"),
    "the": ("ð", "ə"), "a": ("ə",), "an": ("æ", "n"), "and": ("æ", "n", "d"),
    "of": ("ʌ", "v"), "to": ("t", "u"), "in": ("ɪ", "n"), "is": ("ɪ", "z"),
    "you": ("j", "u"), "that": ("ð", "æ", "t"), "it": ("ɪ", "t"),
    "he": ("h", "i"), "she": ("ʃ", "i"), "was": ("w", "ʌ", "z"),
    "for": ("f", "ɔ", "ɹ"), "are": ("ɑ", "ɹ"), "with": ("w", "ɪ", "θ"),
    "his": ("h", "ɪ", "z"), "they": ("ð", "eɪ"), "this": ("ð", "ɪ", "s"),
    "have": ("h", "æ", "v"), "from": ("f", "ɹ", "ʌ", "m"),
    "one": ("w", "ʌ", "n"), "had": ("h", "æ", "d"), "not": ("n", "ɑ", "t"),
    "but": ("b", "ʌ", "t"), "what": ("w", "ʌ", "t"), "all": ("ɔ", "l"),
    "were": ("w", "ɝ"), "we": ("w", "i"), "when": ("w", "ɛ", "n"),
    "your": ("j", "ɔ", "ɹ"), "can": ("k", "æ", "n"), "said": ("s", "ɛ", "d"),
    "there": ("ð", "ɛ", "ɹ"), "each": ("i", "tʃ"), "which": ("w", "ɪ", "tʃ"),
    "do": ("d", "u"), "how": ("h", "aʊ"), "their": ("ð", "ɛ", "ɹ"),
    "if": ("ɪ", "f"), "will": ("w", "ɪ", "l"), "up": ("ʌ", "p"),
    "other": ("ʌ", "ð", "ɚ"), "about": ("ə", "b", "aʊ", "t"),
    "out": ("aʊ", "t"), "many": ("m", "ɛ", "n", "i"), "then": ("ð", "ɛ", "n"),
    "them": ("ð", "ɛ", "m"), "these": ("ð", "i", "z"), "so": ("s", "oʊ"),
    "some": ("s", "ʌ", "m"), "her": ("h", "ɝ"), "would": ("w", "ʊ", "d"),
    "him": ("h", "ɪ", "m"),
    "into": ("ɪ", "n", "t", "u"), "has": ("h", "æ", "z"), "look": ("l", "ʊ", "k"), "two": ("t", "u"),
    "more": ("m", "ɔ", "ɹ"), "go": ("ɡ", "oʊ"), "see": ("s", "i"),
    "no": ("n", "oʊ"), "way": ("w", "eɪ"), "could": ("k", "ʊ", "d"),
    "my": ("m", "aɪ"), "than": ("ð", "æ", "n"), "been": ("b", "ɪ", "n"),
    "who": ("h", "u"), "its": ("ɪ", "t", "s"), "now": ("n", "aʊ"),
    "did": ("d", "ɪ", "d"), "get": ("ɡ", "ɛ", "t"), "come": ("k", "ʌ", "m"),
    "may": ("m", "eɪ"), "part": ("p", "ɑ", "ɹ", "t"),
}

# English letter-to-sound rules. Entries are (pattern, phones) where
# pattern is a plain string (longest-match prefix) or a compiled regex
# matched at the current position (lookahead/lookbehind give context
# sensitivity: magic-e, soft c/g, suffixes, r-colored vowels). First
# match wins — order is most-specific-first.
_C = "bcdfghjklmnpqrstvwxz"  # consonant letters
_rx = re.compile


def _magic_e(vowel: str, phones) -> tuple:
    # V + single consonant + e(-s/-d) at word end → long vowel ("make",
    # "time", "hopes", "cared"); the trailing e is silenced by the e$ rule
    return (_rx(f"{vowel}(?=[{_C.replace('x', '')}]e(s|d)?$)"), phones)


_EN_RULES = [
    # ---- suffixes -------------------------------------------------------
    (_rx(r"tion"), ("ʃ", "ə", "n")),
    (_rx(r"ssion"), ("ʃ", "ə", "n")),
    (_rx(r"sion"), ("ʒ", "ə", "n")),
    (_rx(r"ture"), ("tʃ", "ɚ")),
    (_rx(r"cious|tious"), ("ʃ", "ə", "s")),
    (_rx(r"ous$"), ("ə", "s")),
    # -ed / -es / -ing / -le fire only when the stem already has a vowel
    # (word_to_ipa's "vowel_before" guard): "red"/"bed"/"yes" keep their
    # vowel instead of being parsed as consonant + suffix
    (_rx(r"(?<=[td])ed$"), ("ɪ", "d"), "vowel_before"),
    (_rx(r"(?<=[kpfsx])ed$"), ("t",), "vowel_before"),
    (_rx(r"(?<=[cs]h)ed$"), ("t",), "vowel_before"),
    (_rx(r"ed$"), ("d",), "vowel_before"),
    (_rx(r"(?<=[sxz])es$"), ("ɪ", "z"), "vowel_before"),
    (_rx(r"(?<=[cs]h)es$"), ("ɪ", "z"), "vowel_before"),
    (_rx(rf"(?<=[{_C}])le$"), ("ə", "l"), "vowel_before"),
    (_rx(rf"(?<=[{_C}])les$"), ("ə", "l", "z"), "vowel_before"),
    (_rx(r"(?<=[bdgmnlrvw])es$"), ("z",), "vowel_before"),  # silent e + voiced plural
    (_rx(r"(?<=[pktf])es$"), ("s",), "vowel_before"),
    (_rx(r"ing$"), ("ɪ", "ŋ"), "vowel_before"),
    (_rx(r"y$"), ("i",)),
    (_rx(r"ys$"), ("i", "z")),
    # ---- silent clusters ------------------------------------------------
    (_rx(r"^kn"), ("n",)),
    (_rx(r"^wr"), ("ɹ",)),
    (_rx(r"^ps"), ("s",)),
    (_rx(r"mb$"), ("m",)),
    (_rx(r"(?<=[aeiou])gh(?=t)"), ()),  # light/eight via vowel rules
    # ---- vowel digraphs / trigraphs -------------------------------------
    ("eigh", ("eɪ",)), ("aigh", ("eɪ",)), ("igh", ("aɪ",)),
    ("augh", ("ɔ",)), ("ough", ("ɔ",)),  # irregular oughs live in the lexicon
    ("eau", ("oʊ",)),
    # r-colored combos take precedence over the plain digraphs
    (_rx(r"ar(?=e$)"), ("ɛ", "ɹ")), ("air", ("ɛ", "ɹ")),
    ("ear", ("ɪ", "ɹ")), ("eer", ("ɪ", "ɹ")),
    (_rx(r"or(?=e$)"), ("ɔ", "ɹ")),
    ("oa", ("oʊ",)), (_rx(r"oe$"), ("oʊ",)), ("ew", ("u",)),
    (_rx(r"ue$"), ("u",)), ("ui", ("u",)),
    (_rx(r"oo(?=k)"), ("ʊ",)), ("oo", ("u",)),
    ("ou", ("aʊ",)), (_rx(r"ow$"), ("oʊ",)), ("ow", ("aʊ",)),
    ("ee", ("i",)), (_rx(r"ey$"), ("i",)), ("ea", ("i",)), ("ei", ("i",)),
    ("ai", ("eɪ",)), ("ay", ("eɪ",)),
    ("oi", ("ɔɪ",)), ("oy", ("ɔɪ",)),
    ("aw", ("ɔ",)), ("au", ("ɔ",)),
    # ---- remaining r-colored vowels --------------------------------------
    ("alk", ("ɔ", "k")), ("alm", ("ɑ", "m")),
    ("ar", ("ɑ", "ɹ")), ("or", ("ɔ", "ɹ")),
    (_rx(r"er$"), ("ɚ",)), (_rx(r"ers$"), ("ɚ", "z")),
    ("er", ("ɝ",)), ("ir", ("ɝ",)), ("ur", ("ɝ",)),
    # ---- magic-e / open-syllable long vowels -----------------------------
    _magic_e("a", ("eɪ",)),
    _magic_e("e", ("i",)),
    _magic_e("i", ("aɪ",)),
    _magic_e("o", ("oʊ",)),
    (_rx(rf"(?<=[lrj])u(?=[{_C}]e(s|d)?$)"), ("u",)),  # rule, June
    _magic_e("u", ("j", "u")),
    (_rx(rf"a(?=[{_C}]ing$)"), ("eɪ",)),  # making (dropped-e forms)
    (_rx(rf"i(?=[{_C}]ing$)"), ("aɪ",)),  # riding
    (_rx(rf"o(?=[{_C}]ing$)"), ("oʊ",)),  # hoping
    (_rx(rf"u(?=[{_C}]ing$)"), ("u",)),  # using
    (_rx(rf"a(?=[{_C}]le$)"), ("eɪ",)),  # table, able
    (_rx(r"a(?=tion|ture)"), ("eɪ",)),  # nation, nature
    (_rx(rf"a(?=[{_C}]ous$)"), ("eɪ",)),  # famous
    (_rx(r"o(?=tion)"), ("oʊ",)),  # motion
    (_rx(r"i(?=nd$)"), ("aɪ",)),  # find, kind
    (_rx(r"o(?=ld$)"), ("oʊ",)),  # old, cold
    (_rx(r"e$"), ()),  # silent final e
    # ---- consonants ------------------------------------------------------
    ("tch", ("tʃ",)), ("dge", ("dʒ",)), ("ch", ("tʃ",)), ("sh", ("ʃ",)),
    ("th", ("θ",)), ("ph", ("f",)), ("wh", ("w",)), ("ck", ("k",)),
    (_rx(r"ng$"), ("ŋ",)), ("nk", ("ŋ", "k")), ("ng", ("ŋ", "ɡ")),
    ("qu", ("k", "w")),
    (_rx(r"c(?=[eiy])"), ("s",)), (_rx(r"g(?=[eiy])"), ("dʒ",)),
    ("cc", ("k",)), ("ll", ("l",)), ("ss", ("s",)), ("tt", ("t",)),
    ("pp", ("p",)), ("mm", ("m",)), ("nn", ("n",)), ("dd", ("d",)),
    ("rr", ("ɹ",)), ("ff", ("f",)), ("gg", ("ɡ",)), ("bb", ("b",)),
    ("zz", ("z",)),
    # ---- single letters ---------------------------------------------------
    ("a", ("æ",)), ("e", ("ɛ",)), ("i", ("ɪ",)), ("o", ("ɑ",)), ("u", ("ʌ",)),
    ("b", ("b",)), ("c", ("k",)), ("d", ("d",)), ("f", ("f",)), ("g", ("ɡ",)),
    ("h", ("h",)), ("j", ("dʒ",)), ("k", ("k",)), ("l", ("l",)), ("m", ("m",)),
    ("n", ("n",)), ("p", ("p",)), ("r", ("ɹ",)), ("s", ("s",)), ("t", ("t",)),
    ("v", ("v",)), ("w", ("w",)), ("x", ("k", "s")), ("y", ("j",)), ("z", ("z",)),
]

_FR_RULES = [
    ("eau", ("o",)), ("eaux", ("o",)), ("au", ("o",)), ("aux", ("o",)),
    ("oi", ("w", "a")), ("ou", ("u",)), ("eu", ("ø",)), ("œu", ("œ",)),
    ("ai", ("ɛ",)), ("ei", ("ɛ",)), ("é", ("e",)), ("è", ("ɛ",)),
    ("ê", ("ɛ",)), ("ë", ("ɛ",)), ("à", ("a",)), ("â", ("a",)),
    ("î", ("i",)), ("ï", ("i",)), ("ô", ("o",)), ("û", ("y",)),
    ("ù", ("y",)), ("ü", ("y",)), ("ç", ("s",)),
    ("ch", ("ʃ",)), ("gn", ("ɲ",)), ("qu", ("k",)), ("ph", ("f",)),
    ("on", ("ɔ̃",)), ("an", ("ɑ̃",)), ("en", ("ɑ̃",)), ("in", ("ɛ̃",)),
    ("un", ("œ̃",)), ("ille", ("i", "j")),
    ("j", ("ʒ",)), ("ge", ("ʒ", "ə")), ("gi", ("ʒ", "i")),
    ("ce", ("s", "ə")), ("ci", ("s", "i")), ("h", ()),
    ("a", ("a",)), ("e", ("ə",)), ("i", ("i",)), ("o", ("ɔ",)), ("u", ("y",)),
    ("y", ("i",)), ("b", ("b",)), ("c", ("k",)), ("d", ("d",)), ("f", ("f",)),
    ("g", ("ɡ",)), ("k", ("k",)), ("l", ("l",)), ("m", ("m",)), ("n", ("n",)),
    ("p", ("p",)), ("q", ("k",)), ("r", ("ʁ",)), ("s", ("s",)), ("t", ("t",)),
    ("v", ("v",)), ("w", ("w",)), ("x", ("k", "s")), ("z", ("z",)),
]

_PT_RULES = [
    ("lh", ("ʎ",)), ("nh", ("ɲ",)), ("ch", ("ʃ",)), ("ss", ("s",)),
    ("rr", ("ʁ",)), ("qu", ("k",)), ("gu", ("ɡ",)),
    ("ão", ("ɐ̃", "w̃")), ("õe", ("õ", "j")), ("ã", ("ɐ̃",)), ("õ", ("õ",)),
    ("á", ("a",)), ("à", ("a",)), ("â", ("ɐ",)), ("é", ("ɛ",)), ("ê", ("e",)),
    ("í", ("i",)), ("ó", ("ɔ",)), ("ô", ("o",)), ("ú", ("u",)), ("ç", ("s",)),
    ("ge", ("ʒ", "e")), ("gi", ("ʒ", "i")), ("ce", ("s", "e")), ("ci", ("s", "i")),
    ("h", ()), ("j", ("ʒ",)), ("x", ("ʃ",)),
    ("a", ("a",)), ("e", ("e",)), ("i", ("i",)), ("o", ("o",)), ("u", ("u",)),
    ("b", ("b",)), ("c", ("k",)), ("d", ("d",)), ("f", ("f",)), ("g", ("ɡ",)),
    ("k", ("k",)), ("l", ("l",)), ("m", ("m",)), ("n", ("n",)), ("p", ("p",)),
    ("q", ("k",)), ("r", ("ɾ",)), ("s", ("s",)), ("t", ("t",)), ("v", ("v",)),
    ("w", ("w",)), ("y", ("j",)), ("z", ("z",)),
]

_NL_RULES = [
    ("sch", ("s", "x")), ("ch", ("x",)), ("ng", ("ŋ",)), ("nk", ("ŋ", "k")),
    ("ij", ("ɛi",)), ("ei", ("ɛi",)), ("ui", ("œy",)), ("ou", ("ɑu",)),
    ("au", ("ɑu",)), ("oe", ("u",)), ("eu", ("ø",)), ("ie", ("i",)),
    ("aa", ("aː",)), ("ee", ("eː",)), ("oo", ("oː",)), ("uu", ("y",)),
    ("a", ("ɑ",)), ("e", ("ɛ",)), ("i", ("ɪ",)), ("o", ("ɔ",)), ("u", ("ʏ",)),
    ("b", ("b",)), ("c", ("k",)), ("d", ("d",)), ("f", ("f",)), ("g", ("ɣ",)),
    ("h", ("h",)), ("j", ("j",)), ("k", ("k",)), ("l", ("l",)), ("m", ("m",)),
    ("n", ("n",)), ("p", ("p",)), ("q", ("k",)), ("r", ("r",)), ("s", ("s",)),
    ("t", ("t",)), ("v", ("v",)), ("w", ("ʋ",)), ("x", ("k", "s")),
    ("y", ("j",)), ("z", ("z",)),
]

_PL_RULES = [
    ("szcz", ("ʃ", "tʃ")), ("sz", ("ʃ",)), ("cz", ("tʃ",)), ("rz", ("ʒ",)),
    ("dz", ("dz",)), ("dź", ("dʑ",)), ("dż", ("dʒ",)), ("ch", ("x",)),
    ("ci", ("tɕ", "i")), ("si", ("ɕ", "i")), ("zi", ("ʑ", "i")),
    ("ni", ("ɲ", "i")),
    ("ą", ("ɔ̃",)), ("ę", ("ɛ̃",)), ("ó", ("u",)), ("ł", ("w",)),
    ("ż", ("ʒ",)), ("ź", ("ʑ",)), ("ś", ("ɕ",)), ("ć", ("tɕ",)), ("ń", ("ɲ",)),
    ("w", ("v",)), ("y", ("ɨ",)), ("j", ("j",)), ("h", ("x",)),
    ("a", ("a",)), ("e", ("ɛ",)), ("i", ("i",)), ("o", ("ɔ",)), ("u", ("u",)),
    ("b", ("b",)), ("c", ("ts",)), ("d", ("d",)), ("f", ("f",)), ("g", ("ɡ",)),
    ("k", ("k",)), ("l", ("l",)), ("m", ("m",)), ("n", ("n",)), ("p", ("p",)),
    ("r", ("r",)), ("s", ("s",)), ("t", ("t",)), ("z", ("z",)),
]

_TR_RULES = [
    ("ç", ("tʃ",)), ("ş", ("ʃ",)), ("ğ", ()), ("ı", ("ɯ",)), ("ö", ("ø",)),
    ("ü", ("y",)), ("c", ("dʒ",)), ("j", ("ʒ",)), ("y", ("j",)),
    ("a", ("a",)), ("e", ("e",)), ("i", ("i",)), ("o", ("o",)), ("u", ("u",)),
    ("b", ("b",)), ("d", ("d",)), ("f", ("f",)), ("g", ("ɡ",)), ("h", ("h",)),
    ("k", ("k",)), ("l", ("l",)), ("m", ("m",)), ("n", ("n",)), ("p", ("p",)),
    ("r", ("ɾ",)), ("s", ("s",)), ("t", ("t",)), ("v", ("v",)), ("z", ("z",)),
]

_RU_RULES = [
    ("щ", ("ɕ",)), ("ш", ("ʂ",)), ("ж", ("ʐ",)), ("ч", ("tɕ",)),
    ("ц", ("ts",)), ("х", ("x",)),
    ("а", ("a",)), ("б", ("b",)), ("в", ("v",)), ("г", ("ɡ",)), ("д", ("d",)),
    ("е", ("j", "e")), ("ё", ("j", "o")), ("з", ("z",)), ("и", ("i",)),
    ("й", ("j",)), ("к", ("k",)), ("л", ("l",)), ("м", ("m",)), ("н", ("n",)),
    ("о", ("o",)), ("п", ("p",)), ("р", ("r",)), ("с", ("s",)), ("т", ("t",)),
    ("у", ("u",)), ("ф", ("f",)), ("ы", ("ɨ",)), ("э", ("ɛ",)),
    ("ю", ("j", "u")), ("я", ("j", "a")), ("ь", ()), ("ъ", ()),
]

_LANG_RULES: Dict[str, list] = {
    "es": _ES_RULES,
    "it": _IT_RULES,
    "de": _DE_RULES,
    "en": _EN_RULES,
    "fr": _FR_RULES,
    "pt": _PT_RULES,
    "nl": _NL_RULES,
    "pl": _PL_RULES,
    "tr": _TR_RULES,
    "ru": _RU_RULES,
}

_PUNCT_RE = re.compile(r"[^\w\s']", re.UNICODE)


def normalize_text(text: str) -> List[str]:
    """Lowercase, strip punctuation, NFC-normalize → word list."""
    text = unicodedata.normalize("NFC", text.lower())
    text = _PUNCT_RE.sub(" ", text)
    return text.split()


def word_to_ipa(word: str, rules: Sequence[tuple]) -> List[str]:
    """Apply (pattern, phones) rules left-to-right; a pattern is a plain
    string (prefix match at the cursor) or a compiled regex matched at the
    cursor (lookahead/lookbehind see the whole word). First match wins."""
    out: List[str] = []
    i = 0
    n = len(word)
    while i < n:
        for rule in rules:
            g, phones = rule[0], rule[1]
            if len(rule) > 2 and rule[2] == "vowel_before" and not any(
                c in "aeiouy" for c in word[:i]
            ):
                # suffix rules must not consume a monosyllable's only
                # vowel ("red" is not "r"+"-ed")
                continue
            if isinstance(g, str):
                if word.startswith(g, i):
                    out.extend(phones)
                    i += len(g)
                    break
            else:
                m = g.match(word, i)
                if m and m.end() > i:  # must consume ≥1 char
                    out.extend(phones)
                    i = m.end()
                    break
        else:
            i += 1  # unknown character: skip
    return out


def text_to_ipa(
    text: str,
    lang: str = "en",
    *,
    lexicon: Optional[Dict[str, Tuple[str, ...]]] = None,
    rules: Optional[Sequence[tuple]] = None,
    insert_word_breaks: bool = False,
    model=None,
) -> List[str]:
    """Sentence → flat IPA phone list (optionally with 'sil' between
    words). Unknown languages fall back to English rules.

    ``model``: an optional ``models.g2p_model.NeuralG2P`` — words outside
    the lexicon that the model handles (plain alphabetic) go through the
    trained seq2seq; everything else keeps the rule tables (the OOV
    fallback)."""
    rules = rules if rules is not None else _LANG_RULES.get(lang, _EN_RULES)
    lex = dict(_EN_LEXICON) if lang == "en" else {}
    if lexicon:
        lex.update(lexicon)
    words = normalize_text(text)
    neural: Dict[str, List[str]] = {}
    if model is not None:
        neural = model.lookup([w for w in words if w not in lex])
    phones: List[str] = []
    for w, word in enumerate(words):
        if w and insert_word_breaks:
            phones.append("sil")
        if word in lex:
            phones.extend(lex[word])
        elif neural.get(word):
            # a zero-phone neural prediction (decoder emitted <eos> at
            # step 0 on a degenerate input) falls back to the rules —
            # silently deleting the word would mislabel prep transcripts
            phones.extend(neural[word])
        else:
            phones.extend(word_to_ipa(word, rules))
    return phones


def supported_languages() -> List[str]:
    return sorted(_LANG_RULES)
