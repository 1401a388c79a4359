"""Native pinyin (a copy of rwkvtts_tpu/data/pinyin.py): char -> TONE3
readings from a static table, and a pinyin syllable -> IPA transcription.

The reference's zh pronunciations are pypinyin's ``lazy_pinyin(text,
style=Style.TONE3, neutral_tone_with_five=True)`` (its
utils/phonem_utils.py:219-225). ``assets/zh_pinyin.tsv`` holds the most
common reading of the ~2950 most frequent characters (jieba frequency
order), which is what ``lazy_pinyin`` gives for nearly all running text; a
heteronym's default reading can differ from pypinyin's. The table feeds
the phoneme-marking augmentation (``text_frontend.mark_phonemes``), whose
tag teaches a (char, pronunciation) pair.

``pinyin_to_ipa`` maps any pinyin syllable to IPA through initial / final
tables (standard Mandarin phonology).
"""
from __future__ import annotations

import os
import re
from functools import lru_cache
from typing import Dict, List, Optional

_ASSET = os.path.join(os.path.dirname(__file__), "assets", "zh_pinyin.tsv")


@lru_cache(maxsize=1)
def pinyin_table() -> Dict[str, str]:
    table: Dict[str, str] = {}
    with open(_ASSET, encoding="utf-8") as f:
        for line in f:
            line = line.rstrip("\n")
            if not line or line.startswith("#"):
                continue
            char, py = line.split("\t")
            table[char] = py
    return table


def char_to_tone3(char: str) -> Optional[str]:
    """Single char -> TONE3 pinyin, or None when not covered."""
    return pinyin_table().get(char)


def lazy_pinyin_tone3(text: str, errors: str = "keep") -> List[str]:
    """Text -> per-char TONE3 readings (pypinyin lazy_pinyin TONE3 with
    neutral_tone_with_five=True semantics). Non-CJK chars and uncovered
    chars pass through (errors='keep') or drop (errors='ignore')."""
    table = pinyin_table()
    out: List[str] = []
    for c in text:
        py = table.get(c)
        if py is not None:
            out.append(py)
        elif errors == "keep":
            out.append(c)
    return out


def coverage(text: str) -> float:
    """Fraction of CJK chars in `text` the table covers (1.0 when no CJK)."""
    cjk = [c for c in text if "一" <= c <= "鿿"]
    if not cjk:
        return 1.0
    table = pinyin_table()
    return sum(1 for c in cjk if c in table) / len(cjk)


# ---------------------------------------------------------------------------
# pinyin syllable -> IPA (systematic; standard Mandarin phonology)

_INITIAL_IPA = {
    "b": "p", "p": "pʰ", "m": "m", "f": "f",
    "d": "t", "t": "tʰ", "n": "n", "l": "l",
    "g": "k", "k": "kʰ", "h": "x",
    "j": "tɕ", "q": "tɕʰ", "x": "ɕ",
    "zh": "ʈʂ", "ch": "ʈʂʰ", "sh": "ʂ", "r": "ʐ",
    "z": "ts", "c": "tsʰ", "s": "s",
    "": "",
}

# finals keyed by their post-initial spelling (y/w onsets normalized first)
_FINAL_IPA = {
    "a": "a", "o": "o", "e": "ɤ", "ai": "aɪ", "ei": "eɪ", "ao": "ɑʊ",
    "ou": "oʊ", "an": "an", "en": "ən", "ang": "ɑŋ", "eng": "əŋ",
    "ong": "ʊŋ", "er": "ɚ",
    "i": "i", "ia": "ja", "ie": "jɛ", "iao": "jɑʊ", "iu": "joʊ",
    "ian": "jɛn", "in": "in", "iang": "jɑŋ", "ing": "iŋ", "iong": "jʊŋ",
    "u": "u", "ua": "wa", "uo": "wo", "uai": "waɪ", "ui": "weɪ",
    "uan": "wan", "un": "wən", "uang": "wɑŋ", "ueng": "wəŋ",
    "v": "y", "ve": "ɥɛ", "van": "ɥɛn", "vn": "yn",
}

# the "i" of zhi/chi/shi/ri (retroflex) and zi/ci/si (dental) is a syllabic
# fricative vowel, not [i]
_RETROFLEX_I = {"zh", "ch", "sh", "r"}
_DENTAL_I = {"z", "c", "s"}

_TONE_IPA = {"1": "˥", "2": "˧˥", "3": "˨˩˦", "4": "˥˩", "5": ""}


def _split_syllable(syl: str) -> Optional[tuple]:
    for ini in ("zh", "ch", "sh", "b", "p", "m", "f", "d", "t", "n", "l",
                "g", "k", "h", "j", "q", "x", "r", "z", "c", "s"):
        if syl.startswith(ini) and len(syl) > len(ini):
            return ini, syl[len(ini):]
    return "", syl


def pinyin_to_ipa(syllable: str) -> str:
    """One TONE3 pinyin syllable -> IPA with tone letters.

    'zhong1' -> 'ʈʂʊŋ˥'; 'lv4' -> 'ly˥˩'; accepts toneless syllables too."""
    m = re.fullmatch(r"([a-zü]+)([1-5]?)", syllable.lower().replace("ü", "v"))
    if not m:
        return syllable
    syl, tone = m.group(1), m.group(2) or "5"
    # y/w onset normalization (pinyin orthography -> underlying final)
    if syl.startswith("yu"):
        syl = "v" + syl[2:]
    elif syl == "yi":
        syl = "i"
    elif syl.startswith("yi"):
        syl = "i" + syl[2:]
    elif syl.startswith("y"):
        syl = "i" + syl[1:]
    elif syl == "wu":
        syl = "u"
    elif syl.startswith("w"):
        syl = "u" + syl[1:]
    split = _split_syllable(syl)
    if split is None:
        return syllable
    ini, fin = split
    # ju/qu/xu spell the v-final with a bare u
    if ini in ("j", "q", "x") and fin.startswith("u"):
        fin = "v" + fin[1:]
    # nüe/lüe typed as nue/lue (ueng must NOT take this path)
    if ini in ("n", "l") and fin.startswith("ue"):
        fin = "v" + fin[1:]
    # full-form finals produced by the y/w normalization (you -> iou,
    # wei -> uei, wen -> uen) contract to their post-initial table keys
    fin = {"iou": "iu", "uei": "ui", "uen": "un"}.get(fin, fin)
    if fin == "i" and ini in _RETROFLEX_I:
        vowel = "ʐ̩"
    elif fin == "i" and ini in _DENTAL_I:
        vowel = "z̩"
    else:
        vowel = _FINAL_IPA.get(fin)
        if vowel is None:
            return syllable
    return _INITIAL_IPA.get(ini, ini) + vowel + _TONE_IPA.get(tone, "")


def text_to_ipa_zh(text: str) -> str:
    """zh text -> space-joined IPA (through the TONE3 table)."""
    return " ".join(
        pinyin_to_ipa(p) if re.fullmatch(r"[a-z]+[1-5]", p) else p
        for p in lazy_pinyin_tone3(text)
    )
