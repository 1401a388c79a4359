"""Text frontend (counterpart of rwkvtts_tpu/data/text_frontend.py):
language detection, normalization and paragraph splitting, emotion tags,
phoneme (IPA) marking and the Spark instruction templates.

  * ``detect_language``: a unicode-range heuristic, zh iff CJK characters
    dominate (the reference uses langdetect, utils/tts_util.py:8-15);
  * ``basic_normalize`` / ``split_paragraph``: the reference frontend's
    normalization and token-budget split (cosyvoice cli/frontend.py:124-152);
  * ``parse_emotion_and_text`` / ``rewrite_with_emotion``: "(happy) text"
    into a natural-language emotion prefix (utils/text_processor.py);
  * ``to_ipa`` / ``mark_phonemes``: pronunciation tags for the
    pronunciation-controllable fine-tune (utils/phonem_utils.py:114-232).

Optional backends: WeTextProcessing (``tn``) normalizes when it is
installed, else the native rules of ``zh_tn``; ``eng_to_ipa`` and
``pypinyin`` give pronunciations when installed, else ``en_g2p`` and the
pinyin table of ``pinyin``. A backend is chosen by whether its package is
installed (``importlib.util.find_spec``), so an installed backend that
fails raises its error; it is never replaced by the native rules after
the fact (the JAX module catches every exception there).

Random draws come from an explicit ``random.Random``: ``mark_phonemes``
raises without one.
"""
from __future__ import annotations

import importlib.util
import re
import unicodedata
from typing import Callable, List, Optional, Sequence, Tuple

from rwkvtts_torch.data import en_g2p, pinyin, zh_tn

INSTRUCTION = (
    "User: Please generate the speech according to the following text: {text}\nAssistant:"
)
INSTRUCTION_WITH_PROPERTIES = (
    "User: Please generate the speech with the properties: {properties} "
    "according to the following text: {text}\nAssistant:"
)


def installed(name: str) -> bool:
    """Whether the top-level package `name` can be imported."""
    return importlib.util.find_spec(name) is not None


# ---------------------------------------------------------------------------
# Language detection


def detect_language(text: str) -> str:
    """'zh' iff CJK characters dominate the letters, else 'en'."""
    cjk = sum(1 for c in text if "一" <= c <= "鿿")
    latin = sum(1 for c in text if c.isascii() and c.isalpha())
    return "zh" if cjk >= max(latin / 4, 1) else "en"


def contains_chinese(text: str) -> bool:
    return any("一" <= c <= "鿿" for c in text)


# ---------------------------------------------------------------------------
# Normalization + paragraph splitting


_ZH_END = "。！？；"
_EN_END = ".!?;"


def basic_normalize(text: str, lang: Optional[str] = None) -> str:
    """Text normalization: WeTextProcessing's normalizer of the language
    when ``tn`` is installed, else the native rules (``zh_tn``); digits,
    dates and units are verbalized either way."""
    lang = lang or detect_language(text)
    text = text.strip().replace("\n", "")
    if installed("tn"):
        if lang == "zh":
            from tn.chinese.normalizer import Normalizer  # type: ignore
        else:
            from tn.english.normalizer import Normalizer  # type: ignore
        text = Normalizer().normalize(text)
    else:
        text = zh_tn.normalize_zh(text) if lang == "zh" else zh_tn.normalize_en(text)
    if lang == "zh":
        text = re.sub(r"\s+", "", text)
        text = text.replace(".", "。").replace(" - ", "，")
        text = re.sub(r"[，,、]+$", "。", text)
    else:
        text = re.sub(r"\s+", " ", text)
    return text


def split_paragraph(
    text: str,
    encode_fn: Callable[[str], Sequence[int]],
    lang: Optional[str] = None,
    token_max_n: int = 80,
    token_min_n: int = 60,
    merge_len: int = 20,
) -> List[str]:
    """Sentences joined into chunks of at most `token_max_n` tokens (a
    sentence longer than that is a chunk of its own); a tail of fewer than
    `merge_len` tokens joins the chunk before it; chunks of punctuation
    and space only are dropped. `token_min_n` is taken for the reference's
    signature and unused, as in the JAX package."""
    lang = lang or detect_language(text)
    ends = _ZH_END if lang == "zh" else _EN_END
    sents: List[str] = []
    buf = ""
    for c in text:
        buf += c
        if c in ends:
            sents.append(buf)
            buf = ""
    if buf.strip():
        sents.append(buf)

    chunks: List[str] = []
    cur = ""
    for s in sents:
        if cur and len(encode_fn(cur + s)) > token_max_n:
            chunks.append(cur)
            cur = s
        else:
            cur += s
    if cur:
        if chunks and len(encode_fn(cur)) < merge_len:
            chunks[-1] += cur
        else:
            chunks.append(cur)
    return [c for c in chunks
            if any(not unicodedata.category(ch).startswith("P") and not ch.isspace() for ch in c)]


# ---------------------------------------------------------------------------
# Emotion tags


_EMOTION_WORDS = {
    "happy", "sad", "angry", "excited", "calm", "fearful", "surprised",
    "disgusted", "neutral", "whisper", "shout",
}


def parse_emotion_and_text(text: str) -> Tuple[Optional[str], str]:
    """'(happy) hello there' -> ('happy', 'hello there'); text without a
    tag passes through."""
    m = re.match(r"^\s*[\(（]([^\)）]{1,24})[\)）]\s*(.*)$", text, re.S)
    if not m:
        return None, text
    tag = m.group(1).strip().lower()
    if tag in _EMOTION_WORDS or contains_chinese(tag):
        return tag, m.group(2)
    return None, text


def rewrite_with_emotion(text: str) -> str:
    """The natural-language emotion prefix of instruction-augmented rows."""
    emotion, content = parse_emotion_and_text(text)
    if emotion is None:
        return text
    if contains_chinese(content):
        return f"用{emotion}的情绪说：{content}"
    return f"Say it in a {emotion} voice: {content}"


# ---------------------------------------------------------------------------
# Phoneme marking


def to_ipa(word: str, lang: str = "en", strict: bool = False) -> str:
    """Word -> pronunciation. en: ``eng_to_ipa`` when installed, else
    ``en_g2p``; zh: pypinyin's TONE3 when installed, else the native
    table (~2950 chars). `strict` raises for a zh character outside the
    native table, which would otherwise pass through as itself and teach
    the fine-tune a (char, char) pair."""
    if lang == "en":
        if installed("eng_to_ipa"):
            import eng_to_ipa  # type: ignore

            return eng_to_ipa.convert(word)
        return en_g2p.convert(word)
    if installed("pypinyin"):
        from pypinyin import lazy_pinyin  # type: ignore

        return " ".join(lazy_pinyin(word, style=8))  # Style.TONE3
    readings = []
    for c in word:
        py = pinyin.char_to_tone3(c)
        if py is None:
            if strict and "一" <= c <= "鿿":
                raise RuntimeError(
                    f"zh char {c!r} is outside the native pinyin table; refusing to mark "
                    "it with a non-pronunciation (install pypinyin or extend "
                    "assets/zh_pinyin.tsv)")
            readings.append(c)
        else:
            readings.append(py)
    return " ".join(readings)


def mark_phonemes(
    text: str,
    lang: Optional[str] = None,
    max_mark: int = 1,
    rng=None,
    strict: bool = False,
) -> str:
    """Mark up to `max_mark` words (en) or characters (zh), drawn with
    `rng` (a ``random.Random``, required), with their pronunciation in the
    tagged form of the pronunciation fine-tune:
    'hello world' -> 'hello world(pronounced as /wɜrld/)',
    '你好' -> '你(读作ni3)好'."""
    if rng is None:
        raise ValueError("mark_phonemes: pass rng, a random.Random")
    lang = lang or detect_language(text)
    if lang == "en":
        words = text.split()
        if not words:
            return text
        idxs = sorted(rng.sample(range(len(words)), min(max_mark, len(words))))
        for i in idxs:
            w = re.sub(r"\W", "", words[i])
            if w:
                words[i] = f"{words[i]}(pronounced as /{to_ipa(w, 'en', strict=strict)}/)"
        return " ".join(words)
    chars = list(text)
    cands = [i for i, c in enumerate(chars) if "一" <= c <= "鿿"]
    if not cands:
        return text
    for i in sorted(rng.sample(cands, min(max_mark, len(cands)))):
        chars[i] = f"{chars[i]}(读作{to_ipa(chars[i], 'zh', strict=strict)})"
    return "".join(chars)
