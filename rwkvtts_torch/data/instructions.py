"""Instruction-augmentation generators for instruct2-style training rows
(a copy of rwkvtts_tpu/data/instructions.py).

The reference's extraction pipeline, when `is_instructed` is set
(data/utils/utilitie.py:546-547), rewrites each target text into a
natural-language style instruction (emotion, speaking rate, dialect or
accent, role play) ended by `<|endofprompt|>` (id 65531, where the Cosy LM
splits instruction from content), optionally after inserting vocal bursts
(`[laughter]` / `[breath]`) and vocal-feature span tags
(`<laughter>..</laughter>`, `<strong>..</strong>`) into the content. The
templates and style words are the reference's data contract
(utilitie.py:44-360), copied verbatim.

Every generator draws from the `random.Random` it is given and raises
without one (the JAX module falls back to an unseeded ``random.Random()``).
"""
from __future__ import annotations

import random
from typing import Callable, Optional

END_OF_PROMPT = "<|endofprompt|>"

# Style vocabularies (utilitie.py:44-52).
EMOTIONS_ZH = ["高兴", "悲伤", "惊讶", "愤怒", "恐惧", "厌恶", "冷静", "严肃"]
EMOTIONS_EN = [
    "Happy", "Sad", "Surprised", "Angry", "Fearful", "Disgusted", "Calm",
    "Serious",
]
SPEAKING_RATES_ZH = ["快速", "非常快速", "慢速", "非常慢速"]
SPEAKING_RATES_EN = ["Fast", "Very Fast", "Slow", "Very Slow"]
DIALECTS_ZH = ["普通话", "粤语", "四川话", "上海话", "郑州话", "长沙话", "天津话"]
DIALECTS_EN = [
    "Mandarin", "Cantonese", "Sichuanese", "Shanghainese",
    "Zhengzhou Dialect", "Changsha Dialect", "Tianjin Dialect",
]
ROLE_PLAYINGS_ZH = ["神秘", "凶猛", "好奇", "优雅", "孤独", "机器人", "小猪佩奇"]
ROLE_PLAYINGS_EN = [
    "Mysterious", "Fierce", "Curious", "Elegant", "Lonely", "Robot", "Peppa",
]
VOCAL_BURSTS = ["[laughter]", "[breath]"]
VOCAL_FEATURES = ["<laughter></laughter>", "<strong></strong>"]

# Template families (utilitie.py:56-250). Each template is
# "<instruction with {style} slot>" and the generated row is
# template + END_OF_PROMPT + text.
_TEMPLATES = {
    ("emotion", "zh"): [
        "你能用{}的情感说吗？", "请用{}的情感说。", "请用{}的情感表达。",
        "请用{}的情感说一下。", "请用{}的情感说一句。",
    ],
    ("emotion", "en"): [
        "Can you say it with {} emotion?", "Please say it with {} emotion.",
        "Please express it with {} emotion.",
        "Please say it with {} emotion.",
        "Please say a sentence with {} emotion.",
    ],
    ("rate", "zh"): [
        "请用{}的语速说。", "请用{}的语速说一下。", "请用{}的语速说一句。",
        "请用{}的语速表达。", "请用{}的语速说。", "请{}地说。",
        "请{}地说一下。", "请{}地说一句。", "{}的说。", "{}的说一下。",
        "{}的说一句。", "{}的表达。",
    ],
    ("rate", "en"): [
        "Please say it with {} speaking rate.", "Say it with {} speaking rate.",
        "Please say a sentence with {} speaking rate.",
        "Please express it with {} speaking rate.",
        "Please speak {}ly.", "Speak {}ly.", "Please say it {}ly.",
        "Say it {}ly.",
    ],
    ("dialect", "zh"): [
        "请问你能模仿{}的口音吗？", "请用{}的口音说一下。", "用{}的口音说一句。",
        "能用{}的口音读一下吗？", "请尝试用{}的口音说这段话。",
        "请以{}的口音表达。", "请用{}的语调说。", "试试用{}的方言说。",
        "能否用{}的语调读出来？", "请说一段{}。",
    ],
    ("dialect", "en"): [
        "Can you mimic the {} accent?", "Please speak with a {} accent.",
        "Say it with a {} accent.", "Could you read this with a {} accent?",
        "Please try to speak this with a {} accent.",
        "Please express it with a {} accent.", "Please use {} intonation.",
        "Try speaking in {}.", "Could you read this in {}?",
        "Please say a passage in {}.",
    ],
    ("role", "zh"): [
        "尝试一下以{}的角色和我交流。", "请以{}的角色说这句话。",
        "假装你是{}，说一下这句话。", "扮演{}来说这段话。", "请用{}的语气说。",
        "以{}的形象来表达。", "你能用{}的方式说吗？", "模仿{}说话。",
        "请用{}的口吻说一下。", "像{}一样说这句话。",
    ],
    ("role", "en"): [
        "Try to communicate with me as a {} character.",
        "Please say this as a {} character.",
        "Pretend you are {}, say this sentence.",
        "Act as {} to say this passage.", "Please speak with a {} tone.",
        "Express this with a {} image.", "Can you say this in a {} way?",
        "Mimic {} speaking.", "Please say this in the manner of {}.",
        "Say this like {}.",
    ],
}

_STYLES = {
    ("emotion", "zh"): EMOTIONS_ZH, ("emotion", "en"): EMOTIONS_EN,
    ("rate", "zh"): SPEAKING_RATES_ZH, ("rate", "en"): SPEAKING_RATES_EN,
    ("dialect", "zh"): DIALECTS_ZH, ("dialect", "en"): DIALECTS_EN,
    ("role", "zh"): ROLE_PLAYINGS_ZH, ("role", "en"): ROLE_PLAYINGS_EN,
}

KINDS = ("emotion", "rate", "dialect", "role")


def _rng(rng: Optional[random.Random]) -> random.Random:
    if rng is None:
        raise ValueError("instructions: pass rng, a random.Random")
    return rng


def instruction(
    text: str, kind: str, lang: str = "zh",
    rng: Optional[random.Random] = None, style: Optional[str] = None,
) -> str:
    """One augmented row: `<instruction>{END_OF_PROMPT}{text}`."""
    if kind not in KINDS:
        raise ValueError(f"kind must be one of {KINDS}, got {kind!r}")
    lang = "zh" if lang == "zh" else "en"
    r = _rng(rng)
    tpl = r.choice(_TEMPLATES[(kind, lang)])
    style = style if style is not None else r.choice(_STYLES[(kind, lang)])
    return tpl.format(style) + END_OF_PROMPT + text


def emotion_instruction(text, lang="zh", rng=None, style=None) -> str:
    return instruction(text, "emotion", lang, rng, style)


def speaking_rate_instruction(text, lang="zh", rng=None, style=None) -> str:
    return instruction(text, "rate", lang, rng, style)


def dialect_instruction(text, lang="zh", rng=None, style=None) -> str:
    return instruction(text, "dialect", lang, rng, style)


def role_play_instruction(text, lang="zh", rng=None, style=None) -> str:
    return instruction(text, "role", lang, rng, style)


def add_vocal_bursts(text: str, rng: Optional[random.Random] = None) -> str:
    """Insert a `[laughter]`/`[breath]` marker at the start, a random word
    boundary, or the end (utilitie.py:251-268)."""
    r = _rng(rng)
    burst = r.choice(VOCAL_BURSTS)
    pos = r.choice(("start", "mid", "end"))
    words = text.split()
    if pos == "mid" and len(words) > 3:
        cut = r.randint(1, len(words) - 1)
        return " ".join(words[:cut]) + f" {burst} " + " ".join(words[cut:])
    if pos == "end":
        return f"{text} {burst}"
    return burst + text


def add_vocal_features(text: str, rng: Optional[random.Random] = None) -> str:
    """Wrap a random span in a feature tag pair — char-span for zh, word-span
    for en (utilitie.py:270-315)."""
    r = _rng(rng)
    open_t, close_t = r.choice(VOCAL_FEATURES).split("><")
    open_t, close_t = open_t + ">", "<" + close_t
    if any("一" <= c <= "鿿" for c in text):
        if len(text) <= 10:
            return open_t + text + close_t
        start = r.randint(1, max(1, len(text) // 2))
        end = start + r.randint(1, min(5, len(text) - start)) - 1
        return text[:start] + open_t + text[start:end + 1] + close_t + text[end + 1:]
    words = text.split()
    if len(words) <= 3:
        return open_t + text + close_t
    start = r.randint(0, len(words) - 1)
    span = r.randint(1, min(3, len(words) - start))
    words[start] = open_t + words[start]
    words[start + span - 1] = words[start + span - 1] + close_t
    return " ".join(words)


def mixed_instruction(
    text: str,
    lang: str = "zh",
    rng: Optional[random.Random] = None,
    feature_prob: float = 0.3,
    burst_prob: float = 0.2,
) -> str:
    """The extraction pipeline's augmentation (utilitie.py:317-360): maybe
    tag a vocal-feature span (p=0.3), maybe insert a vocal burst (p=0.2),
    then wrap in one randomly chosen instruction family."""
    r = _rng(rng)
    kind = r.choice(KINDS)
    if r.random() < feature_prob:
        text = add_vocal_features(text, r)
    if r.random() < burst_prob:
        text = add_vocal_bursts(text, r)
    return instruction(text, kind, lang, r)


def make_instruction_fn(
    lang: str = "zh", seed: int = 0, **kw
) -> Callable[[str], str]:
    """A text->text augmenter, the reference's `is_instructed` path
    (utilitie.py:546-547), on one ``random.Random(seed)`` across calls."""
    r = random.Random(seed)
    return lambda text: mixed_instruction(text, lang=lang, rng=r, **kw)
