"""The text frontend, port vs JAX package, string for string, on the CPU:
zh_tn (normalize_zh / normalize_en and the number readers), pinyin (the
table, lazy_pinyin_tone3, pinyin_to_ipa of every syllable of the table),
en_g2p (convert, convert_text), text_frontend (detect_language,
basic_normalize, split_paragraph at several budgets, the emotion tags,
to_ipa, mark_phonemes on the same random.Random) and instructions (every
generator on the same random.Random). Inputs: those of the JAX package's
own frontend tests (tests/test_text_frontend.py, tests/test_zh_tn.py,
tests/test_instructions.py) and 300 sentences drawn from a numpy seed that
mix numbers, dates, times, percentages, ranges, phone numbers, money,
temperatures, units, scores, fractions and zh / en words. Every
comparison is exact. Also: the strict refusal of a zh character outside
the pinyin table, the port's refusals without a random.Random, and the
choice of an optional backend by whether it is installed."""
import random
import re
import sys

import numpy as np
import pytest

from rwkvtts_tpu.data import en_g2p as jg2p
from rwkvtts_tpu.data import instructions as jinstr
from rwkvtts_tpu.data import pinyin as jpinyin
from rwkvtts_tpu.data import text_frontend as jtf
from rwkvtts_tpu.data import zh_tn as jtn
from rwkvtts_torch.data import en_g2p, instructions, pinyin, text_frontend, zh_tn

# the JAX package's own test inputs
ZH_FIXTURES = [
    "今天是2024年1月5日。", "气温-5°C。", "我有123个苹果和10005元。", "比例是3/4，涨了50%。",
    "现在是10:30。", "会议10:05:09结束。", "请拨打13812345678。", "座机010-12345678。",
    "价格¥9.9。", "重2kg，距离3.5km。", "3~5天到货。", "比分2:1获胜。", "增长1,234,567人。",
    "圆周率约3.14。", "编号123456789。", "这句话没有数字，不应该被改动。",
    "会议定于2024-01-05举行", "电话400-123-4567", "10~20%的增长", "10~20%", "5G网络和3M胶带",
    "买了5g糖", "跑了10km", "你好.  世界 - 再见，，", "一二三。四五六。七八九。十十一。",
]
EN_FIXTURES = ["I have 123 apples and 50% off.", "aaaa. bb.", "hello world", "the cat sat",
               "(happy) nice to meet you", "no tag here", "hello 世界你好啊朋友"]
NUMBERS = [0, 10, 15, 105, 110, 123, 1005, 10203, 100000001, -42, 1234, 1000000]
G2P_WORDS = ["the", "one", "through", "knows", "make", "time", "station", "quick", "phone",
             "judge", "speech", "yes", "ages", "boxes", "dogs", "hello", "world"]
SYLLABLES = ["you3", "wei4", "wen2", "weng1", "jue2", "nve4", "zhong1", "lv4", "xue2",
             "shi4", "si1", "yu2", "wo3", "le5"]

_ZH_WORDS = list(jpinyin.pinyin_table())[:600]
_EN_WORDS = sorted(jg2p.EXCEPTIONS)[:200] + ["station", "quick", "phone", "judge", "speech",
                                             "market", "running", "planted", "boxes", "light"]


def _sentences(seed=0, n=300):
    """n sentences, half zh and half en, each a few words around two to
    four number-bearing tokens of the TN categories."""
    rng = np.random.default_rng(seed)
    r = lambda a, b: int(rng.integers(a, b))
    cats = [
        lambda: f"{r(1990, 2030)}年{r(1, 13)}月{r(1, 29)}日",
        lambda: f"{r(1990, 2030)}-{r(1, 13):02d}-{r(1, 29):02d}",
        lambda: f"{r(0, 24)}:{r(0, 60):02d}",
        lambda: f"{r(0, 24)}:{r(0, 60):02d}:{r(0, 60):02d}",
        lambda: f"{r(0, 100)}%", lambda: f"{r(0, 50)}.{r(0, 10)}%",
        lambda: f"{r(1, 20)}~{r(20, 90)}%", lambda: f"{r(1, 10)}~{r(10, 30)}",
        lambda: f"{r(1, 10)}-{r(10, 30)}", lambda: f"1{r(3, 10)}{r(0, 10**9):09d}",
        lambda: f"0{r(10, 99)}-{r(10**7, 10**8)}", lambda: f"400-{r(100, 999)}-{r(1000, 9999)}",
        lambda: f"¥{r(1, 999)}.{r(0, 99)}", lambda: f"{r(1, 999)}元",
        lambda: f"-{r(1, 30)}°C", lambda: f"{r(0, 40)}℃", lambda: f"{r(1, 99)}kg",
        lambda: f"{r(1, 99)}.{r(1, 9)}km", lambda: f"{r(1, 9)}G", lambda: f"{r(1, 500)}ml",
        lambda: f"{r(1, 9)}/{r(2, 10)}", lambda: f"比分{r(0, 9)}:{r(0, 9)}",
        lambda: f"{r(0, 10**7):,}", lambda: str(r(0, 10**10)), lambda: f"{r(0, 999)}.{r(0, 999)}",
        lambda: str(-r(1, 1000)),
    ]
    out = []
    for i in range(n):
        zh = i % 2 == 0
        words = _ZH_WORDS if zh else _EN_WORDS
        parts = []
        for _ in range(r(3, 7)):
            if rng.random() < 0.4:
                parts.append(cats[r(0, len(cats))]())
            else:
                parts.append("".join(words[r(0, len(words))] for _ in range(r(1, 4)))
                             if zh else words[r(0, len(words))])
        sep, end = ("", "。！？；，"[r(0, 5)]) if zh else (" ", ".!?;,"[r(0, 5)])
        out.append(sep.join(parts) + end)
    return out


SENTENCES = _sentences()
PARAGRAPHS = ["".join(SENTENCES[i:i + 8:2]) for i in range(0, 80, 8)] + [
    " ".join(SENTENCES[i + 1:i + 9:2]) for i in range(0, 80, 8)]


def _jax_or_none(fn, *a):
    """fn(*a), or None where the JAX number readers run out of scale words
    (IndexError: num_to_en from 10^15, num_to_zh from 10^16)."""
    try:
        return fn(*a)
    except IndexError:
        return None


def test_number_readers_match_jax():
    """Equal readings up to the JAX readers' last scale word; past it,
    where JAX raises IndexError, the port reads digit by digit."""
    for n in NUMBERS + [int(x) for x in np.random.default_rng(1).integers(-10**9, 10**12, 200)]:
        assert zh_tn.num_to_zh(n) == jtn.num_to_zh(n), n
        assert zh_tn.num_to_en(n) == jtn.num_to_en(n), n
    assert zh_tn.num_to_en(10**15 - 1) == jtn.num_to_en(10**15 - 1)
    assert zh_tn.num_to_zh(10**16 - 1) == jtn.num_to_zh(10**16 - 1)
    assert _jax_or_none(jtn.num_to_en, 10**15) is None
    assert zh_tn.num_to_en(10**15) == "one" + " zero" * 15
    assert _jax_or_none(jtn.num_to_zh, 10**16) is None
    assert zh_tn.num_to_zh(-2 * 10**16) == "负二" + "零" * 16
    for s in ["2024", "110", "13812345678", "0"]:
        for phone in (False, True):
            assert zh_tn.digits_to_zh(s, phone) == jtn.digits_to_zh(s, phone)


@pytest.mark.parametrize("part", range(3))
def test_normalizers_match_jax(part):
    """normalize_zh, normalize_en and basic_normalize (its own language
    guess, then zh and en forced) on a third of the inputs each."""
    texts = (ZH_FIXTURES + EN_FIXTURES + SENTENCES)[part::3]
    past_scale = 0
    for t in texts:
        assert zh_tn.normalize_zh(t) == jtn.normalize_zh(t), t
        pairs = [(zh_tn.normalize_en(t), _jax_or_none(jtn.normalize_en, t))]
        pairs += [(text_frontend.basic_normalize(t, lang),
                   _jax_or_none(jtf.basic_normalize, t, lang)) for lang in (None, "zh", "en")]
        for got, want in pairs:
            if want is None:  # a digit run of 16 or more in en: read digit by digit
                past_scale += 1
                assert re.search(r"\d{16}", t.replace(",", "")) and not re.search(r"\d", got), t
            else:
                assert got == want, t
    assert past_scale <= 4


@pytest.mark.parametrize("budget", [(8, 2), (20, 5), (40, 10), (80, 20)])
def test_split_paragraph_matches_jax(budget):
    """split_paragraph of the normalized paragraphs (zh and en, and the JAX
    tests' two texts) at token_max_n / merge_len `budget`, tokens counted
    as characters and as UTF-8 bytes."""
    max_n, merge = budget
    texts = [jtf.basic_normalize(p) for p in PARAGRAPHS] + ["一二三。四五六。七八九。十十一。",
                                                           "aaaa. bb."]
    for enc in (list, lambda s: s.encode("utf-8")):
        for t in texts:
            for lang in (None, "zh", "en"):
                got = text_frontend.split_paragraph(t, enc, lang, token_max_n=max_n,
                                                    merge_len=merge)
                assert got == jtf.split_paragraph(t, enc, lang, token_max_n=max_n,
                                                  merge_len=merge), (t, lang)


def test_language_and_emotion_tags_match_jax():
    for t in ZH_FIXTURES + EN_FIXTURES + SENTENCES + ["(开心) 你好", "plain", "（悲伤）走吧"]:
        assert text_frontend.detect_language(t) == jtf.detect_language(t)
        assert text_frontend.contains_chinese(t) == jtf.contains_chinese(t)
        assert text_frontend.parse_emotion_and_text(t) == jtf.parse_emotion_and_text(t)
        assert text_frontend.rewrite_with_emotion(t) == jtf.rewrite_with_emotion(t)
    assert text_frontend.INSTRUCTION == jtf.INSTRUCTION
    assert text_frontend.INSTRUCTION_WITH_PROPERTIES == jtf.INSTRUCTION_WITH_PROPERTIES


def test_pinyin_matches_jax():
    """The table itself, lazy_pinyin_tone3 (both error modes) and coverage
    of every sentence, and pinyin_to_ipa of every syllable the table holds
    (each toneless too) and the JAX tests' syllables."""
    assert pinyin.pinyin_table() == jpinyin.pinyin_table()
    for t in ZH_FIXTURES + SENTENCES + ["中国人", "中A"]:
        for errors in ("keep", "ignore"):
            assert pinyin.lazy_pinyin_tone3(t, errors) == jpinyin.lazy_pinyin_tone3(t, errors)
        assert pinyin.coverage(t) == jpinyin.coverage(t)
        assert pinyin.text_to_ipa_zh(t) == jpinyin.text_to_ipa_zh(t)
    syllables = set(pinyin.pinyin_table().values()) | set(SYLLABLES)
    for s in sorted(syllables | {s.rstrip("12345") for s in syllables}):
        assert pinyin.pinyin_to_ipa(s) == jpinyin.pinyin_to_ipa(s), s
        for c in s:
            assert pinyin.char_to_tone3(c) == jpinyin.char_to_tone3(c)


def test_en_g2p_matches_jax():
    """convert of every exception word, its inflections and the rule words
    (the unsure '*' included), and convert_text of the en sentences."""
    words = set(G2P_WORDS) | set(_EN_WORDS)
    for w in sorted(jg2p.EXCEPTIONS):
        words |= {w, w + "s", w + "es", w + "ed", w + "ing", w.capitalize() + "'s"}
    for w in sorted(words):
        assert en_g2p.convert(w) == jg2p.convert(w), w
    for t in EN_FIXTURES + SENTENCES[1::2]:
        assert en_g2p.convert_text(t) == jg2p.convert_text(t), t


def test_to_ipa_and_mark_phonemes_match_jax():
    """to_ipa of words in both languages (strict and not); mark_phonemes of
    every input with one, two and three marks, its own language guess and
    each language forced, both sides on random.Random(s)."""
    for w in G2P_WORDS + _ZH_WORDS[:200] + ["中国人", "A中"]:
        for lang in ("en", "zh"):
            assert text_frontend.to_ipa(w, lang) == jtf.to_ipa(w, lang), (w, lang)
    for w in _ZH_WORDS[:200]:
        assert text_frontend.to_ipa(w, "zh", strict=True) == jtf.to_ipa(w, "zh", strict=True)
    for s, t in enumerate(ZH_FIXTURES + EN_FIXTURES + SENTENCES):
        for max_mark in (1, 2, 3):
            for lang in (None, "zh", "en"):
                kw = dict(lang=lang, max_mark=max_mark, strict=False)
                got = text_frontend.mark_phonemes(t, rng=random.Random(s), **kw)
                assert got == jtf.mark_phonemes(t, rng=random.Random(s), **kw), (t, kw)


def test_strict_refusal_and_rng_refusal():
    """A zh character outside the pinyin table raises under strict, as in
    JAX, and passes through without it; mark_phonemes and the instruction
    generators need a random.Random."""
    assert "齉" not in pinyin.pinyin_table()
    for mod in (text_frontend, jtf):
        with pytest.raises(RuntimeError, match="outside the native pinyin"):
            mod.to_ipa("齉", "zh", strict=True)
        assert mod.to_ipa("齉中", "zh") == "齉 zhong1"
    with pytest.raises(RuntimeError, match="outside the native pinyin"):
        text_frontend.mark_phonemes("齉", "zh", rng=random.Random(0), strict=True)
    with pytest.raises(ValueError, match="random.Random"):
        text_frontend.mark_phonemes("hello world")
    for fn in (lambda: instructions.instruction("x", "emotion"),
               lambda: instructions.add_vocal_bursts("a b c d e"),
               lambda: instructions.add_vocal_features("a b c d e"),
               lambda: instructions.mixed_instruction("x")):
        with pytest.raises(ValueError, match="random.Random"):
            fn()


_INSTR_TEXTS = ["hello world", "x", "text", "some words here now", "one two three four five",
                "short", "a few english words in this sentence", "你好吗朋友",
                "这是一个比较长的中文句子用于测试跨度", "content words go here"]


@pytest.mark.parametrize("lang", ["zh", "en"])
def test_instructions_match_jax(lang):
    """Every generator, both sides on random.Random(s): instruction of each
    kind with and without a given style, the four named families,
    vocal bursts and features, mixed_instruction (also with the feature
    and burst probabilities at 1) and make_instruction_fn over a sequence
    of calls; the constants."""
    for name in ("END_OF_PROMPT", "KINDS", "VOCAL_BURSTS", "VOCAL_FEATURES", "_TEMPLATES",
                 "_STYLES"):
        assert getattr(instructions, name) == getattr(jinstr, name)
    for s, t in enumerate(_INSTR_TEXTS * 5):
        for kind in instructions.KINDS:
            for style in (None, "Cantonese"):
                assert (instructions.instruction(t, kind, lang, random.Random(s), style)
                        == jinstr.instruction(t, kind, lang, random.Random(s), style))
        for fam in ("emotion_instruction", "speaking_rate_instruction", "dialect_instruction",
                    "role_play_instruction"):
            assert (getattr(instructions, fam)(t, lang, random.Random(s))
                    == getattr(jinstr, fam)(t, lang, random.Random(s)))
        for fn in ("add_vocal_bursts", "add_vocal_features"):
            assert getattr(instructions, fn)(t, random.Random(s)) == \
                getattr(jinstr, fn)(t, random.Random(s))
        for kw in ({}, dict(feature_prob=1.0, burst_prob=1.0)):
            assert (instructions.mixed_instruction(t, lang, random.Random(s), **kw)
                    == jinstr.mixed_instruction(t, lang, random.Random(s), **kw))
    a, b = instructions.make_instruction_fn(lang, seed=3), jinstr.make_instruction_fn(lang, seed=3)
    assert [a(t) for t in _INSTR_TEXTS * 3] == [b(t) for t in _INSTR_TEXTS * 3]


def _fake_package(root, name, files):
    for rel, src in files.items():
        path = root / name / rel
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(src)


@pytest.mark.parametrize("broken", [False, True])
def test_an_installed_backend_is_used_and_its_errors_raise(tmp_path, monkeypatch, broken):
    """A fake WeTextProcessing (``tn``) and a fake ``eng_to_ipa`` on the
    path: basic_normalize and to_ipa take them (not the native rules); when
    they raise, the error reaches the caller."""
    body = ("        raise ValueError('broken backend')\n" if broken
            else "        return 'TN:' + text\n")
    norm = "class Normalizer:\n    def normalize(self, text):\n" + body
    _fake_package(tmp_path, "tn", {"__init__.py": "", "chinese/__init__.py": "",
                                   "english/__init__.py": "", "chinese/normalizer.py": norm,
                                   "english/normalizer.py": norm})
    conv = "def convert(word):\n" + ("    raise ValueError('broken backend')\n" if broken
                                     else "    return 'IPA:' + word\n")
    _fake_package(tmp_path, "eng_to_ipa", {"__init__.py": conv})
    monkeypatch.syspath_prepend(str(tmp_path))
    try:
        if broken:
            for call in (lambda: text_frontend.basic_normalize("你好123", "zh"),
                         lambda: text_frontend.basic_normalize("hello 123", "en"),
                         lambda: text_frontend.to_ipa("hello", "en")):
                with pytest.raises(ValueError, match="broken backend"):
                    call()
        else:
            assert text_frontend.basic_normalize("你好 123", "zh") == "TN:你好123"
            assert text_frontend.basic_normalize("hello  123", "en") == "TN:hello 123"
            assert text_frontend.to_ipa("hello", "en") == "IPA:hello"
        assert text_frontend.to_ipa("中", "zh") == "zhong1"  # pypinyin is not installed
    finally:
        for mod in [m for m in sys.modules if m.split(".")[0] in ("tn", "eng_to_ipa")]:
            del sys.modules[mod]
    monkeypatch.undo()
    assert not text_frontend.installed("tn")
    assert text_frontend.basic_normalize("你好123", "zh") == "你好一百二十三"
