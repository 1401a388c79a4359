"""Native Chinese text normalization (a copy of rwkvtts_tpu/data/zh_tn.py):
digits, dates, times, percentages, fractions, money, units, ranges, scores
and phone numbers verbalized as spoken Mandarin, and an English number
speller.

The reference normalizes zh text with WeTextProcessing's zh TN ruleset and
en text with its en ruleset and inflect's number speller
(cosyvoice/cli/frontend.py:124-152, ``spell_out_number`` in
cosyvoice/utils/frontend_utils.py). This module writes the conventions of
those rulesets as ordered regex rules in plain Python:
  * integers read positionally: 123 -> 一百二十三, with 零 collapsing
    (1005 -> 一千零五) and 两 never substituted (the ruleset reads 二)
  * years digit by digit: 2024年 -> 二零二四年
  * decimals: 3.14 -> 三点一四
  * percent: 50% -> 百分之五十
  * fractions: 3/4 -> 四分之三
  * times: 10:30 -> 十点三十分, 10:05:09 -> 十点零五分九秒
  * dates: 2024年1月5日 (年 digit-wise, 月/日 positional)
  * money: ¥9.9 / 9.9元 -> 九点九元
  * signed numbers: -5°C -> 零下五摄氏度 (temperature) / 负五 (plain)
  * phone-shaped digit runs (>= 7 digits) read digit by digit with 幺 for 1
  * ranges: 3~5 -> 三到五; scores: 2:1 -> 二比一 (when not a time)
The order of the rules matters: ISO dates before phone numbers and ranges,
scores before times, percent ranges before percentages.
"""
from __future__ import annotations

import re
from typing import List

__all__ = [
    "normalize_zh",
    "normalize_en",
    "num_to_zh",
    "digits_to_zh",
    "num_to_en",
]

# ---------------------------------------------------------------------------
# Cardinal reading

_DIGITS = "零一二三四五六七八九"
_UNITS_SMALL = ["", "十", "百", "千"]
_UNITS_BIG = ["", "万", "亿", "万亿"]


def _four_digits_to_zh(n: int) -> str:
    """0 < n < 10000 -> positional reading without group-level 零 handling."""
    out = []
    s = str(n)
    ld = len(s)
    for i, ch in enumerate(s):
        d = int(ch)
        unit = _UNITS_SMALL[ld - 1 - i]
        if d == 0:
            out.append("零")
        else:
            out.append(_DIGITS[d] + unit)
    # collapse runs of 零 and strip edge 零
    text = re.sub("零+", "零", "".join(out)).strip("零")
    # 一十X -> 十X only when 十 leads the whole group reading
    if text.startswith("一十"):
        text = text[1:]
    return text


def num_to_zh(n: int) -> str:
    """Integer -> spoken Mandarin (positional). 10203 -> 一万零二百零三.
    From 10^16 on, past the group units, digit by digit (the JAX package's
    raises IndexError there)."""
    if n < 0:
        return "负" + num_to_zh(-n)
    if n == 0:
        return "零"
    if n >= 10000 ** len(_UNITS_BIG):
        return digits_to_zh(str(n))
    groups: List[int] = []  # little-endian 4-digit groups
    while n > 0:
        groups.append(n % 10000)
        n //= 10000
    parts: List[str] = []
    for gi in range(len(groups) - 1, -1, -1):
        g = groups[gi]
        if g == 0:
            continue
        text = _four_digits_to_zh(g)
        # a group under 1000 after a higher group needs a joining 零
        if parts and groups[gi] < 1000:
            parts.append("零")
        # 一十X -> 十X is only valid for the LEADING group
        if parts and text.startswith("十"):
            text = "一" + text
        parts.append(text + _UNITS_BIG[gi])
    return re.sub("零+", "零", "".join(parts))


def digits_to_zh(s: str, phone: bool = False) -> str:
    """Digit string read digit-by-digit; phone style reads 1 as 幺."""
    one = "幺" if phone else "一"
    return "".join(one if c == "1" else _DIGITS[int(c)] for c in s if c.isdigit())


def _decimal_to_zh(s: str) -> str:
    """'3.14' -> 三点一四 (integer part positional, fraction digit-wise)."""
    neg = s.startswith("-")
    s = s.lstrip("+-")
    if "." in s:
        ip, fp = s.split(".", 1)
        ip = ip or "0"
        body = num_to_zh(int(ip)) + "点" + digits_to_zh(fp)
    else:
        body = num_to_zh(int(s))
    return ("负" + body) if neg else body


# ---------------------------------------------------------------------------
# English cardinal reading (inflect.number_to_words parity for TTS purposes)

_EN_ONES = [
    "zero", "one", "two", "three", "four", "five", "six", "seven", "eight",
    "nine", "ten", "eleven", "twelve", "thirteen", "fourteen", "fifteen",
    "sixteen", "seventeen", "eighteen", "nineteen",
]
_EN_TENS = [
    "", "", "twenty", "thirty", "forty", "fifty", "sixty", "seventy",
    "eighty", "ninety",
]
_EN_SCALE = ["", " thousand", " million", " billion", " trillion"]


def _en_under_1000(n: int) -> str:
    parts = []
    if n >= 100:
        parts.append(_EN_ONES[n // 100] + " hundred")
        n %= 100
        if n:
            parts.append("and")
    if n >= 20:
        t = _EN_TENS[n // 10]
        parts.append(t + ("-" + _EN_ONES[n % 10] if n % 10 else ""))
    elif n > 0:
        parts.append(_EN_ONES[n])
    return " ".join(parts)


def num_to_en(n: int) -> str:
    """Integer -> English words. 1234 -> 'one thousand two hundred and
    thirty-four' (inflect's andless comma-free style minus commas). From
    10^15 on, past the scale words, digit by digit (the JAX package's
    raises IndexError there)."""
    if n < 0:
        return "minus " + num_to_en(-n)
    if n == 0:
        return "zero"
    if n >= 1000 ** len(_EN_SCALE):
        return " ".join(_EN_ONES[int(c)] for c in str(n))
    groups: List[int] = []
    while n > 0:
        groups.append(n % 1000)
        n //= 1000
    parts = []
    for gi in range(len(groups) - 1, -1, -1):
        if groups[gi]:
            parts.append(_en_under_1000(groups[gi]) + _EN_SCALE[gi])
    return " ".join(parts)


def _en_decimal(s: str) -> str:
    neg = s.startswith("-")
    s = s.lstrip("+-")
    if "." in s:
        ip, fp = s.split(".", 1)
        body = num_to_en(int(ip or "0")) + " point " + " ".join(
            _EN_ONES[int(c)] for c in fp if c.isdigit()
        )
    else:
        body = num_to_en(int(s))
    return ("minus " + body) if neg else body


def normalize_en(text: str) -> str:
    """Spell out digit sequences in English text (the reference's
    spell_out_number(inflect) step)."""

    def repl(m: re.Match) -> str:
        return _en_decimal(m.group(0))

    text = re.sub(r"(\d+,)+\d{3}", lambda m: m.group(0).replace(",", ""), text)
    text = re.sub(r"(\d+)%", lambda m: num_to_en(int(m.group(1))) + " percent", text)
    return re.sub(r"-?\d+(?:\.\d+)?", repl, text)


# ---------------------------------------------------------------------------
# zh category rules (order matters: specific patterns before bare numbers)

_UNIT_WORDS = {
    "km": "千米", "cm": "厘米", "mm": "毫米", "kg": "千克", "g": "克",
    "mg": "毫克", "ml": "毫升", "kwh": "千瓦时", "kw": "千瓦",
    "hz": "赫兹", "khz": "千赫兹", "mhz": "兆赫兹", "ghz": "吉赫兹",
    "gb": "吉字节", "mb": "兆字节", "kb": "千字节", "tb": "太字节",
    "m": "米", "l": "升", "h": "小时",
}


def _year_digits(m: re.Match) -> str:
    return digits_to_zh(m.group(1)) + "年"


def _date(m: re.Match) -> str:
    mo, day = int(m.group(1)), int(m.group(2))
    return num_to_zh(mo) + "月" + num_to_zh(day) + "日"


def _time(m: re.Match) -> str:
    h, mi = int(m.group(1)), int(m.group(2))
    sec = m.group(3)
    out = num_to_zh(h) + "点"
    if mi == 0 and not sec:
        pass  # "12:00" -> 十二点 (a source-text 整 suffix reads naturally)
    else:
        if mi < 10 and mi > 0:
            out += "零" + num_to_zh(mi) + "分"
        elif mi == 0:
            out += "零分" if sec else ""
        else:
            out += num_to_zh(mi) + "分"
    if sec:
        out += num_to_zh(int(sec)) + "秒"
    return out


def _percent(m: re.Match) -> str:
    return "百分之" + _decimal_to_zh(m.group(1))


def _fraction(m: re.Match) -> str:
    num, den = int(m.group(1)), int(m.group(2))
    return num_to_zh(den) + "分之" + num_to_zh(num)


def _range(m: re.Match) -> str:
    return _decimal_to_zh(m.group(1)) + "到" + _decimal_to_zh(m.group(2))


def _score(m: re.Match) -> str:
    a, b = (m.group(1), m.group(2)) if m.group(1) else (m.group(3), m.group(4))
    return num_to_zh(int(a)) + "比" + num_to_zh(int(b))


def _money_yuan(m: re.Match) -> str:
    return _decimal_to_zh(m.group(1)) + "元"


def _temperature(m: re.Match) -> str:
    body = _decimal_to_zh(m.group(2))
    if m.group(1) == "-":
        body = "零下" + body
    return body + "摄氏度"


def _phone(m: re.Match) -> str:
    return digits_to_zh(m.group(0), phone=True)


def _plain_number(m: re.Match) -> str:
    s = m.group(0)
    # long bare digit runs (ids/codes) read digit-by-digit
    if "." not in s and len(s.lstrip("+-")) >= 9:
        return digits_to_zh(s)
    return _decimal_to_zh(s)


def _iso_date(m: re.Match) -> str:
    return (
        digits_to_zh(m.group(1)) + "年"
        + num_to_zh(int(m.group(2))) + "月"
        + num_to_zh(int(m.group(3))) + "日"
    )


def _percent_range(m: re.Match) -> str:
    return (
        "百分之" + _decimal_to_zh(m.group(1))
        + "到百分之" + _decimal_to_zh(m.group(2))
    )


_ZH_RULES = [
    # ISO dates FIRST: the phone/range rules would otherwise read
    # 2024-01-05 digit-by-digit / as "2024 to 1, minus 5"
    # (WeTextProcessing reads it as a date)
    (re.compile(r"(?<!\d)(\d{4})-(\d{1,2})-(\d{1,2})(?!\d)"), _iso_date),
    # phone-shaped digit runs next (a hyphenated phone would otherwise
    # match the range rule); any >=3-group hyphenated digit run (service/
    # serial numbers like 400-123-4567) also reads digit-by-digit
    (
        re.compile(
            r"(?<!\d)(?:1[3-9]\d{9}|\d{3,4}-\d{7,8}|\d+(?:-\d+){2,})(?!\d)"
            r"|(?:(?<=拨打)|(?<=致电))(?:110|119|120|122)(?!\d)"
        ),
        _phone,
    ),
    # scores before times (2:1 with a score cue is 比, not 点...分)
    (
        re.compile(
            r"(?:(?<=比分)|(?<=战成))\s*(\d+)\s*[:比]\s*(\d+)"
            r"|(\d+)\s*[:比]\s*(\d+)(?=\s*(?:获?胜|领先|击败))"
        ),
        _score,
    ),
    # dates / times
    (re.compile(r"(\d{2,4})年"), _year_digits),
    (re.compile(r"(\d{1,2})月(\d{1,2})[日号]"), _date),
    (re.compile(r"(\d{1,2}):(\d{1,2})(?::(\d{1,2}))?(?=[^\d:]|$)"), _time),
    # percent / fraction / range; a percent RANGE (10~20%) distributes
    # 百分之 over both ends before the bare-percent rule can eat the
    # right end and strand the separator
    (
        re.compile(r"(\d+(?:\.\d+)?)\s*[~～—–-]\s*(\d+(?:\.\d+)?)%"),
        _percent_range,
    ),
    (re.compile(r"(-?\d+(?:\.\d+)?)%"), _percent),
    (re.compile(r"(\d+)/(\d+)"), _fraction),
    (re.compile(r"(\d+(?:\.\d+)?)[~～—–-](\d+(?:\.\d+)?)(?=[^\d]|$)"), _range),
    # money / temperature
    (re.compile(r"[¥￥](\d+(?:\.\d+)?)"), _money_yuan),
    (re.compile(r"(-?)(\d+(?:\.\d+)?)\s*(?:°C|℃|摄氏度)"), _temperature),
]


def _units(text: str) -> str:
    def repl(m: re.Match) -> str:
        unit = _UNIT_WORDS.get(m.group(2).lower())
        return m.group(1) + (unit if unit else m.group(2))

    multi = [u for u in _UNIT_WORDS if len(u) > 1]
    single = [u for u in _UNIT_WORDS if len(u) == 1]
    # multi-letter units match case-insensitively (5KM, 3Kg); SINGLE-letter
    # units only lowercase — '5G'/'3M' are tech/brand tokens, not grams or
    # meters (WeTextProcessing's tagger makes the same distinction)
    pat = (
        r"(\d(?:\.\d+)?)\s*("
        + "|".join(
            sorted((f"(?i:{u})" for u in multi), key=len, reverse=True)
        )
        + "|" + "|".join(single)
        + r")(?![a-zA-Z])"
    )
    return re.sub(pat, repl, text)


def normalize_zh(text: str) -> str:
    """Verbalize all digit-bearing categories in zh text.

    The categories of WeTextProcessing's zh TN (the reference's
    cosyvoice/cli/frontend.py:137, tagger -> verbalizer), as plain ordered
    regex rules."""
    text = text.replace("－", "-").replace("％", "%")
    # digit-grouping commas
    text = re.sub(r"(\d+,)+\d{3}", lambda m: m.group(0).replace(",", ""), text)
    text = _units(text)
    for pat, fn in _ZH_RULES:
        text = pat.sub(fn, text)
    # remaining bare numbers
    text = re.sub(r"-?\d+(?:\.\d+)?", _plain_number, text)
    return text
