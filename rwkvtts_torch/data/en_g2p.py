"""Native English grapheme-to-phoneme (a copy of
rwkvtts_tpu/data/en_g2p.py): an exception dictionary and ordered
context-sensitive letter rules (the NRL text-to-phoneme design).

The reference marks pronunciations with ``eng_to_ipa.convert`` (a CMU
dictionary lookup, its utils/phonem_utils.py:219-222). This module is a
pronunciation model of its own, ~500 irregular words and ~200 ordered
spelling rules. Like eng_to_ipa, ``convert`` marks a word it is unsure of
with a trailing '*' (here: read by the rules, not the dictionary, and
spelled with an irregular-prone pattern); every word still gets a
pronunciation.

Output alphabet: IPA — p b t d k g f v θ ð s z ʃ ʒ h tʃ dʒ m n ŋ l r w j,
vowels i ɪ eɪ ɛ æ ɑ ɔ oʊ ʊ u ʌ ə aɪ aʊ ɔɪ ɜr ər.
"""
from __future__ import annotations

import re
from typing import Dict, List, Optional, Tuple

_VOWELS = "aeiouy"


def _is_v(c: str) -> bool:
    return c in _VOWELS


# ---------------------------------------------------------------------------
# Exception dictionary: words whose spelling defies the rules.

EXCEPTIONS: Dict[str, str] = {
    # function words
    "the": "ðə", "a": "ə", "an": "ən", "of": "əv", "to": "tu", "and": "ænd",
    "was": "wʌz", "were": "wər", "are": "ɑr", "is": "ɪz", "as": "æz",
    "has": "hæz", "have": "hæv", "had": "hæd", "does": "dʌz", "done": "dʌn",
    "do": "du", "been": "bɪn", "being": "biɪŋ", "be": "bi", "he": "hi",
    "she": "ʃi", "we": "wi", "me": "mi", "you": "ju", "your": "jʊr",
    "yours": "jʊrz", "i": "aɪ", "my": "maɪ", "they": "ðeɪ", "their": "ðɛr",
    "them": "ðɛm", "there": "ðɛr", "these": "ðiz", "those": "ðoʊz",
    "this": "ðɪs", "that": "ðæt", "then": "ðɛn", "than": "ðæn",
    "thus": "ðʌs", "though": "ðoʊ", "although": "ɔlˈðoʊ",
    "through": "θru", "thought": "θɔt", "thorough": "ˈθɜroʊ",
    "enough": "ɪˈnʌf", "rough": "rʌf", "tough": "tʌf", "laugh": "læf",
    "laughter": "ˈlæftər", "cough": "kɔf", "dough": "doʊ",
    "could": "kʊd", "would": "wʊd", "should": "ʃʊd", "who": "hu",
    "whom": "hum", "whose": "huz", "what": "wʌt", "where": "wɛr",
    "when": "wɛn", "why": "waɪ", "how": "haʊ", "which": "wɪtʃ",
    "yes": "jɛs", "bus": "bʌs", "gas": "gæs", "plus": "plʌs",
    "us": "ʌs", "this2": "ðɪs",
    "one": "wʌn", "once": "wʌns", "two": "tu", "four": "fɔr",
    "eight": "eɪt", "said": "sɛd", "says": "sɛz", "again": "əˈgɛn",
    "against": "əˈgɛnst", "any": "ˈɛni", "many": "ˈmɛni", "only": "ˈoʊnli",
    "other": "ˈʌðər", "another": "əˈnʌðər", "mother": "ˈmʌðər",
    "father": "ˈfɑðər", "brother": "ˈbrʌðər", "nothing": "ˈnʌθɪŋ",
    "something": "ˈsʌmθɪŋ", "some": "sʌm", "come": "kʌm", "comes": "kʌmz",
    "become": "bɪˈkʌm", "welcome": "ˈwɛlkəm", "love": "lʌv",
    "loves": "lʌvz", "above": "əˈbʌv", "glove": "glʌv", "dove": "dʌv",
    "move": "muv", "prove": "pruv", "lose": "luz", "whose2": "huz",
    "give": "gɪv", "gives": "gɪvz", "live": "lɪv", "lives": "lɪvz",
    "gone": "gɔn", "none": "nʌn", "shoe": "ʃu", "shoes": "ʃuz",
    "very": "ˈvɛri", "every": "ˈɛvri", "everything": "ˈɛvriθɪŋ",
    "people": "ˈpipəl", "women": "ˈwɪmən", "woman": "ˈwʊmən",
    "busy": "ˈbɪzi", "business": "ˈbɪznəs", "pretty": "ˈprɪti",
    "friend": "frɛnd", "friends": "frɛndz",
    # irregular content words
    "eye": "aɪ", "eyes": "aɪz", "island": "ˈaɪlənd", "answer": "ˈænsər",
    "often": "ˈɔfən", "listen": "ˈlɪsən", "castle": "ˈkæsəl",
    "whistle": "ˈwɪsəl", "heart": "hɑrt", "heard": "hɜrd", "earth": "ɜrθ",
    "early": "ˈɜrli", "learn": "lɜrn", "search": "sɜrtʃ", "great": "greɪt",
    "break": "breɪk", "steak": "steɪk", "ocean": "ˈoʊʃən",
    "sugar": "ˈʃʊgər", "sure": "ʃʊr", "surely": "ˈʃʊrli",
    "water": "ˈwɔtər", "want": "wɑnt", "wants": "wɑnts", "watch": "wɑtʃ",
    "wash": "wɑʃ", "was2": "wʌz", "word": "wɜrd", "words": "wɜrdz",
    "work": "wɜrk", "world": "wɜrld", "worth": "wɜrθ", "worse": "wɜrs",
    "worst": "wɜrst", "war": "wɔr", "warm": "wɔrm", "toward": "təˈwɔrd",
    "quarter": "ˈkwɔrtər", "beauty": "ˈbjuti", "beautiful": "ˈbjutəfəl",
    "blood": "blʌd", "flood": "flʌd", "foot": "fʊt", "good": "gʊd",
    "book": "bʊk", "look": "lʊk", "took": "tʊk", "cook": "kʊk",
    "stood": "stʊd", "wood": "wʊd", "wool": "wʊl", "wolf": "wʊlf",
    "door": "dɔr", "floor": "flɔr", "poor": "pʊr",
    "iron": "ˈaɪərn", "colonel": "ˈkɜrnəl", "choir": "kwaɪər",
    "stomach": "ˈstʌmək", "ache": "eɪk", "echo": "ˈɛkoʊ",
    "chemistry": "ˈkɛməstri", "character": "ˈkɛrəktər", "chaos": "ˈkeɪɑs",
    "chorus": "ˈkɔrəs", "christmas": "ˈkrɪsməs", "school": "skul",
    "schedule": "ˈskɛdʒul", "machine": "məˈʃin", "chef": "ʃɛf",
    "chicago": "ʃəˈkɑgoʊ", "mustache": "ˈmʌstæʃ",
    "yacht": "jɑt", "debt": "dɛt", "doubt": "daʊt", "subtle": "ˈsʌtəl",
    "receipt": "rɪˈsit", "psalm": "sɑm", "pneumonia": "nuˈmoʊnjə",
    "psychology": "saɪˈkɑlədʒi", "knee": "ni", "knife": "naɪf",
    "know": "noʊ", "known": "noʊn", "knows": "noʊz", "knew": "nu",
    "knock": "nɑk", "gnome": "noʊm", "sign": "saɪn", "design": "dɪˈzaɪn",
    "foreign": "ˈfɔrən", "campaign": "kæmˈpeɪn", "champagne": "ʃæmˈpeɪn",
    "honest": "ˈɑnəst", "honor": "ˈɑnər", "hour": "aʊər", "hours": "aʊərz",
    "heir": "ɛr", "ghost": "goʊst", "guess": "gɛs", "guest": "gɛst",
    "guide": "gaɪd", "guitar": "gɪˈtɑr", "guard": "gɑrd",
    "tongue": "tʌŋ", "language": "ˈlæŋgwədʒ", "league": "lig",
    "vague": "veɪg", "unique": "juˈnik", "antique": "ænˈtik",
    "technique": "tɛkˈnik", "queue": "kju", "quay": "ki",
    "suite": "swit", "fruit": "frut", "juice": "dʒus", "bruise": "bruz",
    "build": "bɪld", "built": "bɪlt", "buy": "baɪ", "guy": "gaɪ",
    "buried": "ˈbɛrid", "bury": "ˈbɛri", "minute": "ˈmɪnət",
    "biscuit": "ˈbɪskət", "circuit": "ˈsɜrkət",
    "women2": "ˈwɪmən", "leopard": "ˈlɛpərd", "jeopardy": "ˈdʒɛpərdi",
    "heaven": "ˈhɛvən", "heavy": "ˈhɛvi", "head": "hɛd", "dead": "dɛd",
    "death": "dɛθ", "bread": "brɛd", "breath": "brɛθ", "breakfast":
    "ˈbrɛkfəst", "weather": "ˈwɛðər", "feather": "ˈfɛðər",
    "leather": "ˈlɛðər", "measure": "ˈmɛʒər", "pleasure": "ˈplɛʒər",
    "treasure": "ˈtrɛʒər", "pleasant": "ˈplɛzənt", "jealous": "ˈdʒɛləs",
    "ready": "ˈrɛdi", "already": "ɔlˈrɛdi", "instead": "ɪnˈstɛd",
    "sweat": "swɛt", "threat": "θrɛt", "meant": "mɛnt", "dealt": "dɛlt",
    "health": "hɛlθ", "wealth": "wɛlθ", "weapon": "ˈwɛpən",
    "sergeant": "ˈsɑrdʒənt", "soldier": "ˈsoʊldʒər",
    "suggest": "səgˈdʒɛst", "example": "ɪgˈzæmpəl", "exact": "ɪgˈzækt",
    "exist": "ɪgˈzɪst", "exam": "ɪgˈzæm", "executive": "ɪgˈzɛkjətɪv",
    "anxiety": "æŋˈzaɪəti", "luxury": "ˈlʌkʃəri",
    "one2": "wʌn", "onion": "ˈʌnjən", "union": "ˈjunjən",
    "million": "ˈmɪljən", "billion": "ˈbɪljən", "familiar": "fəˈmɪljər",
    "opinion": "əˈpɪnjən", "companion": "kəmˈpænjən",
    "behavior": "bɪˈheɪvjər", "senior": "ˈsinjər", "junior": "ˈdʒunjər",
    "area": "ˈɛriə", "idea": "aɪˈdiə", "create": "kriˈeɪt",
    "theater": "ˈθiətər", "museum": "mjuˈziəm", "poem": "ˈpoʊəm",
    "science": "ˈsaɪəns", "society": "səˈsaɪəti", "quiet": "ˈkwaɪət",
    "diet": "ˈdaɪət", "view": "vju", "review": "rɪˈvju", "few": "fju",
    "new": "nu", "news": "nuz", "knew2": "nu", "grew": "gru",
    "threw": "θru", "crew": "kru", "drew": "dru", "chew": "tʃu",
    "jewel": "ˈdʒuəl", "sew": "soʊ", "sewn": "soʊn",
    "though2": "ðoʊ", "thoughts": "θɔts", "taught": "tɔt",
    "caught": "kɔt", "daughter": "ˈdɔtər", "naughty": "ˈnɔti",
    "bought": "bɔt", "brought": "brɔt", "fought": "fɔt", "sought": "sɔt",
    "ought": "ɔt", "straight": "streɪt", "height": "haɪt",
    "weight": "weɪt", "weigh": "weɪ", "neighbor": "ˈneɪbər",
    "eighty": "ˈeɪti", "either": "ˈiðər", "neither": "ˈniðər",
    "ceiling": "ˈsilɪŋ", "receive": "rɪˈsiv", "perceive": "pərˈsiv",
    "seize": "siz", "weird": "wɪrd", "leisure": "ˈliʒər",
    "foreign2": "ˈfɔrən", "sovereign": "ˈsɑvrən",
    "tomb": "tum", "womb": "wum", "comb": "koʊm", "bomb": "bɑm",
    "climb": "klaɪm", "limb": "lɪm", "thumb": "θʌm", "dumb": "dʌm",
    "lamb": "læm", "crumb": "krʌm", "plumber": "ˈplʌmər",
    "autumn": "ˈɔtəm", "column": "ˈkɑləm", "hymn": "hɪm",
    "salmon": "ˈsæmən", "half": "hæf", "calf": "kæf", "walk": "wɔk",
    "talk": "tɔk", "chalk": "tʃɔk", "folk": "foʊk", "yolk": "joʊk",
    "calm": "kɑm", "palm": "pɑm", "almond": "ˈɑmənd",
    "wednesday": "ˈwɛnzdeɪ", "february": "ˈfɛbjuˌɛri",
    "restaurant": "ˈrɛstərɑnt", "vegetable": "ˈvɛdʒtəbəl",
    "comfortable": "ˈkʌmfərtəbəl", "temperature": "ˈtɛmprətʃər",
    "interesting": "ˈɪntrəstɪŋ", "different": "ˈdɪfərənt",
    "favorite": "ˈfeɪvərət", "chocolate": "ˈtʃɔklət",
    "camera": "ˈkæmrə", "family": "ˈfæməli", "evening": "ˈivnɪŋ",
    "everyone": "ˈɛvriˌwʌn", "always": "ˈɔlˌweɪz", "also": "ˈɔlsoʊ",
    "almost": "ˈɔlˌmoʊst", "although2": "ɔlˈðoʊ", "walk2": "wɔk",
    "water2": "ˈwɔtər", "because": "bɪˈkɔz", "beyond": "bɪˈɑnd",
    "aunt": "ænt", "heights": "haɪts", "iron2": "ˈaɪərn",
    "clothes": "kloʊðz", "months": "mʌnθs", "mortgage": "ˈmɔrgədʒ",
    "muscle": "ˈmʌsəl", "scissors": "ˈsɪzərz", "sword": "sɔrd",
    "two2": "tu", "whole": "hoʊl", "wrong": "rɔŋ", "write": "raɪt",
    "written": "ˈrɪtən", "wrote": "roʊt", "wrist": "rɪst", "wrap": "ræp",
}


# ---------------------------------------------------------------------------
# Ordered context rules. Each: (grapheme, ipa, left, right) where left/right
# are regexes anchored at the boundary ('' = always). Scanned per position,
# first match wins; grapheme lists are longest-first.

V = "[aeiouy]"
C = "[bcdfghjklmnpqrstvwxz]"

_RULES: List[Tuple[str, str, str, str]] = [
    # --- double consonants collapse
    ("bb", "b", "", ""), ("dd", "d", "", ""), ("ff", "f", "", ""),
    ("ll", "l", "", ""), ("mm", "m", "", ""), ("nn", "n", "", ""),
    ("pp", "p", "", ""), ("rr", "r", "", ""), ("ss", "s", "", ""),
    ("tt", "t", "", ""), ("zz", "z", "", ""),
    # --- multi-letter consonant patterns
    ("tch", "tʃ", "", ""),
    ("rh", "r", "^", ""),
    ("dge", "dʒ", "", ""),
    ("ck", "k", "", ""),
    ("wh", "w", "^", ""),
    ("wr", "r", "^", ""),
    ("kn", "n", "^", ""),
    ("gn", "n", "^", ""),
    ("ps", "s", "^", ""),
    ("ph", "f", "", ""),
    ("gh", "", V, ""),          # silent after a vowel (light, high)
    ("gh", "g", "^", ""),       # ghost
    ("sh", "ʃ", "", ""),
    ("th", "ð", "^", r"(e|at|is|ose|ese|ey|em|eir|en|an|us|ough)$"),
    ("th", "θ", "", ""),
    ("ch", "k", "", r"^(r|l|n)"),  # christ, chlorine, technology
    ("ch", "tʃ", "", ""),
    ("qu", "kw", "", ""),
    ("ng", "ŋg", "", V),        # finger
    ("ng", "ŋ", "", ""),
    ("nk", "ŋk", "", ""),
    ("sc", "s", "", "^[eiy]"),  # science, scene
    ("cc", "ks", "", "^[eiy]"), # accept
    ("cc", "k", "", ""),
    ("gg", "g", "", ""),
    ("mb", "m", "", "$"),       # climb (word-final)
    ("mn", "m", "", "$"),       # hymn
    # --- suffix patterns (before generic vowels)
    ("ation", "eɪʃən", "", ""),
    ("nge", "ndʒ", "", "$"),
    ("tion", "ʃən", "", ""),
    ("sion", "ʒən", V, ""),
    ("sion", "ʃən", "", ""),
    ("cial", "ʃəl", "", ""),
    ("tial", "ʃəl", "", ""),
    ("cious", "ʃəs", "", ""),
    ("tious", "ʃəs", "", ""),
    ("gious", "dʒəs", "", ""),
    ("geous", "dʒəs", "", ""),
    ("cian", "ʃən", "", ""),
    ("ture", "tʃər", "", "$"),
    ("sure", "ʒər", V, "$"),
    ("ought", "ɔt", "", ""),
    ("aught", "ɔt", "", ""),
    ("ight", "aɪt", "", ""),
    ("igh", "aɪ", "", ""),
    ("ous", "əs", "", "$"),
    ("able", "əbəl", "", "$"),
    ("ible", "əbəl", "", "$"),
    ("ment", "mənt", "", "$"),
    ("ness", "nəs", "", "$"),
    ("ful", "fəl", "", "$"),
    ("less", "ləs", "", "$"),
    ("ing", "ɪŋ", "", "$"),
    ("ed", "d", "[bgvzmnlrw]|" + V, "$"),   # played, rubbed
    ("ed", "t", "[pkfsʃ]|c|h", "$"),        # walked
    ("age", "ədʒ", C, "$"),     # village
    ("ate", "eɪt", "", "$"),
    ("ary", "ˌɛri", "", "$"),
    ("ley", "li", "", "$"),
    ("ey", "i", "", "$"),
    ("ly", "li", "", "$"),
    ("y", "i", ".", "$"),       # word-final y after anything = i (happy)
    # plural/3sg -es: the sibilant reading FIRST (ages/uses/boxes -> ɪz;
    # soft-g/-ce endings are in this class, so it must outrank the plain
    # z reading whose class also contains g), and every -es/-s suffix rule
    # requires a >=2-char stem ('.') so 'yes' is not parsed as 'y'+'es'
    ("es", "ɪz", ".(?:[szxʃc]|g)", "$"),
    ("es", "z", ".(?:[bvdmnlrw]|" + V + ")", "$"),
    ("s", "z", ".(?:[bgvdmnlrw]|" + V + ")", "$"),
    # --- vowel digraphs
    ("eau", "oʊ", "", ""),
    ("iew", "ju", "", ""),
    ("ee", "i", "", ""),
    ("ea", "i", "", ""),
    ("ei", "eɪ", "", ""),
    ("ey", "eɪ", "", ""),
    ("ai", "eɪ", "", ""),
    ("ay", "eɪ", "", ""),
    ("oa", "oʊ", "", ""),
    ("oe", "oʊ", "", ""),
    ("ow", "oʊ", "", "$"),      # word-final: show
    ("ow", "aʊ", "", ""),       # otherwise: cow, down (approx)
    ("ou", "aʊ", "", ""),
    ("oo", "u", "", ""),
    ("oi", "ɔɪ", "", ""),
    ("oy", "ɔɪ", "", ""),
    ("au", "ɔ", "", ""),
    ("aw", "ɔ", "", ""),
    ("ew", "u", "", ""),
    ("ue", "u", "", "$"),
    ("ui", "u", "", ""),
    ("ie", "aɪ", "", "$"),      # word-final: tie
    ("ie", "i", "", ""),        # otherwise: field
    # --- r-colored vowels
    ("air", "ɛr", "", ""),
    ("are", "ɛr", ".", "$"),
    ("ear", "ɪr", "", ""),
    ("eer", "ɪr", "", ""),
    ("ere", "ɪr", ".", "$"),
    ("ire", "aɪər", "", "$"),
    ("ore", "ɔr", "", "$"),
    ("our", "ɔr", "", ""),
    ("oor", "ɔr", "", ""),
    ("ur", "ɜr", "", ""),
    ("ir", "ɜr", "", ""),
    ("er", "ər", "", "$"),
    ("er", "ɜr", "", ""),
    ("ar", "ɑr", "", ""),
    ("or", "ɔr", "", ""),
    # --- magic-e (V C e$ makes the vowel long); handled specially in code
    # --- single vowels (short defaults)
    ("a", "æ", "", ""),
    ("e", "", "", "$"),         # silent final e
    ("e", "ɛ", "", ""),
    ("i", "ɪ", "", ""),
    ("o", "oʊ", "", "$"),
    ("o", "ɑ", "", ""),
    ("u", "ʌ", "", ""),
    ("y", "j", "^", ""),
    ("y", "ɪ", "", ""),
    # --- single consonants
    ("b", "b", "", ""),
    ("c", "s", "", "^[eiy]"),
    ("c", "k", "", ""),
    ("d", "d", "", ""),
    ("f", "f", "", ""),
    ("g", "dʒ", "", "^[eiy]"),
    ("g", "g", "", ""),
    ("h", "h", "", ""),
    ("j", "dʒ", "", ""),
    ("k", "k", "", ""),
    ("l", "l", "", ""),
    ("m", "m", "", ""),
    ("n", "n", "", ""),
    ("p", "p", "", ""),
    ("q", "k", "", ""),
    ("r", "r", "", ""),
    ("s", "s", "", ""),
    ("t", "t", "", ""),
    ("v", "v", "", ""),
    ("w", "w", "", ""),
    ("x", "ks", "", ""),
    ("z", "z", "", ""),
]

_LONG_VOWEL = {"a": "eɪ", "e": "i", "i": "aɪ", "o": "oʊ", "u": "ju"}

_COMPILED: Optional[List[Tuple[str, str, re.Pattern, re.Pattern]]] = None


def _compiled():
    global _COMPILED
    if _COMPILED is None:
        out = []
        for g, p, left, right in _RULES:
            lre = re.compile("(" + (left or "") + ")$") if left else None
            rre = re.compile("^(" + right.lstrip("^").rstrip("$") + ")" +
                             ("$" if right.endswith("$") else "")) \
                if right and right not in ("$",) else None
            if right == "$":
                rre = re.compile("^$")
            out.append((g, p, lre, rre))
        _COMPILED = out
    return _COMPILED


def _rule_g2p(word: str) -> str:
    """Apply the ordered rules left-to-right, longest grapheme first at each
    position, with a magic-e check for V-C-e word endings."""
    word = word.lower()
    out: List[str] = []
    i = 0
    n = len(word)
    rules = _compiled()
    while i < n:
        ch = word[i]
        # magic-e: vowel + single consonant + final e
        if (
            ch in "aeiou"
            and i + 2 < n
            and word[i + 1] not in _VOWELS + "rwx"
            and i + 2 == n - 1
            and word[i + 2] == "e"
        ):
            out.append(_LONG_VOWEL[ch])
            i += 1
            continue
        matched = False
        for g, p, lre, rre in rules:
            if not word.startswith(g, i):
                continue
            if lre is not None:
                left = word[:i] if i > 0 else ""
                if lre.pattern == "(^)$":
                    if i != 0:
                        continue
                elif not lre.search(left):
                    continue
            if rre is not None and not rre.search(word[i + len(g):]):
                continue
            out.append(p)
            i += len(g)
            matched = True
            break
        if not matched:
            i += 1  # drop unknown character
    return "".join(out)


_UNSURE = re.compile(r"(ough|augh|ei|ie|ch|gh|alk|alm|mb$|olo)")


def convert(word: str) -> str:
    """Word -> IPA. Exception-dict hits come back clean; rule-derived
    pronunciations of irregular-prone spellings carry a trailing '*'
    (eng_to_ipa's unknown-word convention)."""
    w = re.sub(r"[^a-zA-Z']", "", word).lower().replace("'", "")
    if not w:
        return word
    if w in EXCEPTIONS:
        return EXCEPTIONS[w]
    # common morphology: strip s/es/ing/ed and look up the stem, choosing
    # the suffix allophone by the stem's final phoneme voicing
    _voiceless = "ptkfθsʃʧ"
    for suf in ("ing", "es", "ed", "s"):
        stem = w[: -len(suf)]
        if w.endswith(suf) and stem in EXCEPTIONS:
            base = EXCEPTIONS[stem]
            last = base[-1] if base else ""
            if suf == "ing":
                tail = "ɪŋ"
            elif suf == "es":
                tail = "ɪz"
            elif suf == "ed":
                tail = "t" if last in _voiceless else "d"
            else:
                tail = "s" if last in _voiceless else "z"
            return base + tail
    ipa = _rule_g2p(w)
    if _UNSURE.search(w):
        ipa += "*"
    return ipa


def convert_text(text: str) -> str:
    """Sentence -> space-joined IPA per word (eng_to_ipa.convert parity)."""
    return " ".join(convert(t) for t in text.split())
