"""SPCT property-token mapping for controllable TTS (a copy of
rwkvtts_tpu/data/properties.py).

Contract source: the reference implementation, utils/properties_util.py (token names and
numeric bucket boundaries are a data contract baked into trained models —
reproduced exactly; the duplicated GENDER_MAP in the reference resolves to
the second definition, SPCT_46/47, per its own comment at :58-60).

Property string = "SPCT_0" + age + gender + emotion + pitch + speed tokens,
encoded by the tokenizer with SPCT_* as added tokens (ids 65536+i).
"""
from __future__ import annotations

SPEED_TOKENS = {
    "very_slow": "SPCT_1",
    "slow": "SPCT_2",
    "medium": "SPCT_3",
    "fast": "SPCT_4",
    "very_fast": "SPCT_5",
}

PITCH_TOKENS = {
    "low_pitch": "SPCT_6",
    "medium_pitch": "SPCT_7",
    "high_pitch": "SPCT_8",
    "very_high_pitch": "SPCT_9",
}

AGE_TOKENS = {
    "child": "SPCT_13",
    "teenager": "SPCT_14",
    "youth-adult": "SPCT_15",
    "middle-aged": "SPCT_16",
    "elderly": "SPCT_17",
}

GENDER_TOKENS = {"female": "SPCT_46", "male": "SPCT_47"}

EMOTION_TOKENS = {
    e: f"SPCT_{21 + i}"
    for i, e in enumerate(
        [
            "UNKNOWN", "NEUTRAL", "ANGRY", "HAPPY", "SAD", "FEARFUL",
            "DISGUSTED", "SURPRISED", "SARCASTIC", "EXCITED", "SLEEPY",
            "CONFUSED", "EMPHASIS", "LAUGHING", "SINGING", "WORRIED",
            "WHISPER", "ANXIOUS", "NO-AGREEMENT", "APOLOGETIC", "CONCERNED",
            "ENUNCIATED", "ASSERTIVE", "ENCOURAGING", "CONTEMPT",
        ]
    )
}

NUM_SPCT_TOKENS = 48  # SPCT_0 .. SPCT_47

# Pitch bucket boundaries (Hz) per (gender, age): (low<, med<, high<) —
# above the last boundary is very_high; female/child has no very_high bucket.
_PITCH_BOUNDS = {
    ("female", "child"): (250, 290, None),
    ("female", "teenager"): (208, 238, 270),
    ("female", "youth-adult"): (191, 211, 232),
    ("female", "middle-aged"): (176, 195, 215),
    ("female", "elderly"): (170, 190, 213),
    ("female", None): (187, 209, 232),
    ("male", "teenager"): (121, 143, 166),
    ("male", "youth-adult"): (115, 131, 153),
    ("male", "middle-aged"): (110, 125, 147),
    ("male", "elderly"): (115, 128, 142),
    ("male", None): (114, 130, 151),
    (None, None): (130, 180, 220),
}

_BUCKET_NAMES = ("low_pitch", "medium_pitch", "high_pitch", "very_high_pitch")


def classify_pitch(pitch: float, gender: str, age: str) -> str:
    gender, age = gender.lower(), age.lower()
    key = (gender, age)
    if key not in _PITCH_BOUNDS:
        key = (gender, None) if (gender, None) in _PITCH_BOUNDS else (None, None)
    lo, mid, hi = _PITCH_BOUNDS[key]
    if pitch < lo:
        return "low_pitch"
    if pitch < mid:
        return "medium_pitch"
    if hi is None or pitch < hi:
        return "high_pitch"
    return "very_high_pitch"


def classify_speed(speed: float) -> str:
    """Syllables/sec buckets (reference properties_util.py:82-92; note the
    reference's open interval leaves speed==4.0 falling to very_fast — kept)."""
    if speed <= 3.5:
        return "very_slow"
    if 3.5 < speed < 4.0:
        return "slow"
    if 4.0 < speed <= 4.5:
        return "medium"
    if 4.5 < speed <= 5.0:
        return "fast"
    return "very_fast"


def properties_string(
    age: str, gender: str, emotion: str, pitch, speed
) -> str:
    """The SPCT prefix string; pitch/speed may be numeric (bucketed) or
    already-categorical strings."""
    if isinstance(pitch, (int, float)):
        pitch = classify_pitch(float(pitch), gender, age)
    if isinstance(speed, (int, float)):
        speed = classify_speed(float(speed))
    return (
        "SPCT_0"
        + AGE_TOKENS[age.lower()]
        + GENDER_TOKENS[gender.lower()]
        + EMOTION_TOKENS[emotion.upper()]
        + PITCH_TOKENS[pitch.lower()]
        + SPEED_TOKENS[speed.lower()]
    )
