"""CosyVoice prompt layout, token domain (a copy of the inference half of
rwkvtts_tpu/data/cosy_collator.py; the training collate comes later).

The zero-shot prompt is [SOS][text][TASK][prompt speech ...]; decoding
continues with speech tokens. The content length, which bounds the decode
length, leaves out instruction text before <|endofprompt|>.
"""
from __future__ import annotations

from typing import Sequence

from rwkvtts_torch.data.spark_collator import IGNORE, Sample
from rwkvtts_torch.models.cosy import MOD_SPECIAL, MOD_SPEECH, MOD_TEXT, SOS_EOS, TASK_ID


def build_prompt(text_ids: Sequence[int], prompt_speech_tokens: Sequence[int]) -> Sample:
    """Zero-shot inference prompt [SOS][text][TASK][prompt_speech ...]
    (reference cosy_llm.py:217-225)."""
    s = Sample([], [], [])
    s.extend([SOS_EOS], MOD_SPECIAL, [IGNORE])
    s.extend(list(text_ids), MOD_TEXT, [IGNORE] * len(text_ids))
    s.extend([TASK_ID], MOD_SPECIAL, [IGNORE])
    s.extend(list(prompt_speech_tokens), MOD_SPEECH, [IGNORE] * len(prompt_speech_tokens))
    return s


def content_length(text_ids: Sequence[int], end_of_prompt_id: int = 65531) -> int:
    """Length driving the min / max decode bounds; instruction text before
    <|endofprompt|> (id 65531) is excluded (reference cosy_llm.py:201-211)."""
    ids = list(text_ids)
    if end_of_prompt_id in ids:
        return len(ids) - (ids.index(end_of_prompt_id) + 1)
    return len(ids)
