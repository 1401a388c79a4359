"""CosyVoice prompt layout, token domain (a copy of
rwkvtts_tpu/data/cosy_collator.py; reference data/utils/llm_dataset.py:118-187
and cosy_llm.py:89-121).

Training rows {text, prompt_text, tts_speech_tokens,
llm_prompt_speech_token} become [SOS][prompt_text + text][TASK][prompt
speech + speech] with labels aligned to the positions (pre-shifted): -100
over [SOS][text], speech[0] at TASK, ..., EOS (6561) at the last speech
token. With probability ``drop_prompt_audio_rate`` the whole batch drops
its prompt text and speech (one coin a batch, as the reference). The coin
comes from the caller's numpy generator: the JAX collator falls back to a
fresh unseeded one on every call, which no run can reproduce.

The zero-shot prompt is [SOS][text][TASK][prompt speech ...]; decoding
continues with speech tokens. The content length, which bounds the decode
length, leaves out instruction text before <|endofprompt|>.
"""
from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np

from rwkvtts_torch.data.spark_collator import IGNORE, Sample, pack_batch, pad_batch
from rwkvtts_torch.models.cosy import MOD_SPECIAL, MOD_SPEECH, MOD_TEXT, SOS_EOS, TASK_ID


def make_sample(text_ids: Sequence[int], speech_tokens: Sequence[int], eos_id: int) -> Sample:
    """[SOS][text][TASK][speech] with position t labelled by the token it
    predicts: TASK -> speech[0], speech[i] -> speech[i + 1], the last ->
    EOS; everything before TASK -100."""
    speech = list(speech_tokens)
    s = Sample([], [], [])
    s.extend([SOS_EOS], MOD_SPECIAL, [IGNORE])
    s.extend(list(text_ids), MOD_TEXT, [IGNORE] * len(text_ids))
    s.extend([TASK_ID], MOD_SPECIAL, [speech[0]] if speech else [eos_id])
    if speech:
        s.extend(speech, MOD_SPEECH, speech[1:] + [eos_id])
    return s


def collate(rows, tokenizer, eos_id: int, *, rng: np.random.Generator,
            drop_prompt_audio_rate: float = -0.1, pad_to=None,
            packed: bool = False) -> Dict[str, np.ndarray]:
    """Rows -> a padded or packed batch; one draw of `rng` decides whether
    the batch drops its prompts (never at the default rate)."""
    drop = rng.random() < drop_prompt_audio_rate
    samples: List[Sample] = []
    for r in rows:
        if drop:
            text_ids = tokenizer.encode(r["text"])
            speech = list(r["tts_speech_tokens"])
        else:
            text_ids = tokenizer.encode(r.get("prompt_text", "")) + tokenizer.encode(r["text"])
            speech = list(r.get("llm_prompt_speech_token", [])) + list(r["tts_speech_tokens"])
        samples.append(make_sample(text_ids, speech, eos_id))
    return pack_batch(samples, pad_to) if packed else pad_batch(samples, pad_to)


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
