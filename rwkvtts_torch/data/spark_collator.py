"""Spark-TTS prompt-layout collators, token domain (a copy of
rwkvtts_tpu/data/spark_collator.py).

Layout: [TAG2][text][TAG0][global x 32][TAG1][semantic ...][EOS]; labels
are -100 over the prefix, then the semantic tokens and EOS. The
properties collator adds, for each row, an SPCT-prefixed copy whose labels
also cover the global tokens (voice design); the global-token collator
keeps only [SPCT props][TAG0][global x 32][TAG1] and labels the globals
(reference utils/multiple_jsonl.py:139-233, 313-400). Padded, every
sample is a row padded to ``pad_to``; packed, all samples of a batch share
one row and each starts with a reset flag. The model does the table
lookups from the (tokens, modality) pairs (models/spark.py embed_layout).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

import numpy as np

from rwkvtts_torch.data import text_frontend
from rwkvtts_torch.data.properties import properties_string
from rwkvtts_torch.models.spark import (
    MOD_GLOBAL,
    MOD_PAD,
    MOD_SEMANTIC,
    MOD_TAG,
    MOD_TEXT,
    TAG_GLOBAL,
    TAG_SEMANTIC,
    TAG_START_TTS,
)

IGNORE = -100


@dataclasses.dataclass
class Sample:
    """One token-domain sample: parallel (tokens, modality, labels) lists."""

    tokens: List[int]
    modality: List[int]
    labels: List[int]

    def __len__(self):
        return len(self.tokens)

    def extend(self, toks, mod, labs):
        self.tokens.extend(toks)
        self.modality.extend([mod] * len(toks))
        self.labels.extend(labs)
        return self


def _spark_core(
    text_ids: Sequence[int],
    global_tokens: Sequence[int],
    semantic_tokens: Sequence[int],
    eos_id: int,
    *,
    label_globals: bool = False,
    label_semantics: bool = True,
) -> Sample:
    s = Sample([], [], [])
    s.extend([TAG_START_TTS], MOD_TAG, [IGNORE])
    s.extend(list(text_ids), MOD_TEXT, [IGNORE] * len(text_ids))
    s.extend([TAG_GLOBAL], MOD_TAG, [IGNORE])
    g_labels = list(global_tokens) if label_globals else [IGNORE] * len(global_tokens)
    s.extend(list(global_tokens), MOD_GLOBAL, g_labels)
    s.extend([TAG_SEMANTIC], MOD_TAG, [IGNORE])
    sem = list(semantic_tokens) + [eos_id]
    s.extend(sem, MOD_SEMANTIC, sem if label_semantics else [IGNORE] * len(sem))
    return s


def pad_batch(samples: Sequence[Sample], pad_to: Optional[int] = None,
              pad_multiple: int = 64) -> Dict[str, np.ndarray]:
    B = len(samples)
    maxlen = max(len(s) for s in samples)
    if pad_to is None:
        pad_to = -(-maxlen // pad_multiple) * pad_multiple
    if pad_to < maxlen:
        raise ValueError(f"a sample of {maxlen} tokens does not fit pad_to={pad_to}")
    tokens = np.zeros((B, pad_to), dtype=np.int32)
    modality = np.full((B, pad_to), MOD_PAD, dtype=np.int32)
    labels = np.full((B, pad_to), IGNORE, dtype=np.int32)
    mask = np.zeros((B, pad_to), dtype=np.int32)
    for i, s in enumerate(samples):
        n = len(s)
        tokens[i, :n] = s.tokens
        modality[i, :n] = s.modality
        labels[i, :n] = s.labels
        mask[i, :n] = 1
    return {"tokens": tokens, "modality": modality, "labels": labels,
            "attention_mask": mask}


def pack_batch(samples: Sequence[Sample], pad_to: Optional[int] = None,
               pad_multiple: int = 64) -> Dict[str, np.ndarray]:
    """All samples in one row with segment resets (cu_seqlens packing as
    reset flags). A segment's first label is IGNORE by construction, so
    the shifted loss never predicts across a segment boundary."""
    total = sum(len(s) for s in samples)
    if pad_to is None:
        pad_to = -(-total // pad_multiple) * pad_multiple
    if pad_to < total:
        raise ValueError(f"a packed row of {total} tokens does not fit pad_to={pad_to}")
    tokens = np.zeros((1, pad_to), dtype=np.int32)
    modality = np.full((1, pad_to), MOD_PAD, dtype=np.int32)
    labels = np.full((1, pad_to), IGNORE, dtype=np.int32)
    mask = np.zeros((1, pad_to), dtype=np.int32)
    resets = np.zeros((1, pad_to), dtype=bool)
    off = 0
    for s in samples:
        n = len(s)
        tokens[0, off:off + n] = s.tokens
        modality[0, off:off + n] = s.modality
        labels[0, off:off + n] = s.labels
        mask[0, off:off + n] = 1
        resets[0, off] = True
        off += n
    return {"tokens": tokens, "modality": modality, "labels": labels,
            "attention_mask": mask, "resets": resets}


def collate_plain(rows, tokenizer, eos_id: int, pad_to=None, packed=False):
    """Rows {text, global_tokens, semantic_tokens} -> a padded or packed
    batch of numpy arrays."""
    samples = [
        _spark_core(tokenizer.encode(r["text"]), r["global_tokens"], r["semantic_tokens"],
                    eos_id)
        for r in rows
    ]
    return pack_batch(samples, pad_to) if packed else pad_batch(samples, pad_to)


def _props_prefix(row, tokenizer) -> Sample:
    """The row's SPCT property string as unlabelled text."""
    props = properties_string(row["age"], row["gender"], row["emotion"], row["pitch"],
                              row["speed"])
    prop_ids = tokenizer.encode(props)
    return Sample([], [], []).extend(prop_ids, MOD_TEXT, [IGNORE] * len(prop_ids))


def collate_with_properties(rows, tokenizer, eos_id: int, pad_to=None, packed=False,
                            mark_phonemes_prob: float = 0.0, rng=None,
                            mark_phonemes_strict: bool = True):
    """Two samples a row: the plain one, and the SPCT-prefixed one whose
    labels also cover the 32 global tokens. Rows also carry age, gender,
    emotion, pitch and speed. The tokenizer must know the 64 SPCT tokens
    (``get_world_tokenizer(n_spct=64)``).

    ``mark_phonemes_prob`` > 0 is the reference's pronunciation-controllable
    fine-tune: with that probability a row's text is marked by
    ``text_frontend.mark_phonemes`` before it is tokenized, both draws from
    `rng`, a ``random.Random`` that the caller keeps across batches (the
    JAX collator falls back to a module-level ``Random(0)``; here it is
    required). Strict by default: a zh character outside the pinyin table
    raises rather than train on a non-pronunciation."""
    if mark_phonemes_prob > 0 and rng is None:
        raise ValueError("collate_with_properties: mark_phonemes_prob > 0 needs rng, "
                         "a random.Random")
    samples: List[Sample] = []
    for r in rows:
        text = r["text"]
        if mark_phonemes_prob > 0 and rng.random() < mark_phonemes_prob:
            text = text_frontend.mark_phonemes(text, rng=rng, strict=mark_phonemes_strict)
        text_ids = tokenizer.encode(text)
        samples.append(_spark_core(text_ids, r["global_tokens"], r["semantic_tokens"], eos_id))
        s = _props_prefix(r, tokenizer)
        core = _spark_core(text_ids, r["global_tokens"], r["semantic_tokens"], eos_id,
                           label_globals=True)
        s.tokens += core.tokens
        s.modality += core.modality
        s.labels += core.labels
        samples.append(s)
    return pack_batch(samples, pad_to) if packed else pad_batch(samples, pad_to)


def collate_global_tokens(rows, tokenizer, eos_id: int, pad_to=None, packed=False):
    """The voice designer: predict only the 32 global (speaker) tokens from
    the SPCT property prefix. `eos_id` is unused (no semantic part); it is
    taken for the collators' common signature."""
    samples: List[Sample] = []
    for r in rows:
        s = _props_prefix(r, tokenizer)
        s.extend([TAG_GLOBAL], MOD_TAG, [IGNORE])
        s.extend(list(r["global_tokens"]), MOD_GLOBAL, list(r["global_tokens"]))
        s.extend([TAG_SEMANTIC], MOD_TAG, [IGNORE])
        samples.append(s)
    return pack_batch(samples, pad_to) if packed else pad_batch(samples, pad_to)


def build_prompt(
    text_ids: Sequence[int],
    global_tokens: Sequence[int],
    *,
    prompt_semantic_tokens: Sequence[int] = (),
    properties: Optional[str] = None,
    tokenizer=None,
) -> Sample:
    """Inference prompt [props?][TAG2][text][TAG0][global][TAG1][prompt_sem...]:
    decoding continues after the prompt's semantic tokens."""
    s = Sample([], [], [])
    if properties is not None:
        prop_ids = tokenizer.encode(properties)
        s.extend(prop_ids, MOD_TEXT, [IGNORE] * len(prop_ids))
    s.extend([TAG_START_TTS], MOD_TAG, [IGNORE])
    s.extend(list(text_ids), MOD_TEXT, [IGNORE] * len(text_ids))
    s.extend([TAG_GLOBAL], MOD_TAG, [IGNORE])
    s.extend(list(global_tokens), MOD_GLOBAL, [IGNORE] * len(global_tokens))
    s.extend([TAG_SEMANTIC], MOD_TAG, [IGNORE])
    if prompt_semantic_tokens:
        s.extend(list(prompt_semantic_tokens), MOD_SEMANTIC,
                 [IGNORE] * len(prompt_semantic_tokens))
    return s


def pad_prompts_left(samples: Sequence[Sample], pad_to: Optional[int] = None,
                     pad_multiple: int = 16) -> Dict[str, np.ndarray]:
    """Left-pad prompts for generation (leading pads only decay a zero
    state) to `pad_to`, or to the longest rounded up to `pad_multiple`."""
    if pad_to is None:
        pad_to = -(-max(len(s) for s in samples) // pad_multiple) * pad_multiple
    B = len(samples)
    tokens = np.zeros((B, pad_to), dtype=np.int32)
    modality = np.full((B, pad_to), MOD_PAD, dtype=np.int32)
    mask = np.zeros((B, pad_to), dtype=np.int32)
    for i, s in enumerate(samples):
        n = len(s)
        tokens[i, pad_to - n:] = s.tokens
        modality[i, pad_to - n:] = s.modality
        mask[i, pad_to - n:] = 1
    return {"tokens": tokens, "modality": modality, "attention_mask": mask}
