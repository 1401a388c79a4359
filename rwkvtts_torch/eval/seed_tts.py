"""Seed-TTS evaluation (counterpart of rwkvtts_tpu/eval/seed_tts.py): the
synthesis driver over a ``meta.lst`` and the WER computation.

  * ``read_meta_lst`` / ``generate_testset``: rows ``ID|prompt_text|
    prompt_wav|text``, zero-shot synthesis of each into <out>/<lang>/<ID>.wav
    (the reference's eval_seed_generate.py);
  * ``normalize_text``, ``wer``, ``corpus_wer``, ``evaluate_wer``: punctuation
    stripped (zh and en), zh split into characters, en lower-cased and split
    into words, WER = (S + D + I) / N with each class's rate (the
    reference's run_wer.py:31-59; a Levenshtein backtrace, no jiwer);
  * transcription backends, a wav path -> text: ``asr_transcribe_fn`` (the
    port's own RWKV-7 ASR model), ``whisper_transcribe_fn`` (transformers'
    Whisper from a local model directory) and ``default_transcribe_fn``,
    which picks one as the reference's run_wer.py:21-28 does (Whisper for
    en, the own ASR model in place of Paraformer for zh).

The models run on the card unless the caller asks for the CPU: the ASR
model on its parameters' device, Whisper on ``device`` ("cuda" by
default).
"""
from __future__ import annotations

import dataclasses
import os
import string
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from rwkvtts_torch.data import asr_collator
from rwkvtts_torch.models import asr as asr_model
from rwkvtts_torch.utils import audio_io

# CJK punctuation (the zhon.hanzi.punctuation set) and ASCII's
_ZH_PUNCT = (
    "＂＃＄％＆＇（）＊＋，－／：；＜＝＞＠［＼］＾＿｀｛｜｝～｟｠｢｣､　、〃〈〉"
    "《》「」『』【】〔〕〖〗〘〙〚〛〜〝〞〟〰〾〿–—‘’‛“”„‟…‧﹏﹑﹔·！？｡。"
)
PUNCTUATION_ALL = _ZH_PUNCT + string.punctuation


def normalize_text(text: str, lang: str) -> List[str]:
    """run_wer.py:35-51's normalization -> the token list (zh characters,
    en lower-cased words; the apostrophe kept)."""
    for x in PUNCTUATION_ALL:
        if x == "'":
            continue
        text = text.replace(x, "")
    text = text.replace("  ", " ")
    if lang == "zh":
        return [c for c in text if not c.isspace()]
    if lang == "en":
        return text.lower().split()
    raise NotImplementedError(lang)


def edit_ops(ref: Sequence[str], hyp: Sequence[str]) -> Tuple[int, int, int]:
    """(substitutions, deletions, insertions) of a Levenshtein backtrace,
    preferring a substitution or match, then a deletion, then an
    insertion at each step back."""
    n, m = len(ref), len(hyp)
    d = np.zeros((n + 1, m + 1), np.int32)
    d[:, 0] = np.arange(n + 1)
    d[0, :] = np.arange(m + 1)
    for i in range(1, n + 1):
        for j in range(1, m + 1):
            c = 0 if ref[i - 1] == hyp[j - 1] else 1
            d[i, j] = min(d[i - 1, j - 1] + c, d[i - 1, j] + 1, d[i, j - 1] + 1)
    i, j = n, m
    subs = dele = inse = 0
    while i > 0 or j > 0:
        if i > 0 and j > 0 and d[i, j] == d[i - 1, j - 1] + (ref[i - 1] != hyp[j - 1]):
            subs += int(ref[i - 1] != hyp[j - 1])
            i, j = i - 1, j - 1
        elif i > 0 and d[i, j] == d[i - 1, j] + 1:
            dele += 1
            i -= 1
        else:
            inse += 1
            j -= 1
    return subs, dele, inse


@dataclasses.dataclass
class WERResult:
    wer: float
    subs: float
    dele: float
    inse: float
    n_ref: int


def wer(truth: str, hypo: str, lang: str) -> WERResult:
    ref, hyp = normalize_text(truth, lang), normalize_text(hypo, lang)
    s, d, i = edit_ops(ref, hyp)
    n = max(len(ref), 1)
    return WERResult((s + d + i) / n, s / n, d / n, i / n, len(ref))


def corpus_wer(pairs: Sequence[Tuple[str, str]], lang: str) -> WERResult:
    """WER over (truth, hypo) pairs, weighted by the reference tokens."""
    S = D = I = N = 0
    for truth, hypo in pairs:
        ref, hyp = normalize_text(truth, lang), normalize_text(hypo, lang)
        s, d, i = edit_ops(ref, hyp)
        S, D, I, N = S + s, D + d, I + i, N + len(ref)
    n = max(N, 1)
    return WERResult((S + D + I) / n, S / n, D / n, I / n, N)


# ---------------------------------------------------------------------------
# meta.lst driver


@dataclasses.dataclass
class MetaRow:
    utt_id: str
    prompt_text: str
    prompt_wav: str
    text: str


def read_meta_lst(path: str) -> List[MetaRow]:
    rows = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            parts = line.split("|")
            rows.append(MetaRow(parts[0], parts[1], parts[2], parts[3]))
    return rows


def generate_testset(
    pipeline,
    eval_dir: str,
    lang: str,
    output_dir: str,
    list_file: str = "meta.lst",
    max_rows: Optional[int] = None,
    **synth_kw,
) -> List[Tuple[str, str]]:
    """eval_seed_generate: each row of <eval_dir>/<lang>/<list_file>
    synthesized zero-shot from its prompt wav (read at 16 kHz, volume
    normalized) and prompt text by ``pipeline.synthesize`` into
    <output_dir>/<lang>/<ID>.wav. Returns [(utt_id, wav_path)]."""
    out = os.path.join(output_dir, lang)
    os.makedirs(out, exist_ok=True)
    rows = read_meta_lst(os.path.join(eval_dir, lang, list_file))
    if max_rows:
        rows = rows[:max_rows]
    results = []
    for row in rows:
        prompt = audio_io.load_wav(os.path.join(eval_dir, lang, row.prompt_wav), 16000,
                                   volume_normalize=True)
        res = pipeline.synthesize(row.text, prompt_wav=prompt, prompt_text=row.prompt_text,
                                  **synth_kw)
        path = os.path.join(out, f"{row.utt_id}.wav")
        audio_io.save_wav(path, res.wav, res.sample_rate)
        results.append((row.utt_id, path))
    return results


def evaluate_wer(
    wav_text_pairs: Sequence[Tuple[str, str]],
    lang: str,
    transcribe_fn: Callable[[str], str],
) -> Dict[str, float]:
    """run_wer over [(wav_path, truth_text)] with a transcription backend."""
    pairs = [(truth, transcribe_fn(wav)) for wav, truth in wav_text_pairs]
    r = corpus_wer(pairs, lang)
    return {"wer": r.wer, "substitutions": r.subs, "deletions": r.dele,
            "insertions": r.inse, "n_ref_tokens": r.n_ref}


# ---------------------------------------------------------------------------
# Transcription backends


def asr_transcribe_fn(asr_params, asr_cfg, tokenizer, lang: str = "zh",
                      max_new_tokens: int = 128) -> Callable[[str], str]:
    """The repo's own ASR model as a backend (the default zh backend: the
    reference's protocol names Paraformer for zh, run_wer.py:21-28, which
    is not available; the ASR model takes the zh transcription
    instruction natively). Each call collates one wav at the encoder's
    own mel width (the JAX package's collates at 80 mels whatever the
    encoder, so a 128-mel whisper-large-v3 fails there), transcribes it
    greedily on the parameters' device and decodes the tokens before the
    first EOS."""
    n_mels = asr_cfg.whisper.n_mels if asr_cfg.whisper is not None else 80
    device = asr_params["llm"]["head"].device

    def fn(wav_path: str) -> str:
        batch = asr_collator.collate([{"audio": wav_path, "text": "", "language": lang}],
                                     tokenizer, n_mels=n_mels)
        batch = {k: torch.from_numpy(v).to(device) for k, v in batch.items()
                 if k not in ("labels", "labels_mask")}
        toks, lengths = asr_model.transcribe(asr_params, asr_cfg, batch,
                                             max_new_tokens=max_new_tokens)
        n = int(lengths[0])
        return tokenizer.decode([int(t) for t in toks[0, :n].tolist()])

    return fn


def default_transcribe_fn(lang: str, **backends) -> Callable[[str], str]:
    """run_wer.py:21-28's choice: Whisper for en when a model directory is
    given (``whisper_dir``, with ``device``), else the own ASR model
    (``asr_params``, ``asr_cfg``, ``tokenizer``)."""
    if lang == "en" and backends.get("whisper_dir"):
        return whisper_transcribe_fn(backends["whisper_dir"], "en",
                                     device=backends.get("device", "cuda"))
    if backends.get("asr_params") is not None:
        return asr_transcribe_fn(backends["asr_params"], backends["asr_cfg"],
                                 backends["tokenizer"], lang=lang)
    raise ValueError(f"no transcription backend for lang={lang!r}: pass whisper_dir (en) or "
                     "asr_params/asr_cfg/tokenizer (own-ASR backend)")


def whisper_transcribe_fn(model_dir: str, lang: str = "en",
                          device="cuda") -> Callable[[str], str]:
    """transformers' Whisper from a local model directory (the processor's
    and the model's files; nothing is downloaded) on `device`: each call
    reads the wav at 16 kHz, generates in `lang` and decodes without the
    special tokens."""
    from transformers import WhisperForConditionalGeneration, WhisperProcessor

    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("whisper_transcribe_fn: no CUDA device; pass device='cpu'")
    processor = WhisperProcessor.from_pretrained(model_dir, local_files_only=True)
    model = WhisperForConditionalGeneration.from_pretrained(
        model_dir, local_files_only=True).to(device).eval()

    def fn(wav_path: str) -> str:
        wav = audio_io.load_wav(wav_path, 16000)
        inputs = processor(wav, sampling_rate=16000, return_tensors="pt")
        with torch.no_grad():
            ids = model.generate(inputs.input_features.to(device), language=lang)
        return processor.batch_decode(ids.cpu(), skip_special_tokens=True)[0]

    return fn
