"""Seed-TTS evaluation (counterpart of rwkvtts_tpu/eval/seed_tts.py): so
far only ``asr_transcribe_fn``, the port's own RWKV-7 ASR model as a
transcription backend (a wav path -> text)."""
from __future__ import annotations

from typing import Callable

import torch

from rwkvtts_torch.data import asr_collator
from rwkvtts_torch.models import asr as asr_model


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
