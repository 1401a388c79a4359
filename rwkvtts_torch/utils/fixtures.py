"""Fixtures: golden fixtures (a copy of the reader half of
rwkvtts_tpu/utils/fixtures.py): a fixture under tests/goldens holds a
state dict's shape table, a seed and the reference's inputs and outputs;
the weights are regenerated from (shapes, seed), the same bytes the
capture fed the reference. And ``write_tiny_whisper``, a tiny saved
Whisper model for the seed-tts eval's Whisper backend."""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np


def synth_state_dict(shapes: Dict[str, tuple], seed: int) -> Dict[str, np.ndarray]:
    """A deterministic state dict in the reference's key layout: norm
    scales, weight-norm magnitudes and snake alphas near 1, running
    variances positive, the rest small normals; one generator over the
    sorted keys."""
    rng = np.random.default_rng(seed)
    out: Dict[str, np.ndarray] = {}
    for k in sorted(shapes):
        shp = tuple(int(x) for x in shapes[k])
        if k.endswith("num_batches_tracked"):
            out[k] = np.zeros(shp, np.int64)
        elif k.endswith("running_var"):
            out[k] = np.clip(1.0 + 0.1 * rng.standard_normal(shp), 0.5, None).astype(np.float32)
        elif k.endswith("running_mean"):
            out[k] = (0.1 * rng.standard_normal(shp)).astype(np.float32)
        elif (k.endswith("weight_g") or k.endswith("alpha")
              or (k.endswith(".weight") and len(shp) == 1)):
            out[k] = (1.0 + 0.1 * rng.standard_normal(shp)).astype(np.float32)
        else:
            out[k] = (0.1 * rng.standard_normal(shp)).astype(np.float32)
    return out


def load_golden(path: str) -> Tuple[Dict[str, np.ndarray], Dict[str, np.ndarray]]:
    """(the synthetic state dict, {io name: array}) of a golden fixture."""
    z = np.load(path)
    shapes = {k[len("shape/"):]: tuple(z[k].tolist()) for k in z.files if k.startswith("shape/")}
    io = {k[len("io/"):]: z[k] for k in z.files if k.startswith("io/")}
    return synth_state_dict(shapes, int(z["meta/seed"])), io


def _bytes_to_unicode() -> Dict[int, str]:
    """GPT-2's byte -> printable character table of byte-level BPE."""
    bs = (list(range(ord("!"), ord("~") + 1)) + list(range(ord("¡"), ord("¬") + 1))
          + list(range(ord("®"), ord("ÿ") + 1)))
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, map(chr, cs)))


def write_tiny_whisper(model_dir: str, seed: int = 0) -> str:
    """A tiny transformers Whisper model directory, random weights from
    `seed`: a byte-level BPE vocabulary of the 256 byte symbols (no merges)
    and Whisper's special tokens (<|en|>, <|zh|>, the task and timestamp
    tokens), written as the tokenizer's plain files (vocab.json,
    merges.txt, its config), the 80-bin feature extractor, one 16-wide
    encoder and decoder layer, and a generation config that knows the
    language and task tokens. What ``eval/seed_tts.whisper_transcribe_fn``
    reads; the published whisper-large-v3 directory is not in the
    repository."""
    import json
    import os

    import torch
    from transformers import (GenerationConfig, WhisperConfig, WhisperFeatureExtractor,
                              WhisperForConditionalGeneration)

    os.makedirs(model_dir, exist_ok=True)
    specials = ["<|endoftext|>", "<|startoftranscript|>", "<|en|>", "<|zh|>", "<|translate|>",
                "<|transcribe|>", "<|startoflm|>", "<|startofprev|>", "<|nocaptions|>",
                "<|notimestamps|>"]
    vocab = {ch: i for i, ch in enumerate(_bytes_to_unicode().values())}
    for s in specials:
        vocab[s] = len(vocab)
    eot = vocab["<|endoftext|>"]
    files = {
        "vocab.json": vocab,
        "tokenizer_config.json": {
            "tokenizer_class": "WhisperTokenizer", "model_max_length": 1024,
            "errors": "replace", "add_prefix_space": False, "bos_token": specials[0],
            "eos_token": specials[0], "unk_token": specials[0], "pad_token": specials[0],
            "additional_special_tokens": specials[1:],
            "added_tokens_decoder": {str(vocab[s]): {
                "content": s, "lstrip": False, "rstrip": False, "normalized": False,
                "single_word": False, "special": True} for s in specials}},
        "special_tokens_map.json": {
            "bos_token": specials[0], "eos_token": specials[0], "unk_token": specials[0],
            "pad_token": specials[0], "additional_special_tokens": specials[1:]},
    }
    for name, obj in files.items():
        with open(os.path.join(model_dir, name), "w", encoding="utf-8") as f:
            json.dump(obj, f, ensure_ascii=False)
    with open(os.path.join(model_dir, "merges.txt"), "w") as f:
        f.write("#version: 0.2\n")
    WhisperFeatureExtractor(feature_size=80).save_pretrained(model_dir)
    cfg = WhisperConfig(vocab_size=len(vocab), num_mel_bins=80, d_model=16, encoder_layers=1,
                        decoder_layers=1, encoder_attention_heads=2, decoder_attention_heads=2,
                        encoder_ffn_dim=32, decoder_ffn_dim=32, max_source_positions=1500,
                        max_target_positions=32, pad_token_id=eot, bos_token_id=eot,
                        eos_token_id=eot, decoder_start_token_id=vocab["<|startoftranscript|>"])
    torch.manual_seed(seed)
    model = WhisperForConditionalGeneration(cfg).eval()
    model.generation_config = GenerationConfig(
        decoder_start_token_id=vocab["<|startoftranscript|>"], eos_token_id=eot,
        pad_token_id=eot, bos_token_id=eot, max_length=12, is_multilingual=True,
        lang_to_id={"<|en|>": vocab["<|en|>"], "<|zh|>": vocab["<|zh|>"]},
        task_to_id={"transcribe": vocab["<|transcribe|>"], "translate": vocab["<|translate|>"]},
        no_timestamps_token_id=vocab["<|notimestamps|>"], begin_suppress_tokens=[],
        suppress_tokens=[])
    model.save_pretrained(model_dir)
    return model_dir
