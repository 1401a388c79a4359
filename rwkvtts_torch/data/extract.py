"""Offline token extraction: audio corpora -> training JSONL (counterpart of
rwkvtts_tpu/data/extract.py, on the port's codecs).

The reference's scripts these follow:
  * BiCodec (Spark): utils/extract_tar_tokens.py, rows {text,
    global_tokens, semantic_tokens [, age / gender / emotion / pitch /
    speed]};
  * XY_Tokenizer: utils/extract_xy_tokens.py, rows {text, audio_tokens};
  * Higgs: utils/extract_higgs_tokens.py, the same rows;
  * one worker per shard (run_multiple_process.sh): ``run_sharded``, a
    process pool over shards.

Extractors take an iterator of samples ({audio (float32, 16 kHz), text,
...}: ``data/webdataset``, a directory of wavs, jsonl rows with paths) and
append JSONL rows. The codecs run on their parameters' device: the card
unless the caller built them on the CPU. XY and Higgs take batches padded
to `max_seconds` (the JAX package's padding, mel mask and row cuts).
"""
from __future__ import annotations

import json
import logging
import os
from typing import Any, Callable, Dict, Iterable, Iterator, List, Optional, Sequence

import numpy as np
import torch

log = logging.getLogger("rwkvtts_torch")


def _batched(it: Iterable, n: int) -> Iterator[List]:
    buf: List = []
    for x in it:
        buf.append(x)
        if len(buf) == n:
            yield buf
            buf = []
    if buf:
        yield buf


def _padded(batch: Sequence[Dict[str, Any]], T_max: int):
    """The batch's wavs cut to T_max samples and zero-padded to it, and
    their lengths."""
    wavs = np.zeros((len(batch), T_max), np.float32)
    lens = []
    for i, s in enumerate(batch):
        w = np.asarray(s["audio"], np.float32)[:T_max]
        wavs[i, : len(w)] = w
        lens.append(len(w))
    return wavs, lens


def _write_code_rows(f, batch, codes: np.ndarray, lens: Sequence[int], per_code: int) -> int:
    for i, s in enumerate(batch):
        T_codes = max(lens[i] // per_code, 1)
        row = {"text": s.get("text", ""), "audio_tokens": codes[:, i, :T_codes].tolist()}
        f.write(json.dumps(row, ensure_ascii=False) + "\n")
    return len(batch)


def extract_spark_tokens(
    samples: Iterable[Dict[str, Any]],
    audio_tokenizer,  # codecs.spark_tokenizer.SparkAudioTokenizer
    out_path: str,
    properties_fn: Optional[Callable[[Dict[str, Any]], Dict[str, Any]]] = None,
) -> int:
    """BiCodec tokenization, one sample at a time -> JSONL rows {text,
    global_tokens, semantic_tokens, <properties...>}."""
    n = 0
    with open(out_path, "a") as f:
        for s in samples:
            glob, sem = audio_tokenizer.tokenize(np.asarray(s["audio"], np.float32))
            row = {"text": s.get("text", ""), "global_tokens": glob.reshape(-1).tolist(),
                   "semantic_tokens": sem.reshape(-1).tolist()}
            if properties_fn is not None:
                row.update(properties_fn(s))
            f.write(json.dumps(row, ensure_ascii=False) + "\n")
            n += 1
    return n


def extract_xy_tokens(
    samples: Iterable[Dict[str, Any]],
    codec_cfg,
    codec_params,
    out_path: str,
    batch_size: int = 8,
    max_seconds: float = 30.0,
    sample_rate: int = 16000,
) -> int:
    """XY_Tokenizer encode in batches padded to `max_seconds` -> JSONL rows
    {text, audio_tokens (nq, T)}, a row's codes cut to its length // 1280
    (12.5 Hz)."""
    from rwkvtts_torch.codecs import xy_tokenizer as xt

    dev = xt._device(codec_params)
    n = 0
    with open(out_path, "a") as f:
        for batch in _batched(samples, batch_size):
            wavs, lens = _padded(batch, int(max_seconds * sample_rate))
            with torch.inference_mode():
                mel = xt.whisper_log_mel(torch.from_numpy(wavs).to(dev), n_mels=codec_cfg.n_mels)
                mel_mask = (np.arange(mel.shape[1])[None, :]
                            < (np.asarray(lens)[:, None] // 160)).astype(np.float32)
                codes = xt.encode(codec_params, codec_cfg, mel,
                                  torch.from_numpy(mel_mask).to(dev)).cpu().numpy()
            n += _write_code_rows(f, batch, codes, lens, 160 * 8)
    return n


def extract_cosy_tokens(
    samples: Iterable[Dict[str, Any]],
    speech_tokenizer_fn: Callable[[np.ndarray], Sequence[int]],
    out_path: str,
    instruction_fn: Optional[Callable[[str], str]] = None,
) -> int:
    """S3 speech tokens -> JSONL rows for the Cosy LM trainer {text,
    tts_speech_tokens, prompt_text, llm_prompt_speech_token}.
    speech_tokenizer_fn: wav -> ids (the port's ``s3_tokenizer.tokenize``
    or any callable); instruction_fn: a text augmenter for instruct rows
    (``data.instructions.make_instruction_fn(lang)``)."""
    n = 0
    with open(out_path, "a") as f:
        for s in samples:
            tokens = list(map(int, speech_tokenizer_fn(np.asarray(s["audio"], np.float32))))
            text = s.get("text", "")
            if instruction_fn is not None:
                text = instruction_fn(text)
            row = {"text": text, "tts_speech_tokens": tokens,
                   "prompt_text": s.get("prompt_text", ""),
                   "llm_prompt_speech_token": s.get("llm_prompt_speech_token", [])}
            f.write(json.dumps(row, ensure_ascii=False) + "\n")
            n += 1
    return n


def extract_higgs_tokens(
    samples: Iterable[Dict[str, Any]],
    codec_cfg,
    codec_params,
    hubert_fn: Callable[[np.ndarray], Any],
    out_path: str,
    batch_size: int = 4,
    max_seconds: float = 30.0,
    sample_rate: int = 16000,
) -> int:
    """Higgs tokenization in batches padded to `max_seconds` -> JSONL rows
    {text, audio_tokens (nq, T)}, a row's codes cut to its length // hop.
    hubert_fn: (B, T_wav) -> (B, T50, 768), the semantic teacher
    (``codecs.higgs.hubert_feature_fn``)."""
    from rwkvtts_torch.codecs import higgs

    dev = codec_params["fc_prior"]["w"].device
    n = 0
    with open(out_path, "a") as f:
        for batch in _batched(samples, batch_size):
            wavs, lens = _padded(batch, int(max_seconds * sample_rate))
            with torch.inference_mode():
                feats = torch.as_tensor(hubert_fn(wavs)).to(dev, torch.float32)
                codes = higgs.encode(codec_params, codec_cfg, torch.from_numpy(wavs).to(dev),
                                     feats).cpu().numpy()
            n += _write_code_rows(f, batch, codes, lens, codec_cfg.hop_length)
    return n


# the codecs SparkTarWorker read in this process, by (model dir, device): a
# pool sends each job its own copy of the worker
_WORKER_CODECS: Dict[tuple, Any] = {}


class SparkTarWorker:
    """A ``run_sharded`` worker: BiCodec rows of one tar shard, the codec
    read from a Spark-TTS model directory once in each worker process, on
    `device`; `properties` names the sample fields copied into each row. A
    module-level class, so spawned workers can unpickle it."""

    def __init__(self, codec_dir: str, device: str = "cuda", properties: Sequence[str] = ()):
        self.codec_dir, self.device, self.properties = codec_dir, device, tuple(properties)

    def __call__(self, shard_path: str, out_path: str) -> int:
        from rwkvtts_torch.codecs.spark_tokenizer import SparkAudioTokenizer
        from rwkvtts_torch.data.webdataset import iter_tar_samples

        key = (self.codec_dir, self.device)
        if key not in _WORKER_CODECS:
            _WORKER_CODECS[key] = SparkAudioTokenizer.from_pretrained(self.codec_dir,
                                                                      device=self.device)
        props = ((lambda s: {k: s[k] for k in self.properties if k in s})
                 if self.properties else None)
        return extract_spark_tokens(iter_tar_samples(shard_path), _WORKER_CODECS[key], out_path,
                                    props)


def run_sharded(
    shard_paths: Sequence[str],
    worker_fn: Callable[[str, str], int],
    out_dir: str,
    num_workers: int = 1,
) -> int:
    """One worker per shard (run_multiple_process.sh): worker_fn(shard_path,
    out_path) -> row count, out_path <out_dir>/<shard basename>.jsonl. With
    num_workers > 1 the workers are processes of the ``spawn`` context:
    each owns its own CUDA context, and worker_fn must be importable (a
    module-level function or an instance of a module-level class, such as
    ``SparkTarWorker``), not a closure."""
    os.makedirs(out_dir, exist_ok=True)
    jobs = [(p, os.path.join(out_dir, os.path.basename(p) + ".jsonl")) for p in shard_paths]
    if num_workers <= 1:
        return sum(worker_fn(p, o) for p, o in jobs)
    import multiprocessing as mp

    with mp.get_context("spawn").Pool(num_workers) as pool:
        counts = pool.starmap(worker_fn, jobs)
    return sum(counts)
