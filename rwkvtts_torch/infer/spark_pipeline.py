"""Spark TTS pipeline: text (+ a zero-shot prompt wav, or SPCT voice
properties, or explicit global tokens) -> wav (counterpart of
rwkvtts_tpu/infer/spark_pipeline.py).

``synthesize``: the prompt [TAG2 | text | TAG0 | global | TAG1 | prompt
semantics] (codec ``tokenize`` of a prompt wav, or a designed voice),
chunked early-exit generation through the model's decode step (the
prefill's WKV7 kernel and the WKV step kernel on a card), then BiCodec
``detokenize`` per row. ``design_voice``: SPCT properties -> 32 global
tokens through the global-token head. The decode weights are
``rwkv7.pack_decode_params``'s: fused projections, in bf16 or as int8 /
int4 (``quantize_int8`` / ``quantize_int4``). Not ported: speculative
decoding (``spec_k``).

Everything runs on the device of the LM parameters (a CUDA device unless
the caller built them on the CPU) and of the codec.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, List, Optional, Sequence, Union

import numpy as np
import torch

from rwkvtts_torch.data import spark_collator
from rwkvtts_torch.data.properties import properties_string
from rwkvtts_torch.infer import generate as gen
from rwkvtts_torch.models import rwkv7
from rwkvtts_torch.models import spark as spark_model


@dataclasses.dataclass
class SparkTTSResult:
    wav: np.ndarray
    sample_rate: int
    semantic_tokens: np.ndarray
    global_tokens: np.ndarray
    prefill_s: float
    decode_s: float
    tokens_per_s: float


def _properties_string(properties: Dict[str, Any]) -> str:
    return properties_string(
        properties.get("age", "youth-adult"), properties.get("gender", "female"),
        properties.get("emotion", "NEUTRAL"), properties.get("pitch", "medium_pitch"),
        properties.get("speed", "medium"))


class SparkPipeline:
    def __init__(
        self,
        lm_cfg,
        lm_params,
        text_tokenizer,
        audio_tokenizer=None,  # codecs.spark_tokenizer.SparkAudioTokenizer
        sample_rate: int = 16000,
        prompt_pad_multiple: int = 64,
        quantize_int8: bool = False,
        quantize_int4: bool = False,
        spec_k: int = 0,
        fuse_projections: bool = True,
    ):
        if spec_k:
            raise NotImplementedError("speculative decoding (spec_k) is not ported yet")
        self.cfg = lm_cfg
        # fused decode projections; int8 / int4 decode weights on request.
        # Without fused projections (another engine owns decode, e.g. the
        # B=64 pool) the raw weights are all there is.
        self.params = rwkv7.pack_decode_params(
            lm_params, lm_cfg.backbone, quantize_int8=quantize_int8,
            quantize_int4=quantize_int4, fuse_projections=fuse_projections,
        )
        self.device = self.params["head"].device
        self.tok = text_tokenizer
        self.codec = audio_tokenizer
        self.sample_rate = sample_rate
        # prompts pad to a multiple of this, so the prefill sees few widths
        self.prompt_pad_multiple = prompt_pad_multiple

    def _prompt_batch(
        self,
        texts: Sequence[str],
        global_tokens: Sequence[Sequence[int]],
        prompt_semantics: Sequence[Sequence[int]],
        properties: Sequence[Optional[str]],
        pad_to: Optional[int] = None,
    ) -> Dict[str, np.ndarray]:
        samples = [
            spark_collator.build_prompt(self.tok.encode(t), g, prompt_semantic_tokens=s,
                                        properties=p, tokenizer=self.tok)
            for t, g, s, p in zip(texts, global_tokens, prompt_semantics, properties)
        ]
        return spark_collator.pad_prompts_left(samples, pad_to=pad_to,
                                               pad_multiple=self.prompt_pad_multiple)

    def _on_device(self, batch: Dict[str, np.ndarray]):
        return (torch.from_numpy(np.asarray(batch[k])).to(self.device)
                for k in ("tokens", "modality", "attention_mask"))

    def _generator(self, seed: int) -> torch.Generator:
        return torch.Generator(device=self.device).manual_seed(seed)

    def synthesize(
        self,
        text: Union[str, Sequence[str]],
        prompt_wav=None,
        prompt_text: Optional[str] = None,
        properties: Optional[Dict[str, Any]] = None,
        global_tokens: Optional[Sequence[int]] = None,
        max_new_tokens: int = 1024,
        temperature: float = 1.0,
        top_k: int = 50,
        top_p: float = 0.95,
        seed: int = 0,
        pad_to: Optional[int] = None,
        noise: Optional[torch.Tensor] = None,
        design_noise: Optional[torch.Tensor] = None,
    ) -> Union[SparkTTSResult, List[SparkTTSResult]]:
        """Zero-shot (prompt_wav [+ prompt_text]) or voice-controlled
        (properties, designed with design_voice's defaults and seed 0, or
        explicit global_tokens) synthesis of one text or a batch. Draws
        come from a generator seeded with `seed`, or from `noise`
        (max_new_tokens, B, width) and `design_noise` (see
        infer/generate.py)."""
        texts = [text] if isinstance(text, str) else list(text)
        B = len(texts)
        prompt_sem: List[List[int]] = [[] for _ in texts]
        if prompt_wav is not None:
            if self.codec is None:
                raise RuntimeError("audio tokenizer required for prompt_wav")
            glob, sem = self.codec.tokenize(prompt_wav)
            globals_ = [glob.reshape(-1).tolist()] * B
            if prompt_text is not None:
                texts = [prompt_text + t for t in texts]
                prompt_sem = [sem.reshape(-1).tolist()] * B
        elif global_tokens is not None:
            globals_ = [list(global_tokens)] * B
        elif properties is not None:
            globals_ = [self.design_voice(properties, noise=design_noise)] * B
        else:
            raise ValueError("need prompt_wav, global_tokens, or properties")
        props = None if properties is None else _properties_string(properties)
        batch = self._prompt_batch(texts, globals_, prompt_sem, [props] * B, pad_to=pad_to)

        t0 = time.perf_counter()
        toks, lengths = gen.spark_generate_early_exit(
            self.params, self.cfg, *self._on_device(batch), max_new_tokens=max_new_tokens,
            temperature=temperature, top_k=top_k, top_p=top_p, noise=noise,
            generator=None if noise is not None else self._generator(seed))
        toks, lengths = toks.numpy(), lengths.numpy()
        t1 = time.perf_counter()
        wavs = [np.zeros(0, np.float32)] * B
        if self.codec is not None:
            wavs = self.codec.detokenize_rows(np.asarray(globals_, np.int64)[:, None], toks,
                                              lengths)
        t2 = time.perf_counter()
        total = int(lengths.sum())
        results = [SparkTTSResult(wav=wavs[i], sample_rate=self.sample_rate,
                                  semantic_tokens=toks[i, :lengths[i]],
                                  global_tokens=np.asarray(globals_[i]), prefill_s=t1 - t0,
                                  decode_s=t2 - t1, tokens_per_s=total / max(t1 - t0, 1e-9))
                   for i in range(B)]
        return results[0] if isinstance(text, str) else results

    def design_voice(
        self,
        properties: Dict[str, Any],
        temperature: float = 1.0,
        top_k: int = 50,
        top_p: float = 0.95,
        seed: int = 0,
        noise: Optional[torch.Tensor] = None,
    ) -> List[int]:
        """The voice designer: SPCT properties -> 32 global tokens drawn
        through the global-token head."""
        prop_ids = self.tok.encode(_properties_string(properties))
        s = spark_collator.Sample([], [], [])
        s.extend(prop_ids, spark_model.MOD_TEXT, [spark_collator.IGNORE] * len(prop_ids))
        s.extend([spark_model.TAG_GLOBAL], spark_model.MOD_TAG, [spark_collator.IGNORE])
        batch = spark_collator.pad_prompts_left([s])
        toks, _ = gen.spark_global_generate(
            self.params, self.cfg, *self._on_device(batch), num_tokens=32,
            temperature=temperature, top_k=top_k, top_p=top_p, noise=noise,
            generator=None if noise is not None else self._generator(seed))
        return toks[0].tolist()
