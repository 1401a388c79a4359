"""Spark TTS pipeline (counterpart of rwkvtts_tpu/infer/spark_pipeline.py):
the decode weights and the prompt construction the serving pool uses.

Ported: the constructor (``rwkv7.pack_decode_params``, with fused
projections and int8) and ``_prompt_batch``. Not yet: ``synthesize`` (its
generate loop), ``design_voice`` (``spark_global_generate``), speculative
decoding and int4, and the BiCodec audio tokenizer, so no wav is produced.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np

from rwkvtts_torch.data import spark_collator
from rwkvtts_torch.models import rwkv7


class SparkPipeline:
    def __init__(
        self,
        lm_cfg,
        lm_params,
        text_tokenizer,
        audio_tokenizer=None,
        sample_rate: int = 16000,
        prompt_pad_multiple: int = 64,
        quantize_int8: bool = False,
        quantize_int4: bool = False,
        spec_k: int = 0,
        fuse_projections: bool = True,
    ):
        if quantize_int4:
            raise NotImplementedError("int4 decode weights are not ported yet")
        if spec_k:
            raise NotImplementedError("speculative decoding (spec_k) is not ported yet")
        if audio_tokenizer is not None:
            raise NotImplementedError("the BiCodec audio tokenizer is not ported yet")
        self.cfg = lm_cfg
        # fused decode projections; int8 decode weights on request. Without
        # fused projections (another engine owns decode, e.g. the B=64 pool)
        # the raw weights are all there is.
        self.params = rwkv7.pack_decode_params(
            lm_params, lm_cfg.backbone, quantize_int8=quantize_int8,
            fuse_projections=fuse_projections,
        )
        self.tok = text_tokenizer
        self.codec = None
        self.sample_rate = sample_rate
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

    def design_voice(self, properties, seed: int = 0):
        raise NotImplementedError(
            "voice design (SPCT properties -> global tokens) needs "
            "spark_global_generate, which is not ported yet")
