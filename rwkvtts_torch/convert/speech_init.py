"""Pretrained speech checkpoints -> the port's parameter trees (counterpart
of rwkvtts_tpu/convert/speech_init.py; the Spark and Cosy loaders)."""
from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np

from rwkvtts_torch.convert import rwkv7_ckpt

Params = Dict[str, Any]


def spark_from_pretrained_sd(sd: Mapping[str, np.ndarray], cfg) -> Params:
    """RWKV7ForSpeech HF state_dict -> Spark params (numpy)."""
    p = rwkv7_ckpt.fla_to_rwkv7(sd, cfg.backbone)
    p["text_embedder"] = np.asarray(sd["text_embedder.weight"])
    p["global_embedder"] = np.asarray(sd["global_embedder.weight"])
    p["tts_tag_embedder"] = np.asarray(sd["tts_tag_embedder.weight"])
    return p


def cosy_from_pretrained_sd(sd: Mapping[str, np.ndarray], cfg) -> Params:
    """RWKV7CosyLM HF state_dict -> Cosy params (numpy): the text, special
    and speech tables, the head transposed to (C, V), its bias (zeros where
    the checkpoint has none)."""
    p = rwkv7_ckpt.fla_to_rwkv7(sd, cfg.backbone)
    p["text_embedding"] = np.asarray(sd["text_embedding.weight"])
    p["llm_embedding"] = np.asarray(sd["llm_embedding.weight"])
    p["speech_embedding"] = np.asarray(sd["speech_embedding.weight"])
    p["head"] = np.ascontiguousarray(np.asarray(sd["lm_head.weight"]).T)
    if "lm_head.bias" in sd:
        p["head_bias"] = np.asarray(sd["lm_head.bias"])
    else:
        p["head_bias"] = np.zeros(p["head"].shape[1], np.float32)
    return p
