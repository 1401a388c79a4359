"""Pretrained speech checkpoints -> the port's parameter trees (counterpart
of rwkvtts_tpu/convert/speech_init.py; the Spark loader only)."""
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
