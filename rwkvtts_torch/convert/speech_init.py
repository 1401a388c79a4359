"""Pretrained speech checkpoints -> the port's parameter trees, and the
flattened-vocabulary deployment export (counterpart of
rwkvtts_tpu/convert/speech_init.py): the Spark, Cosy, XY and ASR loaders,
Spark's and XY's init from a text RWKV-7, the S2S vocabulary enlargement,
and ``spark_to_flat``, one BlinkDL model of a Spark model for ChatRWKV /
WebRWKV and the eval engines."""
from __future__ import annotations

from typing import Any, Dict, Mapping, Optional

import numpy as np

from rwkvtts_torch import bridge
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


def xy_from_pretrained_sd(sd: Mapping[str, np.ndarray], cfg) -> Params:
    """RWKV7XYLM HF state_dict -> XY params (numpy): embs.{i}.weight as the
    channel tables, heads.{i}.weight transposed to (C, V)."""
    p = rwkv7_ckpt.fla_to_rwkv7(sd, cfg.backbone)
    p["embs"] = {str(i): np.asarray(sd[f"embs.{i}.weight"]) for i in range(cfg.num_channels)}
    p["heads"] = {str(i): np.ascontiguousarray(np.asarray(sd[f"heads.{i}.weight"]).T)
                  for i in range(cfg.num_channels)}
    return p


def asr_from_pretrained_sd(sd: Mapping[str, np.ndarray], cfg) -> Params:
    """An ASR export (``convert/export_hf.asr_to_fla``'s layout) -> ASR params
    (numpy) without the Whisper tower, which loads from its own HF
    checkpoint (``models/whisper.from_hf_state_dict``), the reference's
    deployment contract (utils/export_rwkv_asr_audio_lm.py:26-44)."""
    linear = lambda name: {"w": np.ascontiguousarray(np.asarray(sd[f"{name}.weight"]).T),
                           "b": np.asarray(sd[f"{name}.bias"])}
    p: Params = {
        "adapter": rwkv7_ckpt.fla_to_rwkv7(sd, cfg.adapter, prefix="audio_lm."),
        "llm": rwkv7_ckpt.fla_to_rwkv7(sd, cfg.llm, prefix="llm."),
        "projector": linear("projector"),
    }
    if "projector1.weight" in sd:
        p["projector1"] = linear("projector1")
    return p


def s2s_enlarge_vocab(text_sd_blinkdl: Mapping[str, np.ndarray], cfg,
                      rng: Optional[np.random.Generator] = None) -> Params:
    """A BlinkDL text RWKV-7 -> S2S params (numpy), the reference's
    utils/enlarge_rwkv_vocab_for_s2s.py: the embedding is [text | audio],
    the audio rows normal at the text rows' std; the text head is the text
    model's, the audio head normal of std 1/sqrt(C) (both drawn from `rng`,
    the rows first)."""
    rng = rng or np.random.default_rng(0)
    p = rwkv7_ckpt.blinkdl_to_rwkv7(text_sd_blinkdl, cfg.backbone)
    emb = np.asarray(text_sd_blinkdl["emb.weight"])
    C = emb.shape[1]
    V_audio = cfg.audio_vocab_size
    audio_rows = rng.normal(0, float(emb.std()), (V_audio, C)).astype(np.float32)
    p["embedding"] = np.concatenate([emb, audio_rows], 0)
    p["head"] = np.ascontiguousarray(np.asarray(text_sd_blinkdl["head.weight"]).T)
    p["audio_head"] = rng.normal(0, 1 / np.sqrt(C), (C, V_audio)).astype(np.float32)
    return p


_BACKBONE_KEYS = ("blocks", "ln0_scale", "ln0_bias", "ln_out_scale", "ln_out_bias")


def spark_from_text(text_sd: Mapping[str, np.ndarray], spark_params: Params, cfg) -> Params:
    """Seed a Spark model from a pretrained text RWKV-7 (the reference's
    spark_llm.py:174-201): the backbone copied, text_embedder from the text
    model's embeddings; the semantic embedding, the head and the other
    embedders keep `spark_params`' (tensors or numpy). Returns numpy."""
    out = dict(bridge.params_to_numpy(spark_params))
    bb = rwkv7_ckpt.fla_to_rwkv7(text_sd, cfg.backbone)
    out.update({k: bb[k] for k in _BACKBONE_KEYS})
    out["text_embedder"] = np.asarray(text_sd["model.embeddings.weight"])
    return out


def xy_from_text(text_sd: Mapping[str, np.ndarray], xy_params: Params, cfg,
                 rng: Optional[np.random.Generator] = None) -> Params:
    """Seed an XY model from a pretrained text RWKV-7 (the reference's
    convert_rwkv7_to_xy): the backbone copied; channel 0's table and head
    rows [0, text vocab) from the text model's, the extended rows ([SP*],
    [S*], [CTL*]) normal at the text table's / head's std drawn from `rng`
    (table first, then head); channels 1-7 keep `xy_params`' (tensors or
    numpy). Returns numpy."""
    rng = rng or np.random.default_rng(0)
    out = dict(bridge.params_to_numpy(xy_params))
    bb = rwkv7_ckpt.fla_to_rwkv7(text_sd, cfg.backbone)
    out.update({k: bb[k] for k in _BACKBONE_KEYS})
    text_emb = np.asarray(text_sd["model.embeddings.weight"])
    text_head = np.asarray(text_sd["lm_head.weight"])  # (V, C)
    V_old = text_emb.shape[0]
    emb0 = np.array(out["embs"]["0"], np.float32)
    head0 = np.array(out["heads"]["0"], np.float32)  # (C, V_new)
    emb0[:V_old] = text_emb
    emb0[V_old:] = rng.normal(0, float(text_emb.std()), emb0[V_old:].shape)
    head0[:, :V_old] = text_head.T
    head0[:, V_old:] = rng.normal(0, float(text_head.std()), head0[:, V_old:].shape)
    out["embs"] = dict(out["embs"], **{"0": emb0})
    out["heads"] = dict(out["heads"], **{"0": head0})
    return out


# ---------------------------------------------------------------------------
# Flattened-vocabulary deployment export: one embedding of
# [semantic (8193) | tts tag (3) | global (4096) | text (65536)] rows and the
# head zero-padded to it (the reference's data/spark/convert_2_rwkvaudio.py:
# 46-74; the id contract of its eval/eval_tts_base.py:162-168)

FLAT_SEMANTIC_BASE = 0        # semantic 0..8191, EOS 8192
FLAT_TAG_BASE = 8193          # TAG0/1/2 = 8193/8194/8195
FLAT_GLOBAL_BASE = 8196       # global += 8196
FLAT_TEXT_BASE = 8196 + 4096  # text += 12292


def spark_to_flat(params: Params, cfg) -> Dict[str, np.ndarray]:
    """Spark parameters (tensors or numpy) -> a flattened single-vocabulary
    BlinkDL state dict (numpy): the embedding rows [semantic | tts tag |
    global | text], the head zero-padded to the whole vocabulary (only
    semantic ids can be produced)."""
    p = bridge.params_to_numpy(params)
    sd = rwkv7_ckpt.rwkv7_to_blinkdl(p, cfg.backbone)
    emb = np.concatenate([p["embedding"], p["tts_tag_embedder"], p["global_embedder"],
                          p["text_embedder"]], axis=0).astype(np.float32)
    head = np.asarray(p["head"]).T.astype(np.float32)  # (V_sem, C)
    pad = np.zeros((emb.shape[0] - head.shape[0], head.shape[1]), np.float32)
    sd["emb.weight"] = emb
    sd["head.weight"] = np.concatenate([head, pad], axis=0)
    return sd


def flat_ids_from_parts(text_ids, global_ids, semantic_ids):
    """Per-table ids -> the flattened vocabulary's (text, global, semantic)."""
    return ([i + FLAT_TEXT_BASE for i in text_ids],
            [i + FLAT_GLOBAL_BASE for i in global_ids],
            [i + FLAT_SEMANTIC_BASE for i in semantic_ids])
