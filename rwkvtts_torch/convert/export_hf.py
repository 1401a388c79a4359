"""Export the port's parameter trees to fla-HF-named checkpoints
(counterpart of rwkvtts_tpu/convert/export_hf.py; the Spark, Cosy, XY
and ASR exports).

The key naming is the exact inverse of ``convert/rwkv7_ckpt.fla_to_rwkv7``,
and ``model.safetensors`` is written without the `safetensors` package:
an 8-byte little-endian header length, the JSON header (dtype, shape and
byte range of each tensor, in the order written, padded with spaces to a
multiple of 8 bytes), then the raw little-endian data.
"""
from __future__ import annotations

import json
import os
import struct
from typing import Any, Dict, Mapping

import numpy as np

from rwkvtts_torch import bridge

Params = Dict[str, Any]

_XS = ("r", "w", "k", "v", "a", "g")


def rwkv7_to_fla(params: Params, cfg) -> Dict[str, np.ndarray]:
    """RWKV-7 params (tensors or numpy) -> fla-HF state_dict (numpy f32)."""
    params = bridge.params_to_numpy(params)
    blocks = params["blocks"]
    out: Dict[str, np.ndarray] = {}
    T = lambda x: np.ascontiguousarray(np.asarray(x, np.float32).T)
    r3 = lambda x: np.asarray(x, np.float32).reshape(1, 1, -1)
    for i in range(cfg.num_layers):
        att = {k: np.asarray(v[i]) for k, v in blocks["att"].items()}
        a = f"model.layers.{i}.attn"
        for s in _XS:
            out[f"{a}.x_{s}"] = r3(att[f"x_{s}"])
        out[f"{a}.r_proj.weight"] = T(att["receptance"])
        out[f"{a}.k_proj.weight"] = T(att["key"])
        out[f"{a}.v_proj.weight"] = T(att["value"])
        out[f"{a}.o_proj.weight"] = T(att["output"])
        for s, (w0, w1, w2) in {
            "w": ("w0", "w1", "w2"), "a": ("a0", "a1", "a2"),
        }.items():
            out[f"{a}.{s}_lora.lora.2.bias"] = np.asarray(att[w0], np.float32)
            out[f"{a}.{s}_lora.lora.0.weight"] = T(att[w1])
            out[f"{a}.{s}_lora.lora.2.weight"] = T(att[w2])
        if i > 0:
            out[f"{a}.v_lora.lora.2.bias"] = np.asarray(att["v0"], np.float32)
            out[f"{a}.v_lora.lora.0.weight"] = T(att["v1"])
            out[f"{a}.v_lora.lora.2.weight"] = T(att["v2"])
        out[f"{a}.g_lora.lora.0.weight"] = T(att["g1"])
        out[f"{a}.g_lora.lora.2.weight"] = T(att["g2"])
        out[f"{a}.k_k"] = r3(att["k_k"])
        out[f"{a}.k_a"] = r3(att["k_a"])
        out[f"{a}.r_k"] = np.asarray(att["r_k"], np.float32)
        out[f"{a}.g_norm.weight"] = np.asarray(att["ln_x_scale"], np.float32)
        out[f"{a}.g_norm.bias"] = np.asarray(att["ln_x_bias"], np.float32)
        out[f"model.layers.{i}.attn_norm.weight"] = np.asarray(blocks["ln1_scale"][i], np.float32)
        out[f"model.layers.{i}.attn_norm.bias"] = np.asarray(blocks["ln1_bias"][i], np.float32)
        out[f"model.layers.{i}.ffn_norm.weight"] = np.asarray(blocks["ln2_scale"][i], np.float32)
        out[f"model.layers.{i}.ffn_norm.bias"] = np.asarray(blocks["ln2_bias"][i], np.float32)
        f = f"model.layers.{i}.ffn"
        out[f"{f}.x_k"] = r3(np.asarray(blocks["ffn"]["x_k"][i]))
        out[f"{f}.key.weight"] = T(np.asarray(blocks["ffn"]["key"][i]))
        out[f"{f}.value.weight"] = T(np.asarray(blocks["ffn"]["value"][i]))
    out["model.layers.0.pre_norm.weight"] = np.asarray(params["ln0_scale"], np.float32)
    out["model.layers.0.pre_norm.bias"] = np.asarray(params["ln0_bias"], np.float32)
    out["model.norm.weight"] = np.asarray(params["ln_out_scale"], np.float32)
    out["model.norm.bias"] = np.asarray(params["ln_out_bias"], np.float32)
    if getattr(cfg, "with_embedding", True) and "embedding" in params:
        out["model.embeddings.weight"] = np.asarray(params["embedding"], np.float32)
    if getattr(cfg, "with_head", True) and "head" in params:
        out["lm_head.weight"] = T(params["head"])
    return out


def spark_to_fla(params: Params, cfg) -> Dict[str, np.ndarray]:
    """Spark speech LM -> RWKV7ForSpeech-format state_dict."""
    params = bridge.params_to_numpy(params)
    sd = rwkv7_to_fla(params, cfg.backbone)
    sd["text_embedder.weight"] = np.asarray(params["text_embedder"], np.float32)
    sd["global_embedder.weight"] = np.asarray(params["global_embedder"], np.float32)
    sd["tts_tag_embedder.weight"] = np.asarray(params["tts_tag_embedder"], np.float32)
    return sd


def cosy_to_fla(params: Params, cfg) -> Dict[str, np.ndarray]:
    """Cosy speech LM -> RWKV7CosyLM-format state_dict."""
    params = bridge.params_to_numpy(params)
    sd = rwkv7_to_fla(params, cfg.backbone)
    sd["text_embedding.weight"] = np.asarray(params["text_embedding"], np.float32)
    sd["llm_embedding.weight"] = np.asarray(params["llm_embedding"], np.float32)
    sd["speech_embedding.weight"] = np.asarray(params["speech_embedding"], np.float32)
    sd["lm_head.weight"] = np.ascontiguousarray(np.asarray(params["head"], np.float32).T)
    if "head_bias" in params:
        sd["lm_head.bias"] = np.asarray(params["head_bias"], np.float32)
    return sd


def asr_to_fla(params: Params, cfg) -> Dict[str, np.ndarray]:
    """ASR model -> one state_dict: the adapter under `audio_lm.` (with the
    discrete variant's embedding), the LLM under `llm.`, the projector(s)
    as torch Linears. The Whisper tower is not exported: it is reloaded
    from its own HF checkpoint (``models/whisper.from_hf_state_dict``), as
    the reference's export does."""
    T = lambda x: np.ascontiguousarray(bridge.to_numpy(x).astype(np.float32).T)
    sd: Dict[str, np.ndarray] = {}
    for k, v in rwkv7_to_fla(params["adapter"], cfg.adapter).items():
        sd[f"audio_lm.{k}"] = v
    for k, v in rwkv7_to_fla(params["llm"], cfg.llm).items():
        sd[f"llm.{k}"] = v
    for name in ("projector", "projector1"):
        if name in params:
            sd[f"{name}.weight"] = T(params[name]["w"])
            sd[f"{name}.bias"] = bridge.to_numpy(params[name]["b"]).astype(np.float32)
    return sd


def xy_to_fla(params: Params, cfg) -> Dict[str, np.ndarray]:
    """XY speech LM -> RWKV7XYLM-format state_dict."""
    params = bridge.params_to_numpy(params)
    sd = rwkv7_to_fla(params, cfg.backbone)
    for i in range(cfg.num_channels):
        sd[f"embs.{i}.weight"] = np.asarray(params["embs"][str(i)], np.float32)
        sd[f"heads.{i}.weight"] = np.ascontiguousarray(
            np.asarray(params["heads"][str(i)], np.float32).T)
    return sd


_ST_DTYPES = {np.dtype(np.float32): "F32", np.dtype(np.float16): "F16",
              np.dtype(np.float64): "F64", np.dtype(np.int64): "I64",
              np.dtype(np.int32): "I32", np.dtype(np.uint8): "U8",
              np.dtype(np.bool_): "BOOL"}


def save_safetensors(sd: Mapping[str, np.ndarray], path: str, metadata=None) -> None:
    """Write a safetensors file from numpy arrays."""
    header: Dict[str, Any] = {}
    if metadata:
        header["__metadata__"] = {str(k): str(v) for k, v in metadata.items()}
    arrays, off = [], 0
    for name, a in sd.items():
        a = np.ascontiguousarray(a)
        if a.dtype not in _ST_DTYPES:
            raise ValueError(f"save_safetensors: {name} has unsupported dtype {a.dtype}")
        header[name] = {"dtype": _ST_DTYPES[a.dtype], "shape": list(a.shape),
                        "data_offsets": [off, off + a.nbytes]}
        arrays.append(a)
        off += a.nbytes
    raw = json.dumps(header, separators=(",", ":")).encode()
    raw += b" " * (-len(raw) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(raw)))
        f.write(raw)
        for a in arrays:
            f.write(a.astype(a.dtype.newbyteorder("<"), copy=False).tobytes())


def save_pretrained(params: Params, cfg, out_dir: str, kind: str = "spark") -> str:
    """Write <out_dir>/model.safetensors + config.json (HF-dir layout) of a
    Spark, a Cosy or an XY speech LM, or an ASR model (kind "asr")."""
    if kind == "spark":
        sd = spark_to_fla(params, cfg)
        config = {
            "model_type": "rwkv7",
            "architectures": ["RWKV7ForSpeech"],
            "vocab_size": cfg.backbone.vocab_size,
            "hidden_size": cfg.backbone.hidden_size,
            "num_hidden_layers": cfg.backbone.num_layers,
            "head_dim": cfg.backbone.head_size,
            "text_vocab_size": cfg.text_vocab_size,
            "audio_global_vocab_size": cfg.audio_global_vocab_size,
        }
    elif kind == "cosy":
        sd = cosy_to_fla(params, cfg)
        config = {
            "model_type": "rwkv7",
            "architectures": ["RWKV7CosyLM"],
            "vocab_size": cfg.text_vocab_size,
            "hidden_size": cfg.backbone.hidden_size,
            "num_hidden_layers": cfg.backbone.num_layers,
            "speech_token_size": cfg.speech_token_size,
        }
    elif kind == "xy":
        sd = xy_to_fla(params, cfg)
        config = {
            "model_type": "rwkv7",
            "architectures": ["RWKV7XYLM"],
            "vocab_size": cfg.text_vocab_size,
            "hidden_size": cfg.backbone.hidden_size,
            "num_hidden_layers": cfg.backbone.num_layers,
            "num_channels": cfg.num_channels,
            "speech_vocab_size": cfg.speech_vocab_size,
            "text_shift_size": cfg.text_shift_size,
        }
    elif kind == "asr":
        sd = asr_to_fla(params, cfg)
        config = {
            "model_type": "rwkv7",
            "architectures": ["RWKV7ASRModel"],
            "hidden_size": cfg.llm.hidden_size,
            "num_hidden_layers": cfg.llm.num_layers,
            "adapter_hidden_size": cfg.adapter.hidden_size,
            "adapter_num_layers": cfg.adapter.num_layers,
            "variant": cfg.variant,
        }
    else:
        raise NotImplementedError(f"save_pretrained: kind {kind!r} is not ported yet "
                                  "(the port exports Spark, Cosy, XY and ASR)")
    os.makedirs(out_dir, exist_ok=True)
    save_safetensors(sd, os.path.join(out_dir, "model.safetensors"))
    with open(os.path.join(out_dir, "config.json"), "w") as f:
        json.dump(config, f, indent=2)
    return out_dir
