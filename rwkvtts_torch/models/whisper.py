"""Whisper audio encoder (counterpart of rwkvtts_tpu/models/whisper.py),
the ASR family's frontend.

The reference runs HF's WhisperEncoder frozen as a feature extractor
(model/llm/rwkv_asr_whisper.py:48-93): conv k3 + conv k3 stride 2,
learned (sinusoid-initialised) positions, pre-LN transformer layers with
no k bias, a final LayerNorm. Channels-last and functional; the
transformer layer is codecs/xy_tokenizer's whisper-style layer, as in the
JAX package. ``from_hf_state_dict`` reads an openai/whisper-* checkpoint.

Precision: ``apply`` computes in float32 on purpose, TF32 off, whatever
the parameters' dtype. The JAX package's deployment casts the encoder's
matrices to bf16 and feeds f32 mel, and jnp's promotion then runs the
encoder in f32 on bf16-rounded weights
(benchmarks/bench_families_scale.py:43-50); PyTorch does not promote, so
the port casts the weights up itself.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch

from rwkvtts_torch.codecs import nn
from rwkvtts_torch.codecs import torch_import as ti
from rwkvtts_torch.codecs.xy_tokenizer import _masked, _tf_stack, _tf_stack_init, sinusoids
from rwkvtts_torch.models.rwkv7 import tree_map

Params = Dict[str, Any]


@dataclasses.dataclass(frozen=True)
class WhisperEncoderConfig:
    n_mels: int = 80
    d_model: int = 768  # whisper-small; 1280 for large-v3 (n_mels 128)
    layers: int = 12
    heads: int = 12
    ffn_dim: int = 3072
    max_positions: int = 1500


def init_params(g: torch.Generator, cfg: WhisperEncoderConfig) -> Params:
    """f32 parameters drawn from `g`, on its device; positions are
    Whisper's sinusoids."""
    d = cfg.d_model
    return {
        "conv1": nn.conv1d_init(g, cfg.n_mels, d, 3),
        "conv2": nn.conv1d_init(g, d, d, 3),
        "pos": torch.from_numpy(sinusoids(cfg.max_positions, d)).to(g.device),
        "layers": _tf_stack_init(g, cfg.layers, d, cfg.ffn_dim),
        "ln": nn.layer_norm_init(d, g.device),
    }


def apply(p: Params, cfg: WhisperEncoderConfig, mel: torch.Tensor,
          mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """mel (B, T_mel, n_mels) at 100 Hz -> (B, T_mel // 2, d_model) at 50 Hz,
    float32. mask (B, T_mel) marks the valid frames: the layers attend to
    valid frames only and the outputs of padded ones are zero."""
    with nn.f32():
        p = tree_map(lambda t: t.float(), p)
        h = nn.gelu(nn.conv1d(p["conv1"], mel.float(), padding=1))
        h = nn.gelu(nn.conv1d(p["conv2"], h, stride=2, padding=1))
        T = h.shape[1]
        h = h + p["pos"][:T]
        sub = mask[:, ::2][:, :T] if mask is not None else None
        h = _tf_stack(p["layers"], h, cfg.heads, sub)
        return _masked(nn.layer_norm(p["ln"], h, eps=1e-5), sub)


def from_hf_state_dict(sd: Mapping[str, np.ndarray], cfg: WhisperEncoderConfig,
                       device=None) -> Params:
    """An HF WhisperEncoder state dict (keys `conv1.weight`, ..., bare or
    under `encoder.` / `model.encoder.`), as numpy -> the port's tree on
    `device`."""
    pref = next((p for p in ("model.encoder.", "encoder.", "") if f"{p}conv1.weight" in sd),
                None)
    if pref is None:
        raise KeyError("whisper encoder conv1.weight not found in state_dict")
    layers = []
    for i in range(cfg.layers):
        b = f"{pref}layers.{i}"
        layers.append({
            "attn_ln": ti.layer_norm_p(sd, f"{b}.self_attn_layer_norm"),
            "q": ti.linear_p(sd, f"{b}.self_attn.q_proj"),
            "k": ti.linear_p(sd, f"{b}.self_attn.k_proj"),
            "v": ti.linear_p(sd, f"{b}.self_attn.v_proj"),
            "out": ti.linear_p(sd, f"{b}.self_attn.out_proj"),
            "final_ln": ti.layer_norm_p(sd, f"{b}.final_layer_norm"),
            "fc1": ti.linear_p(sd, f"{b}.fc1"),
            "fc2": ti.linear_p(sd, f"{b}.fc2"),
        })
    tree = {
        "conv1": ti.conv1d_p(sd, f"{pref}conv1"),
        "conv2": ti.conv1d_p(sd, f"{pref}conv2"),
        "pos": np.asarray(sd[f"{pref}embed_positions.weight"]),
        "layers": layers,
        "ln": ti.layer_norm_p(sd, f"{pref}layer_norm"),
    }
    return ti.tensors(tree, device)
