"""XY_Tokenizer checkpoint importer (counterpart of
rwkvtts_tpu/codecs/xy_import.py): the reference's state dict
(third_party/XY_Tokenizer/xy_tokenizer/model.py:13-52 module tree,
nn/modules.py layer layouts), as {name: numpy array}, onto the port's
tree for codecs/xy_tokenizer.py, through the helpers of
codecs/torch_import.py (weight-norm folding, PyTorch's convolution
layouts kept as stored, linears transposed to (in, out)).

Dropped on purpose: the positional-embedding buffers (the port recomputes
whisper's sinusoids) and the VQ EMA statistics (inited, cluster_size,
embed_avg; training only).
"""
from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np

from rwkvtts_torch.codecs import torch_import as ti
from rwkvtts_torch.convert.rwkv7_ckpt import load_torch_or_safetensors

Params = Dict[str, Any]
SD = Mapping[str, np.ndarray]


def _tf_layer_p(sd: SD, b: str) -> Params:
    """OmniWhisperTransformerLayer (modules.py:163-206)."""
    a = f"{b}.self_attn"
    return {"attn_ln": ti.layer_norm_p(sd, f"{b}.self_attn_layer_norm"),
            "q": ti.linear_p(sd, f"{a}.q_proj"), "k": ti.linear_p(sd, f"{a}.k_proj"),
            "v": ti.linear_p(sd, f"{a}.v_proj"), "out": ti.linear_p(sd, f"{a}.out_proj"),
            "final_ln": ti.layer_norm_p(sd, f"{b}.final_layer_norm"),
            "fc1": ti.linear_p(sd, f"{b}.fc1"), "fc2": ti.linear_p(sd, f"{b}.fc2")}


def _tf_stack_p(sd: SD, b: str, n: int) -> list:
    return [_tf_layer_p(sd, f"{b}.layers.{i}") for i in range(n)]


def audio_encoder_p(sd: SD, b: str, n_layers: int) -> Params:
    return {"conv1": ti.conv1d_p(sd, f"{b}.conv1"), "conv2": ti.conv1d_p(sd, f"{b}.conv2"),
            "layers": _tf_stack_p(sd, b, n_layers), "ln": ti.layer_norm_p(sd, f"{b}.layer_norm")}


def audio_decoder_p(sd: SD, b: str, n_layers: int) -> Params:
    return {"layers": _tf_stack_p(sd, b, n_layers), "ln": ti.layer_norm_p(sd, f"{b}.layer_norm"),
            "deconv1": ti.conv1d_p(sd, f"{b}.deconv1"), "deconv2": ti.conv1d_p(sd, f"{b}.deconv2")}


def adapter_p(sd: SD, b: str, n_layers: int) -> Params:
    p: Params = {"layers": _tf_stack_p(sd, b, n_layers),
                 "ln": ti.layer_norm_p(sd, f"{b}.layer_norm")}
    for name in ("proj", "out_proj"):
        if f"{b}.{name}.weight" in sd:
            p[name] = ti.linear_p(sd, f"{b}.{name}")
    return p


def down_conv_p(sd: SD, b: str) -> Params:
    return {"gate": ti.conv1d_p(sd, f"{b}.gate_proj"), "up": ti.conv1d_p(sd, f"{b}.up_proj"),
            "down": ti.linear_p(sd, f"{b}.down_proj"), "ln": ti.layer_norm_p(sd, f"{b}.layer_norm")}


def _wn_linear(sd: SD, b: str) -> Params:
    """A weight-normed 1x1 convolution (the quantizer's projections) as a
    linear (in, out)."""
    w = np.ascontiguousarray(ti._get_w(sd, b)[..., 0].T)
    return ti._with_bias(sd, b, w)


def _has(sd: SD, b: str) -> bool:
    return f"{b}.weight_v" in sd or f"{b}.weight" in sd


def rvq_p(sd: SD, b: str, nq: int) -> Params:
    p: Params = {"quantizers": []}
    if _has(sd, f"{b}.input_proj"):
        p["input_proj"] = _wn_linear(sd, f"{b}.input_proj")
        p["output_proj"] = _wn_linear(sd, f"{b}.output_proj")
    for i in range(nq):
        qb = f"{b}.quantizers.{i}"
        q: Params = {"codebook": np.asarray(sd[f"{qb}.codebook"])}
        if _has(sd, f"{qb}.in_project"):
            q["in_project"] = _wn_linear(sd, f"{qb}.in_project")
            q["out_project"] = _wn_linear(sd, f"{qb}.out_project")
        p["quantizers"].append(q)
    return p


def xy_from_state_dict(sd: SD, cfg, device=None) -> Params:
    """A whole XY_Tokenizer state dict -> the port's tree (f32 tensors on
    `device`) for codecs/xy_tokenizer.py."""
    tree = {
        "semantic_encoder": audio_encoder_p(sd, "semantic_encoder", cfg.enc_layers),
        "semantic_adapter": adapter_p(sd, "semantic_encoder_adapter", cfg.adapter_layers),
        "acoustic_encoder": audio_encoder_p(sd, "acoustic_encoder", cfg.enc_layers),
        "pre_rvq_adapter": adapter_p(sd, "pre_rvq_adapter", cfg.adapter_layers),
        "downsample": down_conv_p(sd, "downsample"),
        "quantizer": rvq_p(sd, "quantizer", cfg.nq),
        "post_rvq_adapter": adapter_p(sd, "post_rvq_adapter", cfg.adapter_layers),
        "upsample": {"up": ti.conv1d_p(sd, "upsample.up_conv")},
        "acoustic_decoder": audio_decoder_p(sd, "acoustic_decoder", cfg.dec_layers),
        "vocos": {"backbone": ti.vocos_backbone_p(sd, "enhanced_vocos.backbone", cfg.vocos_layers),
                  "head": ti.linear_p(sd, "enhanced_vocos.head.out")},
    }
    return ti.tensors(tree, device)


def load_xy_tokenizer(path: str, cfg, device=None) -> Params:
    """An XY_Tokenizer checkpoint file (.pt / .safetensors) -> the port's
    tree on `device`; a training wrapper's 'generator.' prefix is
    stripped (only the generator's keys are kept)."""
    sd = load_torch_or_safetensors(path)
    if any(k.startswith("generator.") for k in sd):
        sd = {k[len("generator."):]: v for k, v in sd.items() if k.startswith("generator.")}
    return xy_from_state_dict(sd, cfg, device)
