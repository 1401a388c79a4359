"""Checkpoint import helpers and BiCodec's importer (counterpart of
rwkvtts_tpu/codecs/torch_import.py): the reference's state dict, as
{name: numpy array}, onto the port's parameter tree. The CosyVoice flow /
HiFT importers (codecs/cosy_import.py), the S3 tokenizer's and CAM++'s
build on the helpers here.

  * weight-norm pairs (weight_g, weight_v, or torch >= 2.1's
    parametrizations) are folded to g v / |v| (the reference folds them
    at load time too);
  * convolution and transposed-convolution weights keep PyTorch's layout,
    which is the port's (codecs/nn.py); linear weights are transposed to
    (in, out);
  * batch-norm running statistics are carried for inference.

The key layout is the reference's (third_party/sparktts, BiCodec); only
the checkpoint format is read. The safetensors reader is
``convert/rwkv7_ckpt.load_safetensors``.
"""
from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch

Params = Dict[str, Any]
SD = Mapping[str, np.ndarray]


def fold_weight_norm(g: np.ndarray, v: np.ndarray) -> np.ndarray:
    """torch weight_norm over dim 0: w = g v / |v|, the norm over the other dims."""
    axes = tuple(range(1, v.ndim))
    v64 = v.astype(np.float64)
    norm = np.sqrt((v64 ** 2).sum(axis=axes, keepdims=True))
    return (g.astype(np.float64) * v64 / np.maximum(norm, 1e-12)).astype(np.float32)


def _get_w(sd: SD, prefix: str) -> np.ndarray:
    """A convolution or linear weight, weight-normed or plain."""
    if f"{prefix}.weight_v" in sd:
        return fold_weight_norm(sd[f"{prefix}.weight_g"], sd[f"{prefix}.weight_v"])
    if f"{prefix}.parametrizations.weight.original0" in sd:
        return fold_weight_norm(sd[f"{prefix}.parametrizations.weight.original0"],
                                sd[f"{prefix}.parametrizations.weight.original1"])
    return np.asarray(sd[f"{prefix}.weight"])


def _with_bias(sd: SD, prefix: str, w: np.ndarray) -> Params:
    p = {"w": np.ascontiguousarray(w)}
    if f"{prefix}.bias" in sd:
        p["b"] = np.asarray(sd[f"{prefix}.bias"])
    return p


def conv1d_p(sd: SD, prefix: str) -> Params:
    """A Conv1d (out, in/g, K) or ConvTranspose1d (in, out/g, K), as stored."""
    return _with_bias(sd, prefix, _get_w(sd, prefix))


def linear_p(sd: SD, prefix: str) -> Params:
    return _with_bias(sd, prefix, _get_w(sd, prefix).T)


def layer_norm_p(sd: SD, prefix: str) -> Params:
    return {"g": np.asarray(sd[f"{prefix}.weight"]), "b": np.asarray(sd[f"{prefix}.bias"])}


def batch_norm_p(sd: SD, prefix: str) -> Params:
    return {"g": np.asarray(sd[f"{prefix}.weight"]), "b": np.asarray(sd[f"{prefix}.bias"]),
            "mean": np.asarray(sd[f"{prefix}.running_mean"]),
            "var": np.asarray(sd[f"{prefix}.running_var"])}


def snake_p(sd: SD, prefix: str) -> Params:
    return {"alpha": np.asarray(sd[f"{prefix}.alpha"]).reshape(-1)}


def ada_norm_p(sd: SD, prefix: str) -> Params:
    return {"scale": linear_p(sd, f"{prefix}.scale"), "shift": linear_p(sd, f"{prefix}.shift")}


def _norm_p(sd: SD, prefix: str, ada: bool) -> Params:
    return ada_norm_p(sd, prefix) if ada else layer_norm_p(sd, prefix)


# ---------------------------------------------------------------------------
# BiCodec's modules
# ---------------------------------------------------------------------------


def _convnext_p(sd: SD, prefix: str, ada: bool) -> Params:
    p = {"dwconv": conv1d_p(sd, f"{prefix}.dwconv"), "norm": _norm_p(sd, f"{prefix}.norm", ada),
         "pw1": linear_p(sd, f"{prefix}.pwconv1"), "pw2": linear_p(sd, f"{prefix}.pwconv2")}
    if f"{prefix}.gamma" in sd:
        p["gamma"] = np.asarray(sd[f"{prefix}.gamma"])
    return p


def vocos_backbone_p(sd: SD, prefix: str, num_layers: int, ada: bool = False) -> Params:
    return {"embed": conv1d_p(sd, f"{prefix}.embed"), "norm": _norm_p(sd, f"{prefix}.norm", ada),
            "blocks": [_convnext_p(sd, f"{prefix}.convnext.{i}", ada) for i in range(num_layers)],
            "final_ln": layer_norm_p(sd, f"{prefix}.final_layer_norm")}


def sampling_block_p(sd: SD, prefix: str, up: bool) -> Params:
    name, key = ("de_conv_upsampler", "deconv") if up else ("conv_downsampler", "conv")
    if f"{prefix}.{name}.1.weight" in sd:
        return {key: conv1d_p(sd, f"{prefix}.{name}.1")}
    return {}


def _vocos_stack_p(sd: SD, prefix: str, cfg, is_encoder: bool) -> Params:
    """The reference's Encoder, or its Decoder (prenet / postnet)."""
    p: Params = {"samplers": [
        {"block": sampling_block_p(sd, f"{prefix}.downsample.{i}.0", up=not is_encoder),
         "vocos": vocos_backbone_p(sd, f"{prefix}.downsample.{i}.1", 2)}
        for i in range(len(cfg.sample_ratios))]}
    if is_encoder:
        p["backbone"] = vocos_backbone_p(sd, f"{prefix}.encoder", cfg.vocos_num_layers)
        p["project"] = linear_p(sd, f"{prefix}.project")
    else:
        p["linear_pre"] = linear_p(sd, f"{prefix}.linear_pre")
        p["backbone"] = vocos_backbone_p(sd, f"{prefix}.vocos_backbone", cfg.vocos_num_layers,
                                         ada=cfg.condition_dim is not None)
        p["linear"] = linear_p(sd, f"{prefix}.linear")
    return p


def _wave_generator_p(sd: SD, cfg) -> Params:
    n = len(cfg.rates)
    blocks = []
    for i in range(n):
        base = f"decoder.model.{i + 1}.block"
        blocks.append({
            "snake": snake_p(sd, f"{base}.0"),
            "up": conv1d_p(sd, f"{base}.1"),
            "res": [{"snake1": snake_p(sd, f"{base}.{2 + j}.block.0"),
                     "conv1": conv1d_p(sd, f"{base}.{2 + j}.block.1"),
                     "snake2": snake_p(sd, f"{base}.{2 + j}.block.2"),
                     "conv2": conv1d_p(sd, f"{base}.{2 + j}.block.3")} for j in range(3)],
        })
    return {"conv_in": conv1d_p(sd, "decoder.model.0"), "blocks": blocks,
            "snake_out": snake_p(sd, f"decoder.model.{n + 1}"),
            "conv_out": conv1d_p(sd, f"decoder.model.{n + 2}")}


def _conv_bn_p(sd: SD, prefix: str) -> Params:
    return {"conv": conv1d_p(sd, f"{prefix}.conv"), "bn": batch_norm_p(sd, f"{prefix}.bn")}


def _se_res2block_p(sd: SD, prefix: str, scale: int = 8) -> Params:
    b = f"{prefix}.se_res2block"
    return {
        "in": _conv_bn_p(sd, f"{b}.0"),
        "res2": [{"conv": conv1d_p(sd, f"{b}.1.convs.{i}"), "bn": batch_norm_p(sd, f"{b}.1.bns.{i}")}
                 for i in range(scale - 1)],
        "out": _conv_bn_p(sd, f"{b}.2"),
        "se1": linear_p(sd, f"{b}.3.linear1"),
        "se2": linear_p(sd, f"{b}.3.linear2"),
    }


def _ecapa_p(sd: SD, prefix: str) -> Params:
    return {
        "layer1": _conv_bn_p(sd, f"{prefix}.layer1"),
        "layer2": _se_res2block_p(sd, f"{prefix}.layer2"),
        "layer3": _se_res2block_p(sd, f"{prefix}.layer3"),
        "layer4": _se_res2block_p(sd, f"{prefix}.layer4"),
        "conv": conv1d_p(sd, f"{prefix}.conv"),
        "astp1": conv1d_p(sd, f"{prefix}.pool.linear1"),
        "astp2": conv1d_p(sd, f"{prefix}.pool.linear2"),
        "bn": batch_norm_p(sd, f"{prefix}.bn"),
        "linear": linear_p(sd, f"{prefix}.linear"),
    }


def _perceiver_p(sd: SD, prefix: str, depth: int = 2) -> Params:
    p: Params = {
        "latents": np.asarray(sd[f"{prefix}.latents"]),
        "norm": {"g": np.asarray(sd[f"{prefix}.norm.gamma"])},
        # FeedForward = Sequential(Linear, GEGLU, Linear): indices 0 and 2
        "layers": [{"attn": {n: linear_p(sd, f"{prefix}.layers.{i}.0.{n}")
                             for n in ("to_q", "to_kv", "to_out")},
                    "ff": {"in": linear_p(sd, f"{prefix}.layers.{i}.1.0"),
                           "out": linear_p(sd, f"{prefix}.layers.{i}.1.2")}}
                   for i in range(depth)],
    }
    if f"{prefix}.proj_context.weight" in sd:
        p["proj_context"] = linear_p(sd, f"{prefix}.proj_context")
    return p


def _speaker_encoder_p(sd: SD) -> Params:
    fsq: Params = {}
    if "speaker_encoder.quantizer.project_in.weight" in sd:
        fsq = {"project_in": linear_p(sd, "speaker_encoder.quantizer.project_in"),
               "project_out": linear_p(sd, "speaker_encoder.quantizer.project_out")}
    return {"ecapa": _ecapa_p(sd, "speaker_encoder.speaker_encoder"),
            "perceiver": _perceiver_p(sd, "speaker_encoder.perceiver_sampler"),
            "fsq": fsq, "project": linear_p(sd, "speaker_encoder.project")}


def tensors(tree, device=None):
    """A tree of numpy arrays (dicts and lists) -> f32 tensors on `device`."""
    if isinstance(tree, dict):
        return {k: tensors(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [tensors(v, device) for v in tree]
    return torch.from_numpy(np.array(tree, np.float32)).to(device)


def bicodec_from_state_dict(sd: SD, cfg, device=None) -> Params:
    """A BiCodec state dict -> the port's parameter tree (f32 tensors on
    `device`) for codecs/bicodec.py."""
    quant: Params = {"codebook": np.asarray(sd["quantizer.codebook.weight"])}
    if "quantizer.in_project.weight_v" in sd or "quantizer.in_project.weight" in sd:
        # 1x1 weight-normed convolutions: (out, in, 1) -> linears (in, out)
        for name in ("in_project", "out_project"):
            quant[name] = _with_bias(sd, f"quantizer.{name}",
                                     _get_w(sd, f"quantizer.{name}")[..., 0].T)
    tree = {
        "encoder": _vocos_stack_p(sd, "encoder", cfg.encoder, is_encoder=True),
        "quantizer": quant,
        "speaker_encoder": _speaker_encoder_p(sd),
        "prenet": _vocos_stack_p(sd, "prenet", cfg.prenet, is_encoder=False),
        "postnet": _vocos_stack_p(sd, "postnet", cfg.postnet, is_encoder=False),
        "decoder": _wave_generator_p(sd, cfg.wave),
    }
    return tensors(tree, device)
