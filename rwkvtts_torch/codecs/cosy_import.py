"""CosyVoice flow / HiFT checkpoint importers (counterpart of
rwkvtts_tpu/codecs/cosy_import.py): the published flow.pt / hift.pt state
dicts, as {name: numpy array}, onto the port's trees for codecs/flow.py
(with codecs/conformer.py) and codecs/hift.py, through the helpers of
codecs/torch_import.py (weight-norm folding, PyTorch's convolution layouts
kept as stored, linears transposed to (in, out)).

Key layouts read (the reference's module names):
  * flow: input_embedding, spk_embed_affine_layer, encoder.*, encoder_proj,
    decoder.estimator.*; the SFM variant's sfm_head.conv{1,2},
    layernorm{1,2}, proj
  * conformer: embed.out.{0,1}, pre_lookahead_layer.conv{1,2},
    encoders.{i}.self_attn.linear_{q,k,v,out,pos} + pos_bias_{u,v},
    feed_forward.w_{1,2}, norm_mha / norm_ff, up_layer.conv,
    up_embed.out.{0,1}, up_encoders.{i}, after_norm
  * estimator: time_mlp.linear_{1,2}, {down,mid,up}_blocks.{i}.
    {0 resnet, 1.{j} transformer, 2 resampler}, resnet block{1,2}.block.
    {0 conv, 2 LayerNorm} (causal) or {0 conv, 1 GroupNorm} (non-causal),
    mlp.1, res_conv; transformer attn1.to_{q,k,v},
    attn1.to_out.0, norm1, norm3, ff.net.0.proj, ff.net.2; final_block,
    final_proj
  * HiFT: f0_predictor.condnet.{0,2,4,6,8}, classifier, m_source.l_linear,
    conv_pre, ups.{i}, source_downs.{i}, source_resblocks.{i},
    resblocks.{i}, conv_post; Snake alphas

The port's estimator has the deployed single level (causal or not, as
the config says): a checkpoint with real Downsample1D / Upsample1D
resamplers (more levels) is refused.
"""
from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np

from rwkvtts_torch.codecs import torch_import as ti
from rwkvtts_torch.convert.rwkv7_ckpt import load_torch_or_safetensors

Params = Dict[str, Any]
SD = Mapping[str, np.ndarray]


def _subdict(sd: SD, prefix: str) -> Dict[str, np.ndarray]:
    n = len(prefix)
    return {k[n:]: v for k, v in sd.items() if k.startswith(prefix)}


# ---------------------------------------------------------------------------
# Conformer encoder
# ---------------------------------------------------------------------------


def _enc_layer_p(sd: SD, b: str) -> Params:
    a = f"{b}.self_attn"
    return {
        "attn": {"q": ti.linear_p(sd, f"{a}.linear_q"), "k": ti.linear_p(sd, f"{a}.linear_k"),
                 "v": ti.linear_p(sd, f"{a}.linear_v"), "out": ti.linear_p(sd, f"{a}.linear_out"),
                 "pos": ti.linear_p(sd, f"{a}.linear_pos"),
                 "pos_bias_u": np.asarray(sd[f"{a}.pos_bias_u"]),
                 "pos_bias_v": np.asarray(sd[f"{a}.pos_bias_v"])},
        "ff_w1": ti.linear_p(sd, f"{b}.feed_forward.w_1"),
        "ff_w2": ti.linear_p(sd, f"{b}.feed_forward.w_2"),
        "norm_mha": ti.layer_norm_p(sd, f"{b}.norm_mha"),
        "norm_ff": ti.layer_norm_p(sd, f"{b}.norm_ff"),
    }


def conformer_from_sd(sd: SD, cfg) -> Params:
    """UpsampleConformerEncoder state dict (prefix stripped) -> numpy tree
    for codecs/conformer.py."""
    return {
        "embed": {"linear": ti.linear_p(sd, "embed.out.0"), "ln": ti.layer_norm_p(sd, "embed.out.1")},
        "lookahead": {"conv1": ti.conv1d_p(sd, "pre_lookahead_layer.conv1"),
                      "conv2": ti.conv1d_p(sd, "pre_lookahead_layer.conv2")},
        "encoders": [_enc_layer_p(sd, f"encoders.{i}") for i in range(cfg.num_blocks)],
        "up_conv": ti.conv1d_p(sd, "up_layer.conv"),
        "up_embed": {"linear": ti.linear_p(sd, "up_embed.out.0"),
                     "ln": ti.layer_norm_p(sd, "up_embed.out.1")},
        "up_encoders": [_enc_layer_p(sd, f"up_encoders.{i}") for i in range(cfg.num_up_blocks)],
        "after_norm": ti.layer_norm_p(sd, "after_norm"),
    }


# ---------------------------------------------------------------------------
# Estimator UNet
# ---------------------------------------------------------------------------


def _block1d_p(sd: SD, b: str, causal: bool) -> Params:
    if causal:
        return {"conv": ti.conv1d_p(sd, f"{b}.block.0"), "ln": ti.layer_norm_p(sd, f"{b}.block.2")}
    return {"conv": ti.conv1d_p(sd, f"{b}.block.0"), "gn": ti.layer_norm_p(sd, f"{b}.block.1")}


def _resnet_p(sd: SD, b: str, causal: bool) -> Params:
    return {"mlp": ti.linear_p(sd, f"{b}.mlp.1"), "block1": _block1d_p(sd, f"{b}.block1", causal),
            "block2": _block1d_p(sd, f"{b}.block2", causal),
            "res_conv": ti.conv1d_p(sd, f"{b}.res_conv")}


def _transformer_p(sd: SD, b: str) -> Params:
    return {
        "norm1": ti.layer_norm_p(sd, f"{b}.norm1"),
        "to_q": ti.linear_p(sd, f"{b}.attn1.to_q"),
        "to_k": ti.linear_p(sd, f"{b}.attn1.to_k"),
        "to_v": ti.linear_p(sd, f"{b}.attn1.to_v"),
        "to_out": ti.linear_p(sd, f"{b}.attn1.to_out.0"),
        "norm3": ti.layer_norm_p(sd, f"{b}.norm3"),
        "ff_in": ti.linear_p(sd, f"{b}.ff.net.0.proj"),
        "ff_out": ti.linear_p(sd, f"{b}.ff.net.2"),
    }


def _stage_p(sd: SD, b: str, cfg, resampler: str = None) -> Params:
    blk = {"resnet": _resnet_p(sd, f"{b}.0", cfg.causal),
           "transformers": [_transformer_p(sd, f"{b}.1.{j}") for j in range(cfg.n_blocks)]}
    if resampler is not None:
        if f"{b}.2.conv.weight" in sd:
            raise NotImplementedError(f"{b}.2 is a Downsample1D / Upsample1D: estimators of "
                                      "more than one level are not ported")
        blk[resampler] = ti.conv1d_p(sd, f"{b}.2")
    return blk


def estimator_from_sd(sd: SD, cfg) -> Params:
    """CausalConditionalDecoder (or, with cfg.causal off, ConditionalDecoder)
    state dict (prefix stripped) -> numpy tree for codecs/flow.estimator_apply."""
    n_levels = len(cfg.channels)
    return {
        "time_mlp": {"lin1": ti.linear_p(sd, "time_mlp.linear_1"),
                     "lin2": ti.linear_p(sd, "time_mlp.linear_2")},
        "down": [_stage_p(sd, f"down_blocks.{i}", cfg, "downsample") for i in range(n_levels)],
        "mid": [_stage_p(sd, f"mid_blocks.{i}", cfg) for i in range(cfg.num_mid_blocks)],
        "up": [_stage_p(sd, f"up_blocks.{i}", cfg, "upsample") for i in range(n_levels)],
        "final_block": _block1d_p(sd, "final_block", cfg.causal),
        "final_proj": ti.conv1d_p(sd, "final_proj"),
    }


def flow_from_state_dict(sd: SD, cfg, device=None) -> Params:
    """A flow checkpoint (CausalMaskedDiffWithXvec, or its SFM variant) ->
    the port's tree for codecs/flow.py, f32 tensors on `device`; with
    cfg.sfm the SFM head (model/flow/sfm_head.py) where the checkpoint has
    one."""
    p = {
        "input_embedding": np.asarray(sd["input_embedding.weight"]),
        "spk_affine": ti.linear_p(sd, "spk_embed_affine_layer"),
        "encoder": conformer_from_sd(_subdict(sd, "encoder."), cfg.encoder),
        "encoder_proj": ti.linear_p(sd, "encoder_proj"),
        "estimator": estimator_from_sd(_subdict(sd, "decoder.estimator."), cfg.estimator),
    }
    if cfg.sfm and "sfm_head.conv1.weight" in sd:
        p["sfm_head"] = {
            "conv1": ti.conv1d_p(sd, "sfm_head.conv1"),
            "ln1": ti.layer_norm_p(sd, "sfm_head.layernorm1"),
            "conv2": ti.conv1d_p(sd, "sfm_head.conv2"),
            "ln2": ti.layer_norm_p(sd, "sfm_head.layernorm2"),
            "proj": ti.linear_p(sd, "sfm_head.proj"),
        }
    return ti.tensors(p, device)


# ---------------------------------------------------------------------------
# HiFT vocoder
# ---------------------------------------------------------------------------


def _hift_resblock_p(sd: SD, b: str, n_dil: int) -> Params:
    return {
        "convs1": [ti.conv1d_p(sd, f"{b}.convs1.{j}") for j in range(n_dil)],
        "convs2": [ti.conv1d_p(sd, f"{b}.convs2.{j}") for j in range(n_dil)],
        "act1": [ti.snake_p(sd, f"{b}.activations1.{j}") for j in range(n_dil)],
        "act2": [ti.snake_p(sd, f"{b}.activations2.{j}") for j in range(n_dil)],
    }


def hift_from_state_dict(sd: SD, cfg, device=None) -> Params:
    """A hift.pt state dict -> the port's tree for codecs/hift.py, f32
    tensors on `device` (the upsampling ConvTranspose1d weights as stored)."""
    n_up, n_k = len(cfg.upsample_rates), len(cfg.resblock_kernel_sizes)
    return ti.tensors({
        "f0_predictor": {
            "convs": [ti.conv1d_p(sd, f"f0_predictor.condnet.{2 * i}") for i in range(5)],
            "classifier": ti.linear_p(sd, "f0_predictor.classifier"),
        },
        "m_source": {"l_linear": ti.linear_p(sd, "m_source.l_linear")},
        "conv_pre": ti.conv1d_p(sd, "conv_pre"),
        "ups": [ti.conv1d_p(sd, f"ups.{i}") for i in range(n_up)],
        "source_downs": [ti.conv1d_p(sd, f"source_downs.{i}") for i in range(n_up)],
        "source_resblocks": [
            _hift_resblock_p(sd, f"source_resblocks.{i}",
                             len(cfg.source_resblock_dilation_sizes[i]))
            for i in range(n_up)],
        "resblocks": [
            _hift_resblock_p(sd, f"resblocks.{i * n_k + j}", len(cfg.resblock_dilation_sizes[j]))
            for i in range(n_up) for j in range(n_k)],
        "conv_post": ti.conv1d_p(sd, "conv_post"),
    }, device)


def load_flow(path: str, cfg, device=None) -> Params:
    """flow.pt / .safetensors -> the port's flow tree on `device`."""
    return flow_from_state_dict(load_torch_or_safetensors(path), cfg, device)


def load_hift(path: str, cfg, device=None) -> Params:
    """hift.pt / .safetensors -> the port's HiFT tree on `device`."""
    return hift_from_state_dict(load_torch_or_safetensors(path), cfg, device)
