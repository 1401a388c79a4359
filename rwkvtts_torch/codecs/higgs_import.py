"""Higgs (boson) audio-tokenizer checkpoint importer (counterpart of
rwkvtts_tpu/codecs/higgs_import.py): the reference's HiggsAudioTokenizer
state dict (higgs_audio_tokenizer.py:43-140: the dac2 Encoder / Decoder,
the semantic_module Encoder, the EnCodec-style ResidualVectorQuantizer,
the fc_prior / fc_post heads), as {name: numpy array}, onto the port's
tree for codecs/higgs.py through the helpers of codecs/torch_import.py.
The HuBERT teacher is a separate model, not in the checkpoint; the VQ EMA
buffers are dropped.
"""
from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np

from rwkvtts_torch.codecs import torch_import as ti
from rwkvtts_torch.convert.rwkv7_ckpt import load_torch_or_safetensors

Params = Dict[str, Any]
SD = Mapping[str, np.ndarray]


def _dac_res_unit_p(sd: SD, b: str) -> Params:
    return {"snake1": ti.snake_p(sd, f"{b}.block.0"), "conv1": ti.conv1d_p(sd, f"{b}.block.1"),
            "snake2": ti.snake_p(sd, f"{b}.block.2"), "conv2": ti.conv1d_p(sd, f"{b}.block.3")}


def dac_encoder_p(sd: SD, b: str, n_strides: int) -> Params:
    blocks = []
    for i in range(n_strides):
        bb = f"{b}.block.{i + 1}.block"
        blocks.append({"res": [_dac_res_unit_p(sd, f"{bb}.{j}") for j in range(3)],
                       "snake": ti.snake_p(sd, f"{bb}.3"), "conv": ti.conv1d_p(sd, f"{bb}.4")})
    return {"conv_in": ti.conv1d_p(sd, f"{b}.block.0"), "blocks": blocks,
            "snake_out": ti.snake_p(sd, f"{b}.block.{n_strides + 1}"),
            "conv_out": ti.conv1d_p(sd, f"{b}.block.{n_strides + 2}")}


def dac_decoder_p(sd: SD, b: str, n_strides: int) -> Params:
    blocks = []
    for i in range(n_strides):
        bb = f"{b}.model.{i + 1}.block"
        blocks.append({"snake": ti.snake_p(sd, f"{bb}.0"), "up": ti.conv1d_p(sd, f"{bb}.1"),
                       "res": [_dac_res_unit_p(sd, f"{bb}.{2 + j}") for j in range(3)]})
    return {"conv_in": ti.conv1d_p(sd, f"{b}.model.0"), "blocks": blocks,
            "snake_out": ti.snake_p(sd, f"{b}.model.{n_strides + 1}"),
            "conv_out": ti.conv1d_p(sd, f"{b}.model.{n_strides + 2}")}


def semantic_encoder_p(sd: SD, b: str, n_blocks: int = 2) -> Params:
    unit = lambda u: {"conv1": ti.conv1d_p(sd, f"{u}.conv1.conv"),
                      "conv2": ti.conv1d_p(sd, f"{u}.conv2")}
    return {"conv_in": ti.conv1d_p(sd, f"{b}.conv.conv"),
            "blocks": [{"res": [unit(f"{b}.conv_blocks.{i}.res_units.{j}") for j in range(2)],
                        "conv": ti.conv1d_p(sd, f"{b}.conv_blocks.{i}.conv.conv")}
                       for i in range(n_blocks)]}


def higgs_from_state_dict(sd: SD, cfg, device=None) -> Params:
    """A HiggsAudioTokenizer state dict -> the port's tree (f32 tensors on
    `device`) for codecs/higgs.py."""
    n = len(cfg.strides)
    tree = {
        "encoder": dac_encoder_p(sd, "encoder", n),
        "encoder_semantic": semantic_encoder_p(sd, "encoder_semantic"),
        "fc_prior": ti.linear_p(sd, "fc_prior"),
        "quantizer": {"codebooks": [np.asarray(sd[f"quantizer.vq.layers.{i}._codebook.embed"])
                                    for i in range(cfg.nq)]},
        "fc_post2": ti.linear_p(sd, "fc_post2"),
        "fc_post1": ti.linear_p(sd, "fc_post1"),
        "decoder_2": dac_decoder_p(sd, "decoder_2", n),
    }
    return ti.tensors(tree, device)


def load_higgs(path: str, cfg, device=None) -> Params:
    """A Higgs checkpoint file (.pt / .safetensors) -> the port's tree on
    `device`."""
    return higgs_from_state_dict(load_torch_or_safetensors(path), cfg, device)
