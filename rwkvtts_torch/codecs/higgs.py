"""Higgs (boson) audio tokenizer in PyTorch: a DAC acoustic codec, a
semantic distillation branch and an EnCodec-style residual VQ at 50 Hz
(counterpart of rwkvtts_tpu/codecs/higgs.py; the reference's
third_party/boson_multimodal/audio_processing/higgs_audio_tokenizer.py:43-260,
descriptaudiocodec/dac/model/dac.py:24-140, semantic_module.py and
quantization/core_vq.py).

  encode: wav (16 kHz) -> the DAC encoder (64 channels doubling through
    strides 8/5/4/2, 320x, latent 128) and, from HuBERT features (the
    mean of all hidden layers, 768), the semantic conv encoder ->
    concatenated -> fc_prior -> residual VQ (8 x 1024, plain nearest code
    on the residuals) -> codes (nq, B, T50)
  decode: codes -> the codebook sum -> fc_post2 -> the DAC decoder -> wav,
    320 samples a code (no final tanh: the reference comments it out)

The HuBERT teacher is an injected feature function (``hubert_feature_fn``
builds one from a local transformers model directory). Plain functions on
nested dicts of tensors, channels-last, float32; call them inside
``nn.f32()`` for the JAX package's precision. Parameters carry the JAX
tree's names, with PyTorch's convolution layouts (codecs/nn.py);
``bridge.higgs_params_from_numpy`` converts a JAX tree,
``codecs/higgs_import`` a reference checkpoint.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from rwkvtts_torch.codecs import nn
from rwkvtts_torch.codecs.bicodec import _residual_unit

Params = nn.Params

_DILATIONS = (1, 3, 9)


@dataclasses.dataclass(frozen=True)
class HiggsConfig:
    sample_rate: int = 16000
    d_model: int = 64
    latent_dim: int = 128
    strides: Tuple[int, ...] = (8, 5, 4, 2)  # 320x
    semantic_dim: int = 768  # HuBERT hidden
    nq: int = 8
    codebook_size: int = 1024
    decoder_channels: int = 1024

    @property
    def quantizer_dim(self) -> int:
        return self.latent_dim + self.semantic_dim  # 896

    @property
    def hop_length(self) -> int:
        return math.prod(self.strides)

    @property
    def frame_rate(self) -> int:
        return math.ceil(self.sample_rate / self.hop_length)  # 50


def _residual_unit_init(g: torch.Generator, dim: int) -> Params:
    return {"snake1": nn.snake_init(dim, g.device), "conv1": nn.conv1d_init(g, dim, dim, 7),
            "snake2": nn.snake_init(dim, g.device), "conv2": nn.conv1d_init(g, dim, dim, 1)}


# ---------------------------------------------------------------------------
# The DAC acoustic encoder / decoder
# ---------------------------------------------------------------------------


def acoustic_encoder_init(g: torch.Generator, cfg: HiggsConfig) -> Params:
    d = cfg.d_model
    p: Params = {"conv_in": nn.conv1d_init(g, 1, d, 7), "blocks": []}
    for s in cfg.strides:
        d *= 2
        p["blocks"].append({"res": [_residual_unit_init(g, d // 2) for _ in _DILATIONS],
                            "snake": nn.snake_init(d // 2, g.device),
                            "conv": nn.conv1d_init(g, d // 2, d, 2 * s)})
    p["snake_out"] = nn.snake_init(d, g.device)
    p["conv_out"] = nn.conv1d_init(g, d, cfg.latent_dim, 3)
    return p


def acoustic_encoder(p: Params, cfg: HiggsConfig, wav: torch.Tensor) -> torch.Tensor:
    """wav (B, T) -> latents (B, T / 320, latent_dim)."""
    x = nn.conv1d(p["conv_in"], wav[..., None], padding=3)
    for blk, s in zip(p["blocks"], cfg.strides):
        for res, d in zip(blk["res"], _DILATIONS):
            x = _residual_unit(res, x, d)
        x = nn.conv1d(blk["conv"], nn.snake(blk["snake"], x), stride=s, padding=math.ceil(s / 2))
    return nn.conv1d(p["conv_out"], nn.snake(p["snake_out"], x), padding=1)


def acoustic_decoder_init(g: torch.Generator, cfg: HiggsConfig) -> Params:
    ch = cfg.decoder_channels
    p: Params = {"conv_in": nn.conv1d_init(g, cfg.latent_dim, ch, 7), "blocks": []}
    for i, s in enumerate(cfg.strides):
        d_in, d_out = ch // 2 ** i, ch // 2 ** (i + 1)
        p["blocks"].append({"snake": nn.snake_init(d_in, g.device),
                            "up": nn.conv_transpose1d_init(g, d_in, d_out, 2 * s),
                            "res": [_residual_unit_init(g, d_out) for _ in _DILATIONS]})
    out_dim = ch // 2 ** len(cfg.strides)
    p["snake_out"] = nn.snake_init(out_dim, g.device)
    p["conv_out"] = nn.conv1d_init(g, out_dim, 1, 7)
    return p


def acoustic_decoder(p: Params, cfg: HiggsConfig, z: torch.Tensor) -> torch.Tensor:
    """z (B, T50, latent) -> wav (B, T50 320)."""
    x = nn.conv1d(p["conv_in"], z, padding=3)
    for blk, s in zip(p["blocks"], cfg.strides):
        x = nn.conv_transpose1d(blk["up"], nn.snake(blk["snake"], x), stride=s,
                                padding=math.ceil(s / 2), output_padding=s % 2)
        for res, d in zip(blk["res"], _DILATIONS):
            x = _residual_unit(res, x, d)
    return nn.conv1d(p["conv_out"], nn.snake(p["snake_out"], x), padding=3)[..., 0]


# ---------------------------------------------------------------------------
# The semantic conv encoder (EnCodec-style ELU residual units, stride 1)
# ---------------------------------------------------------------------------


def _sem_res_unit_init(g: torch.Generator, dim: int) -> Params:
    return {"conv1": nn.conv1d_init(g, dim, dim, 3, bias=False),
            "conv2": nn.conv1d_init(g, dim, dim, 1, bias=False)}


def semantic_encoder_init(g: torch.Generator, cfg: HiggsConfig) -> Params:
    d = cfg.semantic_dim
    return {"conv_in": nn.conv1d_init(g, d, d, 3, bias=False),
            "blocks": [{"res": [_sem_res_unit_init(g, d) for _ in range(2)],
                        "conv": nn.conv1d_init(g, d, d, 3)} for _ in range(2)]}


def semantic_encoder(p: Params, cfg: HiggsConfig, feats: torch.Tensor) -> torch.Tensor:
    """HuBERT features (B, T50, 768) -> (B, T50, 768)."""
    x = nn.conv1d(p["conv_in"], feats)
    for blk in p["blocks"]:
        for r in blk["res"]:
            y = nn.conv1d(r["conv1"], F.elu(x))
            x = x + nn.conv1d(r["conv2"], F.elu(y), padding=0)
        x = nn.conv1d(blk["conv"], x)
    return x


# ---------------------------------------------------------------------------
# Residual VQ (no projections; plain nearest code)
# ---------------------------------------------------------------------------


def rvq_init(g: torch.Generator, cfg: HiggsConfig) -> Params:
    return {"codebooks": [torch.randn(cfg.codebook_size, cfg.quantizer_dim, generator=g,
                                      device=g.device) for _ in range(cfg.nq)]}


def rvq_encode(p: Params, z: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """z (B, T, D) -> (quantized, codes (nq, B, T)); the nearest code by
    the JAX package's |r|^2 - 2 r.c + |c|^2."""
    residual, out, codes = z, torch.zeros_like(z), []
    for cb in p["codebooks"]:
        d = ((residual * residual).sum(-1, keepdim=True) - 2 * residual @ cb.T
             + (cb * cb).sum(-1)[None, None, :])
        idx = torch.argmin(d, -1)
        residual, out = residual - cb[idx], out + cb[idx]
        codes.append(idx)
    return out, torch.stack(codes)


def rvq_decode(p: Params, codes: torch.Tensor) -> torch.Tensor:
    return sum(p["codebooks"][i][codes[i]] for i in range(codes.shape[0]))


# ---------------------------------------------------------------------------
# The tokenizer
# ---------------------------------------------------------------------------


def init_params(g: torch.Generator, cfg: HiggsConfig) -> Params:
    """f32 parameters drawn from `g`, on its device (the JAX package's tree,
    shapes and distributions; other values)."""
    qd = cfg.quantizer_dim
    return {
        "encoder": acoustic_encoder_init(g, cfg),
        "encoder_semantic": semantic_encoder_init(g, cfg),
        "fc_prior": nn.linear_init(g, qd, qd),
        "quantizer": rvq_init(g, cfg),
        "fc_post2": nn.linear_init(g, qd, cfg.latent_dim),
        "fc_post1": nn.linear_init(g, qd, cfg.semantic_dim),
        "decoder_2": acoustic_decoder_init(g, cfg),
    }


def encode(p: Params, cfg: HiggsConfig, wav: torch.Tensor, semantic_feats: torch.Tensor
           ) -> torch.Tensor:
    """wav (B, T) and its HuBERT features (B, T50, 768) -> codes (nq, B,
    T50), over the frames both branches have."""
    e_a = acoustic_encoder(p["encoder"], cfg, wav)
    e_s = semantic_encoder(p["encoder_semantic"], cfg, semantic_feats)
    T = min(e_a.shape[1], e_s.shape[1])
    e = nn.linear(p["fc_prior"], torch.cat([e_a[:, :T], e_s[:, :T]], -1))
    return rvq_encode(p["quantizer"], e)[1]


def decode(p: Params, cfg: HiggsConfig, codes: torch.Tensor) -> torch.Tensor:
    """codes (nq, B, T50) -> wav (B, T50 320) at 16 kHz."""
    z = nn.linear(p["fc_post2"], rvq_decode(p["quantizer"], codes))
    return acoustic_decoder(p["decoder_2"], cfg, z)


def hubert_feature_fn(model_dir: str, device="cuda") -> Callable[[np.ndarray], torch.Tensor]:
    """The semantic teacher from a local HuBERT model directory
    (transformers' AutoModel, on `device`: the card unless the caller asks
    for the CPU; nothing is fetched): wav (B, T) at 16 kHz -> (B, T50,
    768), the mean of all hidden states of the input zero-padded by 160
    samples each side (higgs_audio_tokenizer.py:170-180)."""
    from transformers import AutoModel

    model = AutoModel.from_pretrained(model_dir, local_files_only=True).to(device).eval()

    def fn(wavs) -> torch.Tensor:
        x = torch.as_tensor(np.asarray(wavs, np.float32), device=device)
        with torch.no_grad():
            hs = model(F.pad(x, (160, 160)), output_hidden_states=True).hidden_states
        return torch.stack(hs, 1).mean(1)

    return fn
