"""Upsample conformer encoder of the CosyVoice flow (counterpart of
rwkvtts_tpu/codecs/conformer.py; reference
third_party/cosyvoice/transformer/upsample_encoder.py).

The deployed configuration has no macaron FFN and no convolution module,
so a layer is x += attn(LN(x)); x += ffn(LN(x)) with espnet
relative-position attention. The rel-shift is a direct relative-index
gather, as in the JAX package. Channels-last (B, T, C).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict

import numpy as np
import torch

from rwkvtts_torch.codecs import nn

Params = Dict[str, Any]


@dataclasses.dataclass(frozen=True)
class UpsampleConformerConfig:
    input_size: int = 512
    output_size: int = 512
    attention_heads: int = 8
    linear_units: int = 2048
    num_blocks: int = 6
    num_up_blocks: int = 4
    pre_lookahead_len: int = 3
    up_stride: int = 2


def espnet_rel_pos(T: int, d_model: int) -> np.ndarray:
    """(1, 2T-1, d) positive-then-negative relative encodings
    (embedding.py:224-254)."""
    position = np.arange(T, dtype=np.float32)[:, None]
    div = np.exp(np.arange(0, d_model, 2, dtype=np.float32) * -(math.log(10000.0) / d_model))
    pe_pos = np.zeros((T, d_model), np.float32)
    pe_pos[:, 0::2] = np.sin(position * div)
    pe_pos[:, 1::2] = np.cos(position * div)
    pe_neg = np.zeros((T, d_model), np.float32)
    pe_neg[:, 0::2] = np.sin(-position * div)
    pe_neg[:, 1::2] = np.cos(-position * div)
    return np.concatenate([pe_pos[::-1], pe_neg[1:]], axis=0)[None]


def rel_attention_init(g: torch.Generator, d_model: int, heads: int) -> Params:
    dk = d_model // heads
    bound = math.sqrt(6.0 / (heads * dk + dk))  # xavier_uniform on (h, d_k)
    return {
        "q": nn.linear_init(g, d_model, d_model), "k": nn.linear_init(g, d_model, d_model),
        "v": nn.linear_init(g, d_model, d_model), "out": nn.linear_init(g, d_model, d_model),
        "pos": nn.linear_init(g, d_model, d_model, bias=False),
        "pos_bias_u": nn._uniform(g, (heads, dk), bound),
        "pos_bias_v": nn._uniform(g, (heads, dk), bound),
    }


def rel_attention(p: Params, x: torch.Tensor, pos_emb: torch.Tensor, heads: int,
                  mask: torch.Tensor) -> torch.Tensor:
    """x (B, T, D); pos_emb (1, 2T-1, D); mask (B, T, T) bool."""
    B, T, D = x.shape
    dk = D // heads
    q = nn.linear(p["q"], x).reshape(B, T, heads, dk)
    k = nn.linear(p["k"], x).reshape(B, T, heads, dk).transpose(1, 2)
    v = nn.linear(p["v"], x).reshape(B, T, heads, dk).transpose(1, 2)
    pe = nn.linear(p["pos"], pos_emb).reshape(1, -1, heads, dk).transpose(1, 2)
    q_u = (q + p["pos_bias_u"]).transpose(1, 2)  # (B, H, T, dk)
    q_v = (q + p["pos_bias_v"]).transpose(1, 2)
    ac = q_u @ k.transpose(-1, -2)
    bd_full = q_v @ pe.transpose(-1, -2)  # (B, H, T, 2T-1)
    # rel-shift as a gather: out[i, j] = bd[i, (T-1) - i + j]
    ar = torch.arange(T, device=x.device)
    idx = (T - 1) - ar[:, None] + ar[None, :]
    bd = torch.gather(bd_full, -1, idx.expand(B, heads, T, T))
    # a fully padded query row softmaxes -inf to NaN; the second mask zeroes it
    scores = ((ac + bd) / math.sqrt(dk)).masked_fill(~mask[:, None], -math.inf)
    attn = torch.softmax(scores, -1).masked_fill(~mask[:, None], 0.0)
    out = (attn @ v).transpose(1, 2).reshape(B, T, D)
    return nn.linear(p["out"], out)


def encoder_layer_init(g: torch.Generator, d_model: int, heads: int, linear_units: int) -> Params:
    return {
        "attn": rel_attention_init(g, d_model, heads),
        "ff_w1": nn.linear_init(g, d_model, linear_units),
        "ff_w2": nn.linear_init(g, linear_units, d_model),
        "norm_mha": nn.layer_norm_init(d_model, g.device),
        "norm_ff": nn.layer_norm_init(d_model, g.device),
    }


def encoder_layer(p: Params, x: torch.Tensor, pos_emb: torch.Tensor, heads: int,
                  mask: torch.Tensor) -> torch.Tensor:
    x = x + rel_attention(p["attn"], nn.layer_norm(p["norm_mha"], x, eps=1e-12), pos_emb,
                          heads, mask)
    h = nn.linear(p["ff_w1"], nn.layer_norm(p["norm_ff"], x, eps=1e-12))
    return x + nn.linear(p["ff_w2"], h * torch.sigmoid(h))  # swish


def init_params(g: torch.Generator, cfg: UpsampleConformerConfig) -> Params:
    d, dev = cfg.output_size, g.device
    layer = lambda: encoder_layer_init(g, d, cfg.attention_heads, cfg.linear_units)
    return {
        "embed": {"linear": nn.linear_init(g, cfg.input_size, d), "ln": nn.layer_norm_init(d, dev)},
        "lookahead": {"conv1": nn.conv1d_init(g, d, d, cfg.pre_lookahead_len + 1),
                      "conv2": nn.conv1d_init(g, d, d, 3)},
        "encoders": [layer() for _ in range(cfg.num_blocks)],
        "up_conv": nn.conv1d_init(g, d, d, cfg.up_stride * 2 + 1),
        "up_embed": {"linear": nn.linear_init(g, cfg.input_size, d),
                     "ln": nn.layer_norm_init(d, dev)},
        "up_encoders": [layer() for _ in range(cfg.num_up_blocks)],
        "after_norm": nn.layer_norm_init(d, dev),
    }


def _embed(p: Params, x: torch.Tensor, d_model: int):
    """LinearNoSubsampling + the espnet rel-pos scaling."""
    h = nn.layer_norm(p["ln"], nn.linear(p["linear"], x), eps=1e-5) * math.sqrt(d_model)
    pos = torch.from_numpy(espnet_rel_pos(h.shape[1], d_model)).to(h.device, h.dtype)
    return h, pos


def pre_lookahead(p: Params, x: torch.Tensor, pre_lookahead_len: int) -> torch.Tensor:
    """(B, T, C): the lookahead conv over a right-padded input, a causal conv
    and the residual (upsample_encoder.py:81-104)."""
    h = nn.leaky_relu(nn.conv1d(p["conv1"], x, padding=(0, pre_lookahead_len)), 0.01)
    h = nn.conv1d(p["conv2"], h, padding=(2, 0))
    return h + x


def apply(p: Params, cfg: UpsampleConformerConfig, x: torch.Tensor,
          mask: torch.Tensor) -> torch.Tensor:
    """x (B, T, input_size) -> (B, T * up_stride, output_size); mask (B, T)
    1/0 marks the valid positions (full attention among them)."""
    d = cfg.output_size
    h, pos = _embed(p["embed"], x, d)
    pair = lambda m: (m[:, None, :] > 0) & (m[:, :, None] > 0)
    h = pre_lookahead(p["lookahead"], h, cfg.pre_lookahead_len)
    attn_mask = pair(mask)
    for lyr in p["encoders"]:
        h = encoder_layer(lyr, h, pos, cfg.attention_heads, attn_mask)
    # upsample: nearest repeat, then a left-padded conv (Upsample1D)
    h = torch.repeat_interleave(h, cfg.up_stride, 1)
    h = nn.conv1d(p["up_conv"], h, padding=(cfg.up_stride * 2, 0))
    h, pos_up = _embed(p["up_embed"], h, d)
    mask_up = pair(torch.repeat_interleave(mask, cfg.up_stride, 1))
    for lyr in p["up_encoders"]:
        h = encoder_layer(lyr, h, pos_up, cfg.attention_heads, mask_up)
    return nn.layer_norm(p["after_norm"], h, eps=1e-5)
