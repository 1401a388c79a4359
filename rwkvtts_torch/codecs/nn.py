"""Functional NN building blocks of the CosyVoice flow and HiFT stacks
(counterpart of the part of rwkvtts_tpu/codecs/nn.py that they use).

Activations are channels-last (B, T, C) at every public function, as in
the JAX package; parameters are plain nested dicts (and lists) with the
JAX tree's names. Weight layouts are PyTorch's, so the convolutions run
as they are:

  linear          {"w": (in, out), "b": (out,)}           (as JAX)
  conv1d          {"w": (out, in/groups, K), "b": (out,)}  (JAX: (K, in/g, out))
  conv_transpose  {"w": (in, out/groups, K), "b": (out,)}  (JAX: (K, in/g, out),
                                                            the kernel flipped)

``rwkvtts_torch.bridge.codec_params_from_numpy`` is the one place where a
JAX tree is converted to these layouts. The ``*_init`` functions draw from
a ``torch.Generator`` with the distributions of the JAX initializers
(torch's defaults: uniform within 1/sqrt(fan_in)).
"""
from __future__ import annotations

import math
from typing import Any, Dict

import torch
import torch.nn.functional as F

Params = Dict[str, Any]


def _uniform(g: torch.Generator, shape, bound: float) -> torch.Tensor:
    return (torch.rand(shape, generator=g, device=g.device) * 2 - 1) * bound


# ---------------------------------------------------------------------------
# Linear and convolutions
# ---------------------------------------------------------------------------


def linear_init(g: torch.Generator, in_dim: int, out_dim: int, bias: bool = True) -> Params:
    bound = 1.0 / math.sqrt(in_dim)
    p = {"w": _uniform(g, (in_dim, out_dim), bound)}
    if bias:
        p["b"] = _uniform(g, (out_dim,), bound)
    return p


def linear(p: Params, x: torch.Tensor) -> torch.Tensor:
    y = x @ p["w"]
    return y + p["b"] if "b" in p else y


def conv1d_init(g: torch.Generator, in_ch: int, out_ch: int, kernel: int, groups: int = 1,
                bias: bool = True) -> Params:
    bound = 1.0 / math.sqrt(in_ch // groups * kernel)
    p = {"w": _uniform(g, (out_ch, in_ch // groups, kernel), bound)}
    if bias:
        p["b"] = _uniform(g, (out_ch,), bound)
    return p


def conv_transpose1d_init(g: torch.Generator, in_ch: int, out_ch: int, kernel: int,
                          groups: int = 1, bias: bool = True) -> Params:
    bound = 1.0 / math.sqrt(in_ch // groups * kernel)
    p = {"w": _uniform(g, (in_ch, out_ch // groups, kernel), bound)}
    if bias:
        p["b"] = _uniform(g, (out_ch,), bound)
    return p


def conv1d(p: Params, x: torch.Tensor, stride: int = 1, padding="SAME_TORCH",
           dilation: int = 1, groups: int = 1) -> torch.Tensor:
    """1-D convolution on (B, T, C). `padding` is an int (symmetric), a
    (lo, hi) pair, or "SAME_TORCH": (K - 1) * dilation // 2 each side."""
    k = p["w"].shape[-1]
    if padding == "SAME_TORCH":
        padding = ((k - 1) * dilation) // 2
    if isinstance(padding, int):
        padding = (padding, padding)
    h = x.transpose(1, 2)
    if padding[0] != padding[1]:
        h, padding = F.pad(h, padding), (0, 0)
    y = F.conv1d(h, p["w"].to(x.dtype), p.get("b"), stride=stride, padding=padding[0],
                 dilation=dilation, groups=groups)
    return y.transpose(1, 2)


def conv_transpose1d(p: Params, x: torch.Tensor, stride: int, padding: int = 0,
                     output_padding: int = 0, dilation: int = 1, groups: int = 1) -> torch.Tensor:
    """Transposed convolution on (B, T, C), with torch ConvTranspose1d's
    length: (T - 1) stride - 2 padding + dilation (K - 1) + output_padding + 1."""
    y = F.conv_transpose1d(x.transpose(1, 2), p["w"].to(x.dtype), p.get("b"), stride=stride,
                           padding=padding, output_padding=output_padding, groups=groups,
                           dilation=dilation)
    return y.transpose(1, 2)


# ---------------------------------------------------------------------------
# Norms and activations
# ---------------------------------------------------------------------------


def layer_norm_init(dim: int, device=None) -> Params:
    return {"g": torch.ones(dim, device=device), "b": torch.zeros(dim, device=device)}


def layer_norm(p: Params, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    return F.layer_norm(x, x.shape[-1:], p["g"], p["b"], eps)


def snake_init(dim: int, device=None) -> Params:
    return {"alpha": torch.ones(dim, device=device)}


def snake(p: Params, x: torch.Tensor) -> torch.Tensor:
    """x + sin^2(alpha x) / (alpha + 1e-9), per-channel alpha."""
    a = p["alpha"]
    return x + torch.sin(a * x) ** 2 / (a + 1e-9)


def gelu(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="none")


def leaky_relu(x: torch.Tensor, slope: float = 0.2) -> torch.Tensor:
    return torch.where(x >= 0, x, slope * x)
