"""Functional NN building blocks of the codec stacks: CosyVoice flow and
HiFT, and BiCodec's Vocos / ConvNeXt stacks, sampling blocks, ECAPA batch
norms and perceiver resampler (counterpart of rwkvtts_tpu/codecs/nn.py).

Activations are channels-last (B, T, C) at every public function, as in
the JAX package; parameters are plain nested dicts (and lists) with the
JAX tree's names. Weight layouts are PyTorch's, so the convolutions run
as they are:

  linear          {"w": (in, out), "b": (out,)}           (as JAX)
  conv1d          {"w": (out, in/groups, K), "b": (out,)}  (JAX: (K, in/g, out))
  conv_transpose  {"w": (in, out/groups, K), "b": (out,)}  (JAX: (K, in/g, out),
                                                            the kernel flipped)

``rwkvtts_torch.bridge.codec_params_from_numpy`` is the one place where a
JAX tree is converted to these layouts (``bicodec_params_from_numpy`` for
BiCodec's). The ``*_init`` functions draw from a ``torch.Generator`` with
the distributions of the JAX initializers (torch's defaults: uniform
within 1/sqrt(fan_in); ConvNeXt's truncated normal of std 0.02).
"""
from __future__ import annotations

import contextlib
import math
import threading
from typing import Any, Dict

import torch
import torch.nn.functional as F

Params = Dict[str, Any]


# nn.f32's process-wide state: the blocks open now, and the flags saved by
# the first of them (the TF32 switches are global, not per thread)
_f32_lock = threading.Lock()
_f32_depth = 0
_f32_saved = (True, False)


@contextlib.contextmanager
def f32():
    """Convolutions and products in true float32 (TF32 off) for the block,
    the codecs' precision (the JAX package computes them in XLA at f32).
    Safe across threads: the first block to open saves and clears the
    global flags, the last to close restores them, so no block runs with
    TF32 switched back on by another thread's exit."""
    global _f32_depth, _f32_saved
    with _f32_lock:
        if _f32_depth == 0:
            _f32_saved = (torch.backends.cudnn.allow_tf32,
                          torch.backends.cuda.matmul.allow_tf32)
            torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
        _f32_depth += 1
    try:
        yield
    finally:
        with _f32_lock:
            _f32_depth -= 1
            if _f32_depth == 0:
                torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = _f32_saved


def _uniform(g: torch.Generator, shape, bound: float) -> torch.Tensor:
    return (torch.rand(shape, generator=g, device=g.device) * 2 - 1) * bound


def trunc_normal(g: torch.Generator, shape, std: float = 0.02) -> torch.Tensor:
    """Normal of std `std` truncated at two standard deviations."""
    t = torch.empty(shape, device=g.device)
    return torch.nn.init.trunc_normal_(t, std=std, a=-2 * std, b=2 * std, generator=g)


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
                bias: bool = True, std=None) -> Params:
    """Uniform within 1/sqrt(fan_in), or a truncated normal of `std`."""
    bound = 1.0 / math.sqrt(in_ch // groups * kernel)
    shape = (out_ch, in_ch // groups, kernel)
    p = {"w": _uniform(g, shape, bound) if std is None else trunc_normal(g, shape, std)}
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


def ada_layer_norm_init(g: torch.Generator, cond_dim: int, dim: int) -> Params:
    """Conditional LayerNorm: scale weights one, shift weights zero (the
    reference's init), the biases drawn."""
    scale, shift = linear_init(g, cond_dim, dim), linear_init(g, cond_dim, dim)
    scale["w"] = torch.ones_like(scale["w"])
    shift["w"] = torch.zeros_like(shift["w"])
    return {"scale": scale, "shift": shift}


def ada_layer_norm(p: Params, x: torch.Tensor, cond: torch.Tensor, eps: float = 1e-6
                   ) -> torch.Tensor:
    """x (B, T, C) normalised, then scaled and shifted by linears of cond (B, D)."""
    xn = F.layer_norm(x, x.shape[-1:], eps=eps)
    return xn * linear(p["scale"], cond)[:, None] + linear(p["shift"], cond)[:, None]


def batch_norm_init(dim: int, device=None) -> Params:
    return {"g": torch.ones(dim, device=device), "b": torch.zeros(dim, device=device),
            "mean": torch.zeros(dim, device=device), "var": torch.ones(dim, device=device)}


def batch_norm(p: Params, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """Inference batch norm over the channel (last) axis, with the running
    statistics."""
    inv = torch.rsqrt(p["var"] + eps) * p["g"]
    return (x - p["mean"]) * inv + p["b"]


def rms_norm_init(dim: int, device=None) -> Params:
    return {"g": torch.ones(dim, device=device)}


def rms_norm_l2(p: Params, x: torch.Tensor) -> torch.Tensor:
    """The perceiver's RMSNorm: l2-normalise, times sqrt(d) and gamma."""
    xn = x * torch.rsqrt((x * x).sum(-1, keepdim=True) + 1e-24)
    return xn * math.sqrt(x.shape[-1]) * p["g"]


# ---------------------------------------------------------------------------
# ConvNeXt / Vocos backbone
# ---------------------------------------------------------------------------


def convnext_block_init(g: torch.Generator, dim: int, intermediate_dim: int,
                        layer_scale: float, cond_dim=None) -> Params:
    dev = g.device
    p = {
        "dwconv": conv1d_init(g, dim, dim, 7, groups=dim, std=0.02),
        "pw1": {"w": trunc_normal(g, (dim, intermediate_dim)),
                "b": torch.zeros(intermediate_dim, device=dev)},
        "pw2": {"w": trunc_normal(g, (intermediate_dim, dim)), "b": torch.zeros(dim, device=dev)},
    }
    p["dwconv"]["b"] = torch.zeros(dim, device=dev)
    p["norm"] = (layer_norm_init(dim, dev) if cond_dim is None
                 else ada_layer_norm_init(g, cond_dim, dim))
    if layer_scale > 0:
        p["gamma"] = torch.full((dim,), float(layer_scale), device=dev)
    return p


def convnext_block(p: Params, x: torch.Tensor, cond=None) -> torch.Tensor:
    h = conv1d(p["dwconv"], x, groups=x.shape[-1])
    h = layer_norm(p["norm"], h) if cond is None else ada_layer_norm(p["norm"], h, cond)
    h = linear(p["pw2"], gelu(linear(p["pw1"], h)))
    if "gamma" in p:
        h = p["gamma"] * h
    return x + h


def vocos_backbone_init(g: torch.Generator, input_channels: int, dim: int,
                        intermediate_dim: int, num_layers: int, layer_scale=None,
                        cond_dim=None) -> Params:
    layer_scale = 1.0 / num_layers if layer_scale is None else layer_scale
    p = {"embed": conv1d_init(g, input_channels, dim, 7, std=0.02),
         "blocks": [convnext_block_init(g, dim, intermediate_dim, layer_scale, cond_dim)
                    for _ in range(num_layers)],
         "final_ln": layer_norm_init(dim, g.device)}
    p["embed"]["b"] = torch.zeros(dim, device=g.device)
    p["norm"] = (layer_norm_init(dim, g.device) if cond_dim is None
                 else ada_layer_norm_init(g, cond_dim, dim))
    return p


def vocos_backbone(p: Params, x: torch.Tensor, cond=None) -> torch.Tensor:
    """x (B, T, C_in) -> (B, T, dim)."""
    x = conv1d(p["embed"], x)
    x = layer_norm(p["norm"], x) if cond is None else ada_layer_norm(p["norm"], x, cond)
    for blk in p["blocks"]:
        x = convnext_block(blk, x, cond)
    return layer_norm(p["final_ln"], x)


# ---------------------------------------------------------------------------
# Sampling block (up / down)
# ---------------------------------------------------------------------------


def sampling_block_init(g: torch.Generator, dim: int, groups: int = 1,
                        upsample_scale: int = 1, downsample_scale: int = 1) -> Params:
    p: Params = {}
    if upsample_scale > 1:
        p["deconv"] = conv_transpose1d_init(g, dim, dim, upsample_scale * 2, groups=groups)
    if downsample_scale > 1:
        p["conv"] = conv1d_init(g, dim, dim, 2 * downsample_scale, groups=groups)
    return p


def _mean_pool(x: torch.Tensor, scale: int, T: int) -> torch.Tensor:
    return x[:, :T].reshape(x.shape[0], T // scale, scale, x.shape[2]).mean(2)


def sampling_block(p: Params, x: torch.Tensor, groups: int = 1, upsample_scale: int = 1,
                   downsample_scale: int = 1) -> torch.Tensor:
    """x (B, T, C) -> (B, T', C), the reference's SamplingBlock: its three
    branches are summed, so a scale-1 block gives 3 x."""
    repeat_res = x
    upmerge = x
    if upsample_scale > 1:
        repeat_res = torch.repeat_interleave(x, upsample_scale, dim=1)
        upmerge = repeat_res + conv_transpose1d(
            p["deconv"], leaky_relu(x, 0.2), stride=upsample_scale,
            padding=upsample_scale // 2 + upsample_scale % 2,
            output_padding=upsample_scale % 2, groups=groups)
    if downsample_scale <= 1:
        return 2 * upmerge + repeat_res
    conv_res = conv1d(p["conv"], leaky_relu(upmerge, 0.2), stride=downsample_scale,
                      padding=downsample_scale // 2 + downsample_scale % 2, groups=groups)
    T = upmerge.shape[1] // downsample_scale * downsample_scale
    skip2 = _mean_pool(upmerge, downsample_scale, T)
    skip1 = _mean_pool(repeat_res, downsample_scale, T)
    # avg-pool floors the length; the padded strided conv can be one longer
    L = min(conv_res.shape[1], skip2.shape[1])
    return conv_res[:, :L] + skip1[:, :L] + skip2[:, :L]


# ---------------------------------------------------------------------------
# Attention and the perceiver resampler (the speaker encoder)
# ---------------------------------------------------------------------------


def attention_init(g: torch.Generator, dim: int, dim_context=None, heads: int = 8,
                   dim_head: int = 64) -> Params:
    inner = heads * dim_head
    return {"to_q": linear_init(g, dim, inner, bias=False),
            "to_kv": linear_init(g, dim_context or dim, inner * 2, bias=False),
            "to_out": linear_init(g, inner, dim, bias=False)}


def attention(p: Params, x: torch.Tensor, context=None, heads: int = 8,
              include_queries: bool = False) -> torch.Tensor:
    """Unmasked attention of x (B, N, D) over context (B, M, Dc), or over
    [x, context] with include_queries."""
    ctx = x if context is None else context
    if context is not None and include_queries:
        ctx = torch.cat([x, ctx], 1)
    q = linear(p["to_q"], x)
    k, v = linear(p["to_kv"], ctx).chunk(2, -1)
    B, N, inner = q.shape
    split = lambda t: t.reshape(B, t.shape[1], heads, inner // heads).transpose(1, 2)
    out = F.scaled_dot_product_attention(split(q), split(k), split(v))
    return linear(p["to_out"], out.transpose(1, 2).reshape(B, N, inner))


def geglu_ff_init(g: torch.Generator, dim: int, mult: int = 4) -> Params:
    inner = int(dim * mult * 2 / 3)
    return {"in": linear_init(g, dim, inner * 2), "out": linear_init(g, inner, dim)}


def geglu_ff(p: Params, x: torch.Tensor) -> torch.Tensor:
    a, gate = linear(p["in"], x).chunk(2, -1)
    return linear(p["out"], gelu(gate) * a)


def perceiver_resampler_init(g: torch.Generator, dim: int, dim_context: int,
                             num_latents: int = 32, depth: int = 2, heads: int = 8,
                             dim_head: int = 64, ff_mult: int = 4) -> Params:
    p: Params = {
        "latents": 0.02 * torch.randn(num_latents, dim, generator=g, device=g.device),
        "layers": [{"attn": attention_init(g, dim, dim, heads, dim_head),
                    "ff": geglu_ff_init(g, dim, ff_mult)} for _ in range(depth)],
        "norm": rms_norm_init(dim, g.device),
    }
    if dim_context != dim:
        p["proj_context"] = linear_init(g, dim_context, dim)
    return p


def perceiver_resampler(p: Params, x: torch.Tensor, heads: int = 8) -> torch.Tensor:
    """x (B, T, dim_context) -> (B, num_latents, dim)."""
    if "proj_context" in p:
        x = linear(p["proj_context"], x)
    lat = p["latents"].expand(x.shape[0], *p["latents"].shape)
    for lyr in p["layers"]:
        lat = attention(lyr["attn"], lat, x, heads=heads, include_queries=True) + lat
        lat = geglu_ff(lyr["ff"], lat) + lat
    return rms_norm_l2(p["norm"], lat)
