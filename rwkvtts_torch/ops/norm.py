"""Normalization primitives (plain PyTorch; counterpart of
rwkvtts_tpu/ops/norm.py, same formulas and dtype behaviour)."""
from __future__ import annotations

import torch


def layer_norm(x: torch.Tensor, scale, bias, eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm over the last axis, f32 statistics, output in x's dtype."""
    xf = x.float()
    mean = xf.mean(-1, keepdim=True)
    var = ((xf - mean) ** 2).mean(-1, keepdim=True)
    out = (xf - mean) * torch.reciprocal(torch.sqrt(var + eps))
    out = out * scale.float() + bias.float()
    return out.to(x.dtype)


def group_norm(x: torch.Tensor, scale, bias, num_groups: int, eps: float) -> torch.Tensor:
    """GroupNorm over the last axis split into `num_groups` groups."""
    shape = x.shape
    xf = x.float().reshape(*shape[:-1], num_groups, shape[-1] // num_groups)
    mean = xf.mean(-1, keepdim=True)
    var = ((xf - mean) ** 2).mean(-1, keepdim=True)
    out = ((xf - mean) * torch.reciprocal(torch.sqrt(var + eps))).reshape(shape)
    out = out * scale.float() + bias.float()
    return out.to(x.dtype)


def l2_normalize(x: torch.Tensor, dim: int = -1, eps: float = 1e-12) -> torch.Tensor:
    """F.normalize(p=2) with eps^2 clamped before the sqrt (finite grads at
    exactly-zero rows, as in the JAX package)."""
    xf = x.float()
    s = (xf * xf).sum(dim, keepdim=True)
    n = torch.sqrt(torch.clamp_min(s, eps * eps))
    return (xf / n).to(x.dtype)
