"""Optimizer groups, LR schedule and AdamW (counterpart of
rwkvtts_tpu/train/optimizer.py, which builds them from optax).

Reference policy, as in the JAX package:
  * AdamW betas (0.9, 0.95), eps 1e-18, global-norm clipping first;
  * weight decay only on >= 2-D non-LoRA matrices ("decay");
  * twice the learning rate for the decay-LoRA bias att/w0 ("lr2x");
  * per-step LR: linear warmup, then cosine from peak to final.

``AdamW`` computes what the optax chain computes, step for step:
``clip_by_global_norm`` (scale by max_norm / norm only when norm >=
max_norm), ``scale_by_adam`` (bias-corrected moments), ``add_decayed_weights``
and ``scale_by_schedule`` (the LR of the step count *before* the update).
The parameters and moments are updated in place, to hold one copy of
each. The low-memory moment modes of the JAX package (``mu_bf16``,
``adafactor``) are not ported yet.
"""
from __future__ import annotations

import math
import re
from typing import Any, Dict, Optional

import torch

_LORA_PAT = re.compile(r"att/(w1|w2|a1|a2|v1|v2|g1|g2|x_[rwkvag])$")
_LR2X_PAT = re.compile(r"att/w0$")


def lr_schedule(peak_lr: float, final_lr: float, warmup_steps: int, total_steps: int):
    """step (a tensor) -> LR, f32: linear warmup, then cosine to final_lr."""

    def fn(step: torch.Tensor) -> torch.Tensor:
        step = step.float()
        warm = peak_lr * step / max(warmup_steps, 1)
        t = ((step - warmup_steps) / max(total_steps - warmup_steps, 1)).clamp(0.0, 1.0)
        cos = final_lr + 0.5 * (peak_lr - final_lr) * (1 + torch.cos(math.pi * t))
        return torch.where(step < warmup_steps, warm, cos)

    return fn


def param_group_label(path: str, leaf: torch.Tensor) -> str:
    if _LR2X_PAT.search(path):
        return "lr2x"
    # stacked block leaves have a leading layer axis; "matrix" means the
    # per-layer view is >= 2-D
    per_layer_ndim = leaf.ndim - 1 if path.startswith("blocks/") else leaf.ndim
    if per_layer_ndim >= 2 and not _LORA_PAT.search(path):
        return "decay"
    return "nodecay"


def flatten(tree: Dict[str, Any], prefix: str = "") -> Dict[str, torch.Tensor]:
    """A tree of dicts -> {"blocks/att/w1": leaf, ...}, in insertion order."""
    out: Dict[str, torch.Tensor] = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flatten(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = v
    return out


def unflatten(flat: Dict[str, Any]) -> Dict[str, Any]:
    """The inverse of ``flatten``."""
    out: Dict[str, Any] = {}
    for path, leaf in flat.items():
        node = out
        *parents, name = path.split("/")
        for key in parents:
            node = node.setdefault(key, {})
        node[name] = leaf
    return out


def group_labels(params) -> Dict[str, str]:
    """{path: "decay" | "nodecay" | "lr2x"} over the parameter tree."""
    return {p: param_group_label(p, leaf) for p, leaf in flatten(params).items()}


def global_norm(tensors) -> torch.Tensor:
    """sqrt(sum of squares) over all tensors, f32 (optax.global_norm)."""
    return torch.sqrt(sum((t.float() * t.float()).sum() for t in tensors))


class AdamW:
    """AdamW over a parameter tree with the reference's groups.

    State: {"mu": {path: f32}, "nu": {path: f32}, "count": int32 scalar
    tensor} — the optax Adam moments and count, one per leaf (the three
    groups of the optax multi_transform share the count)."""

    def __init__(self, params, peak_lr: float = 1e-4, final_lr: float = 1e-5,
                 warmup_steps: int = 1000, total_steps: int = 100_000,
                 weight_decay: float = 0.01, b1: float = 0.9, b2: float = 0.95,
                 eps: float = 1e-18, grad_clip: Optional[float] = 1.0):
        self.labels = group_labels(params)
        self.schedules = {
            "decay": lr_schedule(peak_lr, final_lr, warmup_steps, total_steps),
            "nodecay": lr_schedule(peak_lr, final_lr, warmup_steps, total_steps),
            "lr2x": lr_schedule(2 * peak_lr, 2 * final_lr, warmup_steps, total_steps),
        }
        self.weight_decay = {"decay": weight_decay, "nodecay": 0.0, "lr2x": 0.0}
        self.b1, self.b2, self.eps = b1, b2, eps
        self.grad_clip = grad_clip

    def init(self, params) -> Dict[str, Any]:
        flat = flatten(params)
        device = next(iter(flat.values())).device
        zeros = lambda: {p: torch.zeros_like(t, dtype=torch.float32) for p, t in flat.items()}
        return {"mu": zeros(), "nu": zeros(),
                "count": torch.zeros((), dtype=torch.int32, device=device)}

    @torch.no_grad()
    def step(self, params, grads: Dict[str, torch.Tensor], state: Dict[str, Any],
             apply: torch.Tensor, norm: torch.Tensor) -> None:
        """One update of `params` (a tree) and `state`, in place, from
        `grads` ({path: f32}) and their global norm `norm`, where the
        boolean scalar tensor `apply` is true; where it is false nothing
        changes, the count included."""
        flat = flatten(params)
        if self.grad_clip:
            clip = norm >= self.grad_clip
            max_norm = self.grad_clip
        count = state["count"]
        new_count = count + 1
        c = new_count.float()
        bc1 = 1 - self.b1 ** c
        bc2 = 1 - self.b2 ** c
        lrs = {g: fn(count) for g, fn in self.schedules.items()}
        for path, p in flat.items():
            g = grads[path].float()
            if self.grad_clip:
                g = torch.where(clip, g / norm * max_norm, g)
            mu, nu = state["mu"][path], state["nu"][path]
            mu_new = self.b1 * mu + (1 - self.b1) * g
            nu_new = self.b2 * nu + (1 - self.b2) * (g * g)
            u = (mu_new / bc1) / (torch.sqrt(nu_new / bc2) + self.eps)
            group = self.labels[path]
            if self.weight_decay[group]:
                u = u + self.weight_decay[group] * p
            p_new = p - lrs[group] * u
            mu.copy_(torch.where(apply, mu_new, mu))
            nu.copy_(torch.where(apply, nu_new, nu))
            p.copy_(torch.where(apply, p_new, p))
        state["count"] = torch.where(apply, new_count, count)
