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
each.

``low_memory`` swaps the moment estimator and keeps the groups, the
schedule and the decay mask, as the JAX package's ``build_optimizer`` does:
  * "mu_bf16": ``scale_by_adam(mu_dtype=bfloat16)``: the step's update
    uses the f32 first moment, which is then stored as bf16 (the decay
    b1 of the stored moment is bf16's 0.8984375, as in optax under JAX);
  * "adafactor": ``scale_by_factored_rms(decay_rate=b2)``: no first
    moment; a leaf whose second-largest dimension is >= 128 keeps the row
    and column means of its squared gradients over its two largest
    dimensions (optax's ``_factored_dims``, also on the stacked (L, C, C)
    block leaves), any other leaf a full second moment; epsilon 1e-30,
    decay 1 - (count + 1) ** -b2.
Its state has optax's shapes ({"v_row", "v_col", "v"} with (1,)
placeholders where optax keeps them).

Leaves under a ``frozen`` path prefix (the ASR model's Whisper encoder) are
left out: no state, no decay, their weights never change.

On a device mesh (``shard``) the parameters and gradients it is given are
this rank's fsdp shards of the leaves the layout names: the Adam moments,
the first moment in bf16 and adafactor's unfactored second moment are
elementwise and sharded alike; adafactor factors by the full leaf's shape,
its row and column statistics are whole on every rank (their means over a
sharded dimension are all-reduced over fsdp, over another one all-gathered),
and the factors are cut to the rank's shard.
"""
from __future__ import annotations

import math
import re
from typing import Any, Dict, Optional, Sequence

import numpy as np
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


def flatten(tree, prefix: str = "") -> Dict[str, torch.Tensor]:
    """A tree of dicts and lists -> {"blocks/att/w1": leaf, ...}, in
    insertion order; a list item's key is its index (the JAX package's
    path names: "estimator/down/0/resnet/...")."""
    out: Dict[str, torch.Tensor] = {}
    items = tree.items() if isinstance(tree, dict) else enumerate(tree)
    for k, v in items:
        if isinstance(v, (dict, list)):
            out.update(flatten(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = v
    return out


def unflatten(flat: Dict[str, Any], like=None) -> Dict[str, Any]:
    """The inverse of ``flatten``: a tree of dicts, or, given `like`, a
    tree of `like`'s structure (its lists included) holding the leaves of
    `flat`."""
    if like is not None:
        def build(node, prefix):
            if isinstance(node, dict):
                return {k: build(v, f"{prefix}{k}/") for k, v in node.items()}
            if isinstance(node, list):
                return [build(v, f"{prefix}{i}/") for i, v in enumerate(node)]
            return flat[prefix[:-1]]

        return build(like, "")
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


def factored_dims(shape, min_dim_size_to_factor: int = 128):
    """The two largest axes (second-largest, largest) of a leaf whose
    second-largest dimension is >= `min_dim_size_to_factor`, else None
    (optax's ``_factored_dims``, numpy's argsort and all)."""
    if len(shape) < 2:
        return None
    order = np.argsort(shape)
    if shape[order[-2]] < min_dim_size_to_factor:
        return None
    return int(order[-2]), int(order[-1])


class AdamW:
    """AdamW over a parameter tree with the reference's groups, or with a
    low-memory moment estimator in its place (``low_memory``).

    State: {"mu": {path: f32 (bf16 with "mu_bf16")}, "nu": {path: f32},
    "count": int32 scalar tensor} — the optax Adam moments and count, one
    per leaf (the three groups of the optax multi_transform share the
    count); with "adafactor" {"v_row", "v_col", "v", "count"}."""

    def __init__(self, params, peak_lr: float = 1e-4, final_lr: float = 1e-5,
                 warmup_steps: int = 1000, total_steps: int = 100_000,
                 weight_decay: float = 0.01, b1: float = 0.9, b2: float = 0.95,
                 eps: float = 1e-18, grad_clip: Optional[float] = 1.0,
                 low_memory: Optional[str] = None, frozen: Sequence[str] = ()):
        if low_memory not in (None, "mu_bf16", "adafactor"):
            raise ValueError(f"unknown low_memory mode: {low_memory!r}")
        self.frozen = tuple(frozen)
        self.labels = {p: g for p, g in group_labels(params).items()
                       if not p.startswith(self.frozen)}
        self.schedules = {
            "decay": lr_schedule(peak_lr, final_lr, warmup_steps, total_steps),
            "nodecay": lr_schedule(peak_lr, final_lr, warmup_steps, total_steps),
            "lr2x": lr_schedule(2 * peak_lr, 2 * final_lr, warmup_steps, total_steps),
        }
        self.weight_decay = {"decay": weight_decay, "nodecay": 0.0, "lr2x": 0.0}
        self.b1, self.b2, self.eps = b1, b2, eps
        self.grad_clip = grad_clip
        self.low_memory = low_memory
        # the full shapes (adafactor factors by them, also on shards)
        self.shapes = {p: tuple(t.shape) for p, t in flatten(params).items() if p in self.labels}
        self.mesh, self.layout = None, {}

    def shard(self, mesh, layout: Dict[str, Optional[int]]) -> None:
        """Take fsdp shards from now on: `layout` is {path: the dimension a
        leaf's shard is cut along, or None} (parallel/mesh.Mesh.layout)."""
        self.mesh, self.layout = mesh, layout

    def state_layout(self) -> Dict[str, Any]:
        """{state key: {path: shard dimension or None}} of ``init``'s state
        on the mesh (its count is whole)."""
        dims = {p: self.layout.get(p) for p in self.labels}
        if self.low_memory == "adafactor":
            none = {p: None for p in dims}
            v = {p: d if factored_dims(self.shapes[p]) is None else None for p, d in dims.items()}
            return {"v_row": none, "v_col": none, "v": v}
        return {"mu": dims, "nu": dims}

    def trainable(self, params) -> Dict[str, torch.Tensor]:
        """{path: leaf} of the leaves this optimizer updates."""
        return {p: t for p, t in flatten(params).items() if p in self.labels}

    def init(self, params) -> Dict[str, Any]:
        flat = self.trainable(params)
        device = next(iter(flat.values())).device
        count = torch.zeros((), dtype=torch.int32, device=device)
        f32 = lambda shape: torch.zeros(tuple(shape), dtype=torch.float32, device=device)
        if self.low_memory == "adafactor":
            state = {"v_row": {}, "v_col": {}, "v": {}, "count": count}
            for p, t in flat.items():
                full = self.shapes[p]
                dims = factored_dims(full)
                if dims is None:
                    shapes = ((1,), (1,), t.shape)
                else:
                    d1, d0 = dims
                    shapes = (np.delete(full, d0), np.delete(full, d1), (1,))
                for key, shape in zip(("v_row", "v_col", "v"), shapes):
                    state[key][p] = f32(shape)
            return state
        mu_dtype = torch.bfloat16 if self.low_memory == "mu_bf16" else torch.float32
        return {"mu": {p: torch.zeros_like(t, dtype=mu_dtype) for p, t in flat.items()},
                "nu": {p: torch.zeros_like(t, dtype=torch.float32) for p, t in flat.items()},
                "count": count}

    def _adam(self, path, g, state, bc1, bc2, keep):
        mu, nu = state["mu"][path], state["nu"][path]
        # optax's (1 - b1) g + b1 mu; a bf16 mu meets b1 rounded to bf16 (JAX's
        # weak typing), and XLA forms the product in f32
        b1 = float(torch.tensor(self.b1, dtype=mu.dtype))
        mu_new = (1 - self.b1) * g + b1 * mu.float()
        nu_new = (1 - self.b2) * (g * g) + self.b2 * nu
        u = (mu_new / bc1) / (torch.sqrt(nu_new / bc2) + self.eps)
        keep(mu, mu_new.to(mu.dtype))
        keep(nu, nu_new)
        return u

    def _factored(self, path, g, state, decay, keep):
        v_row, v_col, v = state["v_row"][path], state["v_col"][path], state["v"][path]
        g_sq = g * g + 1e-30
        dims = factored_dims(self.shapes[path])
        if dims is None:
            v_new = decay * v + (1 - decay) * g_sq
            keep(v, v_new)
            return g * v_new ** -0.5
        d1, d0 = dims
        sd = self.layout.get(path)
        row = decay * v_row + (1 - decay) * self._full_mean(path, g_sq, d0, sd)
        col = decay * v_col + (1 - decay) * self._full_mean(path, g_sq, d1, sd)
        row_mean = row.mean(d1 - 1 if d1 > d0 else d1, keepdim=True)
        keep(v_row, row)
        keep(v_col, col)
        f_row = ((row / row_mean) ** -0.5).unsqueeze(d0)
        f_col = (col ** -0.5).unsqueeze(d1)
        if sd is not None:  # the factors of this rank's shard
            f_row, f_col = (f if f.shape[sd] == 1 else self.mesh.shard(f, sd)
                            for f in (f_row, f_col))
        return g * f_row * f_col

    def _full_mean(self, path, x, dim: int, sd: Optional[int]) -> torch.Tensor:
        """The mean over `dim` of the whole leaf of which `x` is the shard
        cut along `sd` (None: `x` is the whole leaf)."""
        if sd is None:
            return x.mean(dim)
        if sd == dim:
            return self.mesh.all_reduce(x.sum(dim), "fsdp") / self.shapes[path][dim]
        return self.mesh.all_gather(x.mean(dim), "fsdp", dim=sd - (sd > dim))

    @torch.no_grad()
    def step(self, params, grads: Dict[str, torch.Tensor], state: Dict[str, Any],
             apply: torch.Tensor, norm: torch.Tensor) -> None:
        """One update of `params` (a tree) and `state`, in place, from
        `grads` ({path: f32} of the trainable leaves) and their global norm
        `norm`, where the boolean scalar tensor `apply` is true; where it is
        false nothing changes, the count included."""
        flat = self.trainable(params)
        if self.grad_clip:
            clip = norm >= self.grad_clip
            max_norm = self.grad_clip
        count = state["count"]
        new_count = count + 1
        c = new_count.float()
        bc1 = 1 - self.b1 ** c
        bc2 = 1 - self.b2 ** c
        decay = 1 - c ** -self.b2  # adafactor: t = count + 1
        lrs = {g: fn(count) for g, fn in self.schedules.items()}
        keep = lambda old, new: old.copy_(torch.where(apply, new, old))
        for path, p in flat.items():
            g = grads[path].float()
            if self.grad_clip:
                g = torch.where(clip, g / norm * max_norm, g)
            if self.low_memory == "adafactor":
                u = self._factored(path, g, state, decay, keep)
            else:
                u = self._adam(path, g, state, bc1, bc2, keep)
            group = self.labels[path]
            if self.weight_decay[group]:
                u = u + self.weight_decay[group] * p
            keep(p, p - lrs[group] * u)
        state["count"] = torch.where(apply, new_count, count)
