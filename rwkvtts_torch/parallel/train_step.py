"""The single-device train step (counterpart of
rwkvtts_tpu/parallel/train_step.py, without its device meshes).

One step: precast the weights to the compute dtype, forward to the loss,
gradients into the f32 master weights, the global gradient norm, and the
optimizer update. A non-finite loss or norm skips the whole update:
parameters and every optimizer state (its count, so also the LR
schedule's position) stay as they were; only the trainer's step advances.
The decision is taken on the device (no host sync), as the JAX step's
``jnp.where`` over the state takes it.
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple, Optional

import torch

from rwkvtts_torch.models import spark as spark_model
from rwkvtts_torch.train import optimizer as opt_lib


class TrainState(NamedTuple):
    params: Any        # tree of f32 master weights
    opt_state: Any     # AdamW.init(params)
    step: int


def init_train_state(params, optimizer: opt_lib.AdamW) -> TrainState:
    return TrainState(params, optimizer.init(params), 0)


def spark_loss_fn(params, cfg, batch, generator: Optional[torch.Generator], l2_wrap=0.0):
    return spark_model.forward(
        params, cfg, batch["tokens"], batch["modality"], labels=batch["labels"],
        attention_mask=batch.get("attention_mask"), resets=batch.get("resets"),
        dropout_generator=generator, l2_wrap=l2_wrap,
    )


def _compute_dtype(cfg):
    for attr in ("backbone", "llm"):
        inner = getattr(cfg, attr, None)
        if inner is not None and hasattr(inner, "dtype"):
            return inner.dtype
    return getattr(cfg, "dtype", None)


def cast_weights(params, dtype):
    """The whole-tree weight cast, outside the rematerialised blocks (so the
    replay reads the cast copies): every f32 leaf with ndim >= 2 except the
    norm parameters (keys starting 'ln'), which the model reads in f32."""

    def one(key, x):
        if isinstance(x, dict):
            return {k: one(k, v) for k, v in x.items()}
        if x.dtype == torch.float32 and x.ndim >= 2 and not key.startswith("ln"):
            return x.to(dtype)
        return x

    return one("", params)


def make_train_step(cfg, optimizer: opt_lib.AdamW, loss_fn: Callable = spark_loss_fn):
    """Returns step(state, batch, generator) -> (state, metrics). The
    metrics are device tensors: loss, tokens, grad_norm, skipped."""
    precast = _compute_dtype(cfg) == torch.bfloat16

    def step(state: TrainState, batch, generator: Optional[torch.Generator]):
        flat = opt_lib.flatten(state.params)
        leaves = {p: t.detach().requires_grad_() for p, t in flat.items()}
        params = opt_lib.unflatten(leaves)
        compute = cast_weights(params, torch.bfloat16) if precast else params
        loss, n_valid = loss_fn(compute, cfg, batch, generator)
        grads = torch.autograd.grad(loss, list(leaves.values()), allow_unused=True)
        grads = {p: torch.zeros_like(t) if g is None else g
                 for (p, t), g in zip(leaves.items(), grads)}
        loss = loss.detach()
        gnorm = opt_lib.global_norm(grads.values())
        finite = torch.isfinite(loss) & torch.isfinite(gnorm)
        optimizer.step(state.params, grads, state.opt_state, finite, gnorm)
        metrics = {"loss": loss, "tokens": n_valid, "grad_norm": gnorm,
                   "skipped": (~finite).to(torch.int32)}
        return TrainState(state.params, state.opt_state, state.step + 1), metrics

    return step

