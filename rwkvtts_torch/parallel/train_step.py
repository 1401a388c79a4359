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


# Per-task loss adapters: loss_fn(params, cfg, batch, generator) -> (loss,
# n_valid), with the JAX trainer's keys and l2_wrap defaults. The batch
# holds the collator's '_'-prefixed metadata as host values (S2S's
# `_is_text`).


def spark_loss_fn(params, cfg, batch, generator: Optional[torch.Generator], l2_wrap=0.0):
    return spark_model.forward(
        params, cfg, batch["tokens"], batch["modality"], labels=batch["labels"],
        attention_mask=batch.get("attention_mask"), resets=batch.get("resets"),
        dropout_generator=generator, l2_wrap=l2_wrap,
    )


def cosy_loss_fn(params, cfg, batch, generator: Optional[torch.Generator], l2_wrap=0.0):
    from rwkvtts_torch.models import cosy

    return cosy.forward(
        params, cfg, batch["tokens"], batch["modality"], labels=batch["labels"],
        attention_mask=batch.get("attention_mask"), resets=batch.get("resets"),
        dropout_generator=generator,
    )


def xy_loss_fn(params, cfg, batch, generator: Optional[torch.Generator], l2_wrap=0.0):
    from rwkvtts_torch.models import xy

    return xy.forward(
        params, cfg, batch["input_ids"], labels=batch["labels"],
        attention_mask=batch.get("attention_mask"), resets=batch.get("resets"),
        dropout_generator=generator,
    )


def asr_loss_fn(params, cfg, batch, generator: Optional[torch.Generator], l2_wrap=1e-4):
    from rwkvtts_torch.models import asr

    return asr.forward(params, cfg, batch, l2_wrap=l2_wrap)


def two_tower_loss_fn(params, cfg, batch, generator: Optional[torch.Generator], l2_wrap=0.0):
    from rwkvtts_torch.models import tts_two_tower as tt

    return tt.forward(params, cfg, batch["text_ids"], batch["text_mask"],
                      batch["audio_ids"], batch["audio_mask"], batch["labels"])


def s2s_loss_fn(params, cfg, batch, generator: Optional[torch.Generator], l2_wrap=1e-4):
    from rwkvtts_torch.models import s2s

    return s2s.forward(
        params, cfg, batch["input_ids"], attention_mask=batch.get("attention_mask"),
        is_text=bool(batch.get("_is_text", True)), labels=batch["labels"], l2_wrap=l2_wrap,
    )


def sfm_loss_fn(params, cfg, batch, generator: Optional[torch.Generator], l2_wrap=0.0):
    """The four-term SFM flow loss; its tokens are the valid mel frames."""
    from rwkvtts_torch.codecs import flow

    total, _ = flow.sfm_loss(params, cfg, batch["tokens"], batch["token_mask"], batch["feat"],
                             batch["feat_mask"], batch["embedding"], generator=generator)
    return total, batch["feat_mask"].sum().to(torch.int32)


def frozen_prefixes(cfg) -> tuple:
    """Path prefixes of the parameters a model keeps frozen in training:
    the ASR model's Whisper encoder (the reference's rwkv_asr_whisper.py:91-93
    freezes it)."""
    return ("whisper/",) if getattr(cfg, "whisper", None) is not None else ()


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
        if isinstance(x, list):
            return [one(key, v) for v in x]
        if x.dtype == torch.float32 and x.ndim >= 2 and not key.startswith("ln"):
            return x.to(dtype)
        return x

    return one("", params)


def make_train_step(cfg, optimizer: opt_lib.AdamW, loss_fn: Callable = spark_loss_fn):
    """Returns step(state, batch, generator) -> (state, metrics). The
    metrics are device tensors: loss, tokens, grad_norm, skipped. Only the
    optimizer's trainable leaves take gradients: a frozen leaf enters the
    loss detached."""
    precast = _compute_dtype(cfg) == torch.bfloat16

    def step(state: TrainState, batch, generator: Optional[torch.Generator]):
        flat = opt_lib.flatten(state.params)
        leaves = {p: t.detach().requires_grad_() for p, t in flat.items()
                  if p in optimizer.labels}
        params = opt_lib.unflatten({p: leaves.get(p, t) for p, t in flat.items()},
                                  like=state.params)
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

