"""The train step (counterpart of rwkvtts_tpu/parallel/train_step.py), on
a device mesh (parallel/mesh.py): the ranks of a process group, or one
process (``mesh.Local``, every collective the identity).

One step: precast the weights to the compute dtype, forward to the loss,
the f32 gradients of the trainable leaves, the global gradient norm, and
the optimizer update on the f32 master weights. A non-finite loss or norm skips the whole update:
parameters and every optimizer state (its count, so also the LR
schedule's position) stay as they were; only the trainer's step advances.
The decision is taken on the device (no host sync), as the JAX step's
``jnp.where`` over the state takes it.

On a mesh of several ranks (dp x fsdp, with or without sp; the
collectives explicit, where GSPMD inserts JAX's) each rank holds the fsdp shards of the f32 masters
and of the optimizer state and its part of the batch (``Mesh.local_batch``):

  1. the sharded masters are all-gathered over fsdp as their bf16 precast
     (``cast_weights``' rule; f32 configs gather f32);
  2. the forward and backward run on the rank's rows (and time span); the
     loss takes the global denominators (ops/loss.py), so the ranks'
     losses and gradients sum to the single-device ones;
  3. a sharded leaf's gradient is reduce-scattered over fsdp and
     all-reduced over the rest (dp, sp), a replicated one all-reduced over
     every rank; frozen leaves reduce nothing;
  4. the norm is the square root of the all-reduced sum of squares (a
     replicated leaf counted once), the skip is decided from the reduced
     loss and norm, so every rank skips together, and the optimizer
     updates the shards.

Dropout draws from each rank's own generator (the trainer seeds it from
(seed, rank)), so its masks differ from one device's; the parity tests run
at dropout 0, as JAX's do.
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple, Optional

import torch

from rwkvtts_torch.models import spark as spark_model
from rwkvtts_torch.parallel import mesh as mesh_lib
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
    return total, mesh_lib.global_sum(batch["feat_mask"].sum().to(torch.int32))


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


def _map_state(fn, state: TrainState, optimizer: opt_lib.AdamW, mesh) -> TrainState:
    opt_state = dict(state.opt_state)
    for key, dims in optimizer.state_layout().items():
        opt_state[key] = fn(mesh, opt_state[key], dims)
    return TrainState(fn(mesh, state.params, optimizer.layout), opt_state, state.step)


def shard_state(state: TrainState, optimizer: opt_lib.AdamW, mesh) -> TrainState:
    """The rank's shards of a whole train state (a checkpoint's, or a fresh
    one), by ``optimizer``'s layout on `mesh`."""
    return _map_state(mesh_lib.shard_params, state, optimizer, mesh)


def gather_state(state: TrainState, optimizer: opt_lib.AdamW, mesh) -> TrainState:
    """The whole train state from the ranks' shards (every rank gets it)."""
    return _map_state(mesh_lib.gather_params, state, optimizer, mesh)


def make_train_step(cfg, optimizer: opt_lib.AdamW, loss_fn: Callable = spark_loss_fn,
                    mesh=None):
    """Returns step(state, batch, generator) -> (state, metrics). The
    metrics are device tensors: loss, tokens, grad_norm, skipped. Only the
    optimizer's trainable leaves take gradients: a frozen leaf enters the
    loss detached. On a `mesh` (the module docstring's four parts) the
    state holds the rank's shards (see ``shard_state``; ``optimizer.shard``
    must have been given the mesh's layout), the batch is the rank's part,
    and the metrics are global. Without one the step runs on
    ``mesh_lib.Local()``, whose collectives are the identity."""
    precast = _compute_dtype(cfg) == torch.bfloat16
    mesh = mesh_lib.Local() if mesh is None else mesh

    def step(state: TrainState, batch, generator: Optional[torch.Generator]):
        layout = optimizer.layout
        flat = opt_lib.flatten(state.params)
        # a whole trainable leaf takes its gradient at the f32 master, through
        # the cast; a sharded one at its gathered compute copy
        masters = {p: t.detach().requires_grad_() for p, t in flat.items()
                   if p in optimizer.labels and layout.get(p) is None}
        compute = {**flat, **masters}
        if precast:
            compute = opt_lib.flatten(cast_weights(opt_lib.unflatten(compute, like=state.params),
                                                   torch.bfloat16))
        leaves = {}
        for p in flat:
            if layout.get(p) is not None:
                compute[p] = mesh.all_gather(compute[p], "fsdp", dim=layout[p])
                if p in optimizer.labels:
                    compute[p].requires_grad_()
            if p in optimizer.labels:
                leaves[p] = masters.get(p, compute[p])
        params = opt_lib.unflatten(compute, like=state.params)
        with mesh_lib.active(mesh):
            loss, n_valid = loss_fn(params, cfg, batch, generator)
            grads = torch.autograd.grad(loss, list(leaves.values()), allow_unused=True)
        sq, sharded = [], []
        reduced = {}
        for (p, t), g in zip(leaves.items(), grads):
            g = torch.zeros(t.shape, dtype=torch.float32, device=t.device) if g is None \
                else g.float()
            if layout.get(p) is not None:
                g = mesh.all_reduce(mesh.reduce_scatter(g, "fsdp", dim=layout[p]), "replica")
                sharded.append(len(sq))
            else:
                g = mesh.all_reduce(g, "world")
            reduced[p] = g
            sq.append((g * g).sum())
        # a shard's square sum over fsdp; a replicated leaf's is whole already
        if sharded:
            part = mesh.all_reduce(torch.stack([sq[i] for i in sharded]), "fsdp")
            for j, i in enumerate(sharded):
                sq[i] = part[j]
        gnorm = torch.sqrt(sum(sq))
        loss = mesh.all_reduce(loss.detach(), "world")
        finite = torch.isfinite(loss) & torch.isfinite(gnorm)
        optimizer.step(state.params, reduced, state.opt_state, finite, gnorm)
        metrics = {"loss": loss, "tokens": n_valid, "grad_norm": gnorm,
                   "skipped": (~finite).to(torch.int32)}
        return TrainState(state.params, state.opt_state, state.step + 1), metrics

    return step
