"""RWKV-7 core model in PyTorch (counterpart of rwkvtts_tpu/models/rwkv7.py).

Functional, like the JAX package: a config, a parameter tree of plain
dicts with every block parameter stacked along a leading layer axis
(``params["blocks"]["att"]["receptance"]`` is (L, C, C)), and functions
that apply it. The names and shapes are the JAX tree's, so the bridge
(rwkvtts_torch/bridge.py) is a name-for-name copy.

Ported here: the config, ``init_params`` (same tree, shapes and init
distributions; values from a ``torch.Generator``, so they differ from
JAX's), ``init_model_state``, the full-sequence ``block_forward`` and
``forward`` (the prefill, and the training forward, differentiable, with
rematerialisation by block, ``remat`` / ``remat_policy``), the int8 and
int4 weight quantizers, and the decode half: ``pack_decode_params`` (fused
projections, int8, int4), the per-layer
decode state (``pack_decode_state`` / ``unpack_decode_state``,
``layer_decode_views``) and ``decode_step``. The WKV recurrence goes
through ``ops/wkv7.wkv7`` (the CUDA kernels on a card; with ``wkv_spans``
its span route, also the sequence-parallel one, whose token shift then
reads the previous rank's last row), or with ``wkv_fuse_prep`` through
``ops/wkv7_cuda.wkv7_fused``; the decode step's
through ``ops/wkv7.wkv7_step`` (the step kernel on a card). The products
are ``torch.matmul``, as the JAX package leaves them to XLA.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from rwkvtts_torch.ops import wkv7 as wkv7_ops
from rwkvtts_torch.ops import wkv7_cuda
from rwkvtts_torch.ops.norm import group_norm, l2_normalize, layer_norm
from rwkvtts_torch.parallel import mesh as mesh_lib

Params = Dict[str, Any]


def _round32(x: float) -> int:
    return max(32, int(round(x / 32)) * 32)


@dataclasses.dataclass(frozen=True)
class RWKV7Config:
    vocab_size: int
    hidden_size: int
    num_layers: int
    head_size: int = 64
    gate_lora: int = 128
    norm_eps: float = 1e-5
    # GroupNorm eps = 1e-5 * head_size_divisor**2 with divisor 8
    ln_x_eps: float = 64e-5
    dtype: torch.dtype = torch.bfloat16
    # run kk normalize, k_a mix, ln_x GroupNorm and the bonus inside the
    # fused WKV kernel pair (ops/wkv7_cuda.wkv7_fused); same function
    wkv_fuse_prep: bool = False
    # decode: step each layer's WKV state in place (the slot pool's mode,
    # ops/wkv7_step_packed.py); off, every step returns a fresh state
    # buffer. The same function either way. The JAX package's flag also
    # picks its head-pair-packed TPU layout, which the port does not keep.
    decode_wkv_packed: bool = False
    # decode: carry the WKV state in bf16 between steps (the step runs in
    # f32 and casts at the carry boundary)
    decode_state_bf16: bool = False
    # the tree holds the lm head / the input embedding; a tower fed
    # inputs_embeds (the ASR adapter) or read by heads of its own model
    # (S2S, the two-tower text tower) goes without
    with_head: bool = True
    with_embedding: bool = True
    # training: rematerialise each block in the backward (off: keep every
    # activation); remat_policy picks what the replay may keep: None
    # replays the whole block, "wkv" keeps the WKV call (its outputs and
    # what its backward saves, so the replay never runs the forward WKV
    # kernel again), "dots" / "dots_no_batch" keep the matrix products'
    # outputs (with / without the batched ones)
    remat: bool = True
    remat_policy: Optional[str] = None
    # the WKV recurrence in this many spans composed through their affine
    # transfer operators (ops/wkv7.wkv7_spans): > 1 takes the unfused path;
    # it is also the sequence-parallel unit, a multiple of the mesh's sp
    # (each sp rank holds wkv_spans / sp spans of T)
    wkv_spans: int = 1

    @property
    def num_heads(self) -> int:
        assert self.hidden_size % self.head_size == 0
        return self.hidden_size // self.head_size

    @property
    def decay_lora(self) -> int:
        return _round32(1.8 * math.sqrt(self.hidden_size))

    @property
    def a_lora(self) -> int:
        return _round32(1.8 * math.sqrt(self.hidden_size))

    @property
    def v_lora(self) -> int:
        return _round32(1.3 * math.sqrt(self.hidden_size))


def tree_map(fn: Callable, tree):
    """Apply fn to every tensor leaf of a tree of dicts (and lists, as the
    codec trees have)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [tree_map(fn, v) for v in tree]
    return fn(tree)


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------


def _orthogonal(g: torch.Generator, shape, gain: float) -> torch.Tensor:
    """Orthogonal init (rows or columns orthonormal, whichever are fewer),
    as jax.nn.initializers.orthogonal; on the generator's device."""
    rows, cols = shape
    a = torch.randn(max(rows, cols), min(rows, cols), generator=g, device=g.device)
    q, r = torch.linalg.qr(a)
    q = q * torch.sign(torch.diagonal(r))
    return gain * (q if rows >= cols else q.T).contiguous()


def _ortho_gain(rows: int, cols: int) -> float:
    return math.sqrt(rows / cols) if rows > cols else 1.0


def init_block_params(g: torch.Generator, cfg: RWKV7Config, layer_id: int) -> Params:
    """One block, the JAX package's formulas; f32 on the generator's
    device."""
    C, H, N, L = cfg.hidden_size, cfg.num_heads, cfg.head_size, cfg.num_layers
    dev = g.device
    r01 = layer_id / max(L - 1, 1)
    r10 = 1.0 - layer_id / L
    ddd = torch.arange(C, dtype=torch.float32, device=dev) / C
    n = torch.arange(C, dtype=torch.float32, device=dev)
    linear = n / (C - 1) - 0.5
    zig = ((n % N) - (N - 1) / 2) / ((N - 1) / 2)
    zigzag = zig * zig.abs()
    www = -6.0 + 6.0 * (n / (C - 1)) ** (1.0 + 1.0 * r01**0.3)
    Dw, Da, Dv, Dg = cfg.decay_lora, cfg.a_lora, cfg.v_lora, cfg.gate_lora
    s = 1.0 / math.sqrt(C)

    def uniform(shape, scale):
        return (torch.rand(shape, generator=g, device=dev) * 2 - 1) * scale

    zeros = lambda *shape: torch.zeros(shape, device=dev)
    full = lambda shape, value: torch.full(shape, value, device=dev)
    att = {
        "x_r": 1.0 - ddd ** (0.2 * r10),
        "x_w": 1.0 - ddd ** (0.9 * r10),
        "x_k": 1.0 - ddd ** (0.7 * r10),
        "x_v": 1.0 - ddd ** (0.7 * r10),
        "x_a": 1.0 - ddd ** (0.9 * r10),
        "x_g": 1.0 - ddd ** (0.2 * r10),
        "w0": www + 0.5 + zigzag * 2.5,
        "w1": zeros(C, Dw),
        "w2": _orthogonal(g, (Dw, C), 0.1 * _ortho_gain(Dw, C)),
        "a0": -0.19 + zigzag * 0.3 + linear * 0.4,
        "a1": zeros(C, Da),
        "a2": _orthogonal(g, (Da, C), 0.1 * _ortho_gain(Da, C)),
        # v-lora exists on every layer for a uniform tree; unused on layer 0
        "v0": 0.73 - linear * 0.4,
        "v1": zeros(C, Dv),
        "v2": _orthogonal(g, (Dv, C), 0.1 * _ortho_gain(Dv, C)),
        "g1": zeros(C, Dg),
        "g2": _orthogonal(g, (Dg, C), 0.1 * _ortho_gain(Dg, C)),
        "k_k": 0.71 - linear * 0.1,
        "k_a": full((C,), 1.02),
        "r_k": full((H, N), -0.04),
        "receptance": uniform((C, C), 0.5 * s),
        "key": uniform((C, C), 0.05 * s),
        "value": uniform((C, C), 0.5 * s),
        "output": zeros(C, C),
        "ln_x_scale": full((C,), 1.0),
        "ln_x_bias": zeros(C),
    }
    ffn = {
        "x_k": 1.0 - ddd ** (r10**4),
        "key": uniform((C, 4 * C), 0.5 * s),
        "value": zeros(4 * C, C),
    }
    return {
        "ln1_scale": full((C,), 1.0), "ln1_bias": zeros(C),
        "ln2_scale": full((C,), 1.0), "ln2_bias": zeros(C),
        "att": att, "ffn": ffn,
    }


def _unbind(tree, n: int) -> list:
    """A tree of stacked (n, ...) leaves -> n trees of per-layer views."""
    if isinstance(tree, dict):
        per_key = {k: _unbind(v, n) for k, v in tree.items()}
        return [{k: per_key[k][l] for k in tree} for l in range(n)]
    return list(torch.unbind(tree, 0))


def _stack(trees):
    if isinstance(trees[0], dict):
        return {k: _stack([t[k] for t in trees]) for k in trees[0]}
    return torch.stack(trees)


def init_params(g: torch.Generator, cfg: RWKV7Config) -> Params:
    """f32 parameters drawn from `g`, on the generator's device (a CUDA
    generator puts the whole tree on its card)."""
    C, dev = cfg.hidden_size, g.device
    blocks = [init_block_params(g, cfg, i) for i in range(cfg.num_layers)]
    ones = lambda: torch.ones(C, device=dev)
    zeros = lambda: torch.zeros(C, device=dev)
    params: Params = {
        "blocks": _stack(blocks),
        "ln0_scale": ones(), "ln0_bias": zeros(),
        "ln_out_scale": ones(), "ln_out_bias": zeros(),
    }
    V = cfg.vocab_size
    if V and cfg.with_embedding:  # a model with tables of its own (Cosy) sets vocab_size 0
        params["embedding"] = (torch.rand(V, C, generator=g, device=dev) * 2 - 1) * 1e-4
    if V and cfg.with_head:
        params["head"] = _orthogonal(g, (C, V), 0.5 * math.sqrt(V / C) if V > C else 0.5)
    return params


# ---------------------------------------------------------------------------
# State
# ---------------------------------------------------------------------------


def init_model_state(cfg: RWKV7Config, batch: int, dtype=None, device=None) -> Params:
    """att_x (L,B,C), wkv (L,B,H,N,N) f32, ffn_x (L,B,C)."""
    L, C, H, N = cfg.num_layers, cfg.hidden_size, cfg.num_heads, cfg.head_size
    dt = dtype or cfg.dtype
    return {
        "att_x": torch.zeros(L, batch, C, dtype=dt, device=device),
        "wkv": torch.zeros(L, batch, H, N, N, dtype=torch.float32, device=device),
        "ffn_x": torch.zeros(L, batch, C, dtype=dt, device=device),
    }


# ---------------------------------------------------------------------------
# Block forward (full sequence)
# ---------------------------------------------------------------------------


def _lora(x, w1, w2, act=None):
    h = x @ w1
    if act is not None:
        h = act(h)
    return h @ w2


def _time_shift(x: torch.Tensor, x_prev: Optional[torch.Tensor]) -> torch.Tensor:
    """(B,T,C): prepend x_prev (or zeros) and drop the last position. In a
    train step with sequence parallelism, x is this rank's part of T and
    the row prepended is the previous rank's last one (the first rank's is
    x_prev), exchanged differentiably."""
    x_prev = mesh_lib.sp_prev_row(x[:, -1], x_prev)
    prev = torch.zeros_like(x[:, :1]) if x_prev is None else x_prev[:, None].to(x.dtype)
    return torch.cat([prev, x[:, :-1]], 1)


def _fused(cfg: RWKV7Config) -> bool:
    """The fused-prep kernel pair runs the GroupNorm epilogue, which cannot
    come before the span correction: spans take the unfused path."""
    return cfg.wkv_fuse_prep and cfg.wkv_spans == 1


def _pre_wkv(bp: Params, cfg: RWKV7Config, x: torch.Tensor, mask: Optional[torch.Tensor],
             resets: Optional[torch.Tensor], layer_idx: int, v_first: torch.Tensor,
             st: Optional[Params]):
    """A block's time mix up to the WKV call: (xn, v_first, the gate g, the
    WKV call's sequence inputs, each (B, T, H, N))."""
    B, T, C = x.shape
    H, N = cfg.num_heads, cfg.head_size
    att = bp["att"]
    cast = lambda p: p.to(cfg.dtype)
    heads = lambda u: u.reshape(B, T, H, N)

    xn = _masked(layer_norm(x, bp["ln1_scale"], bp["ln1_bias"], cfg.norm_eps), mask)
    xx = _time_shift(xn, None if st is None else st["att_x"]) - xn
    if resets is not None:
        # a reset position starts a fresh segment: its token-shift prev is 0
        xx = torch.where(resets[..., None], -xn, xx)
    xr, xw, xk, xv, xa, xg = (xn + xx * cast(att[f"x_{s}"]) for s in "rwkvag")

    r = xr @ cast(att["receptance"])
    w_raw = -F.softplus(
        -(cast(att["w0"]) + _lora(xw, cast(att["w1"]), cast(att["w2"]), torch.tanh))
    ) - 0.5
    k = xk @ cast(att["key"])
    v = xv @ cast(att["value"])
    if layer_idx == 0:
        v_first = v
    else:
        v = v + (v_first - v) * torch.sigmoid(
            cast(att["v0"]) + _lora(xv, cast(att["v1"]), cast(att["v2"]))
        )
    a = torch.sigmoid(cast(att["a0"]) + _lora(xa, cast(att["a1"]), cast(att["a2"])))
    g = _lora(xg, cast(att["g1"]), cast(att["g2"]), torch.sigmoid)
    v = _masked(v, mask)
    if _fused(cfg):
        return xn, v_first, g, (heads(r), heads(w_raw), heads(k), heads(v), heads(a))
    kk = l2_normalize(heads(k * cast(att["k_k"]))).reshape(B, T, C)
    k = k * (1 + (a - 1) * cast(att["k_a"]))
    return xn, v_first, g, (heads(r), heads(w_raw), heads(k), heads(v), heads(-kk),
                            heads(kk * a))


def _wkv(att: Params, cfg: RWKV7Config, seq: tuple, wkv_in: Optional[torch.Tensor],
         resets: Optional[torch.Tensor]):
    """The block's WKV call: (y (B, T, H, N), the final state); with
    ``wkv_fuse_prep`` y is already normalised and carries the bonus."""
    if _fused(cfg):
        H, N = cfg.num_heads, cfg.head_size
        hn = lambda p: p.float().reshape(H, N)
        return wkv7_cuda.wkv7_fused(
            *seq[:5], hn(att["k_k"]), hn(att["k_a"]), hn(att["r_k"]),
            hn(att["ln_x_scale"]), hn(att["ln_x_bias"]),
            state=wkv_in, resets=resets, ln_eps=cfg.ln_x_eps,
        )
    return wkv7_ops.wkv7(*seq, state=wkv_in, resets=resets, spans=cfg.wkv_spans)


def _post_wkv(bp: Params, cfg: RWKV7Config, x: torch.Tensor, mask: Optional[torch.Tensor],
              resets: Optional[torch.Tensor], y: torch.Tensor, g: torch.Tensor, seq: tuple,
              st: Optional[Params]):
    """A block after the WKV call: the ln_x GroupNorm and bonus (unless the
    fused kernel did them), the gated output, the channel mix. Returns
    (x, the channel mix's normed input xn2)."""
    B, T, C = x.shape
    H = cfg.num_heads
    att, ffn = bp["att"], bp["ffn"]
    cast = lambda p: p.to(cfg.dtype)
    if _fused(cfg):
        y = y.reshape(B, T, C)
    else:
        r, k, v = seq[0], seq[2], seq[3]
        y = group_norm(y.reshape(B, T, C), att["ln_x_scale"], att["ln_x_bias"], H,
                       cfg.ln_x_eps)
        y = y + ((r * k * cast(att["r_k"])).sum(-1, keepdim=True) * v).reshape(B, T, C)
    x = x + (y * g) @ cast(att["output"])

    xn2 = _masked(layer_norm(x, bp["ln2_scale"], bp["ln2_bias"], cfg.norm_eps), mask)
    xx2 = _time_shift(xn2, None if st is None else st["ffn_x"]) - xn2
    if resets is not None:
        xx2 = torch.where(resets[..., None], -xn2, xx2)
    kf = xn2 + xx2 * cast(ffn["x_k"])
    kf = torch.square(torch.relu(kf @ cast(ffn["key"])))
    return x + kf @ cast(ffn["value"]), xn2


def _masked(h: torch.Tensor, mask: Optional[torch.Tensor]) -> torch.Tensor:
    return h if mask is None else h * mask[..., None].to(h.dtype)


def block_forward(
    bp: Params, cfg: RWKV7Config, x: torch.Tensor,
    mask: Optional[torch.Tensor], resets: Optional[torch.Tensor],
    layer_idx: int, v_first: torch.Tensor, st: Optional[Params] = None,
) -> Tuple[torch.Tensor, torch.Tensor, Params]:
    """One block over a (B, T, C) sequence; st is this layer's state slice
    {'att_x': (B,C), 'wkv': (B,H,N,N), 'ffn_x': (B,C)} and the updated
    slice is returned. `mask` (B, T) zeroes xn and v at pad positions."""
    return _block(lambda fn, *a: fn(*a), bp, cfg, x, mask, resets, layer_idx, v_first, st)


def _block(segment: Callable, bp: Params, cfg: RWKV7Config, x: torch.Tensor, mask, resets,
           layer_idx: int, v_first: torch.Tensor, st: Optional[Params]):
    """block_forward with the parts before and after the WKV call each run
    as segment(part, *args) (under ``torch.utils.checkpoint`` for the "wkv"
    remat policy: the backward's replay then never runs the WKV call)."""
    xn, v_first, g, seq = segment(_pre_wkv, bp, cfg, x, mask, resets, layer_idx, v_first, st)
    y, wkv_state = _wkv(bp["att"], cfg, seq, None if st is None else st["wkv"], resets)
    x, xn2 = segment(_post_wkv, bp, cfg, x, mask, resets, y, g, seq, st)
    return x, v_first, {"att_x": xn[:, -1], "wkv": wkv_state, "ffn_x": xn2[:, -1]}


REMAT_POLICIES = (None, "wkv", "dots", "dots_no_batch")


def _dots_context(batched: bool):
    """The selective-checkpoint contexts of the "dots" policies: the
    replay keeps every matrix product's output (aten mm / addmm, and with
    `batched` bmm / baddbmm) and recomputes the rest."""
    from torch.utils.checkpoint import CheckpointPolicy, create_selective_checkpoint_contexts

    aten = torch.ops.aten
    keep = {aten.mm.default, aten.addmm.default}
    if batched:
        keep |= {aten.bmm.default, aten.baddbmm.default}

    def policy(ctx, op, *args, **kwargs):
        return CheckpointPolicy.MUST_SAVE if op in keep else CheckpointPolicy.PREFER_RECOMPUTE

    return create_selective_checkpoint_contexts(policy)


def _remat_block(args: tuple, cfg: RWKV7Config):
    """block_forward(*args) in grad mode under cfg.remat / remat_policy."""
    if cfg.remat_policy not in REMAT_POLICIES:
        raise ValueError(f"remat_policy {cfg.remat_policy!r}: one of {REMAT_POLICIES}")
    if not cfg.remat:
        return block_forward(*args)
    if cfg.remat_policy == "wkv":
        return _block(lambda fn, *a: checkpoint(fn, *a, use_reentrant=False), *args)
    if cfg.remat_policy is None:
        return checkpoint(block_forward, *args, use_reentrant=False)
    batched = cfg.remat_policy == "dots"
    return checkpoint(block_forward, *args, use_reentrant=False,
                      context_fn=lambda: _dots_context(batched))


def forward(
    params: Params, cfg: RWKV7Config,
    input_ids: Optional[torch.Tensor] = None,
    inputs_embeds: Optional[torch.Tensor] = None,
    attention_mask: Optional[torch.Tensor] = None,
    resets: Optional[torch.Tensor] = None,
    state: Optional[Params] = None,
    return_state: bool = False,
):
    """Full-sequence forward. Returns hidden (B,T,C) [and the stacked
    state]; the layers run as a Python loop over the stacked parameters.
    No state means a zero one. In grad mode each block is rematerialised
    as ``cfg.remat`` / ``cfg.remat_policy`` ask (``_remat_block``; the
    default replays the whole block under ``torch.utils.checkpoint``, the
    JAX package's default full per-block remat). A tower without an
    embedding (``with_embedding=False``) takes only inputs_embeds."""
    if inputs_embeds is None:
        if "embedding" not in params:
            raise ValueError("rwkv7.forward: this tower has no embedding; pass inputs_embeds")
        inputs_embeds = params["embedding"][input_ids]
    x = inputs_embeds.to(cfg.dtype)
    x = layer_norm(x, params["ln0_scale"], params["ln0_bias"], cfg.norm_eps)
    v_first = torch.zeros_like(x)
    new: Dict[str, list] = {"att_x": [], "wkv": [], "ffn_x": []}
    # unbind: one view a layer whose backward stacks the layer gradients once
    layers = _unbind(params["blocks"], cfg.num_layers)
    for l, bp in enumerate(layers):
        st = None if state is None else {key: state[key][l] for key in new}
        args = (bp, cfg, x, attention_mask, resets, l, v_first, st)
        if torch.is_grad_enabled():
            x, v_first, new_st = _remat_block(args, cfg)
        else:
            x, v_first, new_st = block_forward(*args)
        for key in new:
            new[key].append(new_st[key])
    x = layer_norm(x, params["ln_out_scale"], params["ln_out_bias"], cfg.norm_eps)
    if return_state:
        return x, {key: torch.stack(vals) for key, vals in new.items()}
    return x


# ---------------------------------------------------------------------------
# int8 weights
# ---------------------------------------------------------------------------


def q8(w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-output-channel symmetric int8 of w (..., in, out): returns
    (q int8, scale f32 (..., 1, out)), scale = max(amax, 1e-8) / 127 —
    bit for bit rwkvtts_tpu/ops/decode_mega.py::_q8_np."""
    wf = w.float()
    amax = wf.abs().amax(-2, keepdim=True)
    scale = _true_div(torch.clamp_min(amax, 1e-8), 127.0)
    q = torch.clamp(torch.round(wf / scale), -127, 127).to(torch.int8)
    return q, scale


def _true_div(x: torch.Tensor, d: float) -> torch.Tensor:
    """x / d correctly rounded on every device: CUDA divides a tensor by a
    Python scalar as a multiplication by its reciprocal, which can land an
    ulp away from the division the CPU and the JAX package make."""
    return x / x.new_tensor(d)


def _quantize_int8(w: torch.Tensor) -> Dict[str, torch.Tensor]:
    """The JAX package's _quantize_int8: q int8 and bf16 scales."""
    q, scale = q8(w)
    return {"q": q, "s": scale.to(torch.bfloat16)}


def _quantize_int4(w: torch.Tensor, group: int = 64) -> Dict[str, torch.Tensor]:
    """The JAX package's _quantize_int4, bit for bit: group-wise symmetric
    int4 along the input dim of w (..., in, out), two nibbles a byte (the
    first half of the input dim in the low nibble, the second half in the
    high one), scale = max(amax, 1e-8) / 7 a group of `group` input rows,
    stored bf16 as (..., in / group, out). The group halves until
    in % (2 group) == 0."""
    wf = w.float()
    I = wf.shape[-2]
    while group > 1 and I % (2 * group) != 0:
        group //= 2
    if I % (2 * group) != 0:
        raise ValueError(f"_quantize_int4: input dim {I} is odd")
    g = wf.reshape(*wf.shape[:-2], I // group, group, wf.shape[-1])
    scale = _true_div(torch.clamp_min(g.abs().amax(-2, keepdim=True), 1e-8), 7.0)
    q = torch.clamp(torch.round(g / scale), -7, 7).to(torch.int32).reshape(wf.shape)
    lo, hi = q[..., :I // 2, :], q[..., I // 2:, :]
    # the byte's bits in int32 (shifts of negative int8 values are not the
    # same function on every device), then two's complement into int8
    byte = (lo & 0x0F) | ((hi & 0x0F) << 4)
    return {"q4": ((byte ^ 0x80) - 0x80).to(torch.int8),
            "s": scale.squeeze(-2).to(torch.bfloat16)}


def _deq_int4(p: Dict[str, torch.Tensor], dt) -> torch.Tensor:
    """The weight of an int4 pack in `dt`: both nibbles sign-extended,
    times their group's scale (in f32, as the JAX package's _deq_int4)."""
    byte = p["q4"].to(torch.int32) & 0xFF
    nibble = lambda n: (n ^ 8) - 8  # a 4-bit two's complement value, sign-extended
    q = torch.cat([nibble(byte & 0x0F), nibble(byte >> 4)], -2)
    scale = p["s"]
    n_groups, I = scale.shape[-2], q.shape[-2]
    g = q.reshape(*q.shape[:-2], n_groups, I // n_groups, q.shape[-1])
    return (g.float() * scale[..., :, None, :].float()).reshape(q.shape).to(dt)


def _qmat(att: Params, name: str, dt) -> torch.Tensor:
    """Effective weight for `name`: int8 / int4 storage is dequantized on
    the fly (int8: q * s in the model dtype; int4: ``_deq_int4``), as the
    JAX package's _qmat; the product is then ``torch.matmul`` on the
    dequantized copy, as JAX leaves it to XLA outside any Pallas kernel."""
    q4 = f"{name}_q4"
    if q4 in att:
        return _deq_int4(att[q4], dt)
    qk = f"{name}_q8"
    if qk in att:
        p = att[qk]
        return p["q"].to(dt) * p["s"].to(dt)
    return att[name].to(dt)


# ---------------------------------------------------------------------------
# Decode
# ---------------------------------------------------------------------------

_STATE_KEYS = ("att_x", "wkv", "ffn_x")


def pack_decode_params(params: Params, cfg: RWKV7Config, quantize_int8: bool = False,
                       quantize_int4: bool = False, int4_group: int = 64,
                       fuse_projections: bool = True) -> Params:
    """Precompute the decode weights (once, amortized): with
    fuse_projections the seven input projections of a block collapse into
    two products, (xn + xx x_s) @ W_s = xn @ W_s + xx @ (diag(x_s) W_s),
    against blocks.att.fused_a / fused_b of shape (L, C, 3C+Dw+Da+Dv+Dg)
    in cfg.dtype; with quantize_int8 those two (or, unfused, the r/k/v
    projections), the output and the FFN matrices are also stored as
    per-output-channel int8 (``_quantize_int8``); with quantize_int4 the
    fused pair, the output and the FFN matrices as group-wise int4 of
    `int4_group` input rows (``_quantize_int4``; fused projections only).
    The original weights stay in the tree (the prefill reads them)."""
    if quantize_int8 and quantize_int4:
        raise ValueError("quantize_int8 and quantize_int4 are exclusive")
    if quantize_int4 and not fuse_projections:
        raise ValueError("quantize_int4 requires fused projections")
    att, ffn = params["blocks"]["att"], params["blocks"]["ffn"]
    out = dict(params)
    out["blocks"] = dict(params["blocks"])
    new_att, new_ffn = dict(att), dict(ffn)
    if not fuse_projections:
        if not quantize_int8:
            return params  # decode_step's unfused branch reads the originals
        for name in ("receptance", "key", "value", "output"):
            new_att[f"{name}_q8"] = _quantize_int8(att[name])
    else:
        ws = [("x_r", "receptance"), ("x_k", "key"), ("x_v", "value"), ("x_w", "w1"),
              ("x_a", "a1"), ("x_v", "v1"), ("x_g", "g1")]
        fused_a = torch.cat([att[w] for _, w in ws], -1).to(cfg.dtype)
        fused_b = torch.cat([att[x][:, :, None] * att[w] for x, w in ws], -1).to(cfg.dtype)
        if quantize_int4:
            q4 = lambda w: _quantize_int4(w, int4_group)
            new_att["fused_a_q4"], new_att["fused_b_q4"] = q4(fused_a), q4(fused_b)
            new_att["output_q4"] = q4(att["output"])
            new_ffn["key_q4"], new_ffn["value_q4"] = q4(ffn["key"]), q4(ffn["value"])
        elif quantize_int8:
            new_att["fused_a_q8"] = _quantize_int8(fused_a)
            new_att["fused_b_q8"] = _quantize_int8(fused_b)
            new_att["output_q8"] = _quantize_int8(att["output"])
        else:
            new_att["fused_a"], new_att["fused_b"] = fused_a, fused_b
    if quantize_int8:
        new_ffn["key_q8"] = _quantize_int8(ffn["key"])
        new_ffn["value_q8"] = _quantize_int8(ffn["value"])
    out["blocks"]["att"], out["blocks"]["ffn"] = new_att, new_ffn
    return out


_NORM_KEYS = ("ln1_scale", "ln1_bias", "ln2_scale", "ln2_bias")


def layer_decode_views(params: Params, cfg: RWKV7Config) -> Params:
    """The stacked block parameters as a tuple of per-layer views, sliced
    once outside the decode loop; the norms' scales and biases also get an
    f32 copy (exact), which the step's norms read."""
    if isinstance(params.get("blocks"), tuple):
        return params
    layers = []
    for bp in _unbind(params["blocks"], cfg.num_layers):
        att = bp["att"]
        layers.append({**bp, **{k: bp[k].float() for k in _NORM_KEYS},
                       "att": {**att, "ln_x_scale": att["ln_x_scale"].float(),
                               "ln_x_bias": att["ln_x_bias"].float()}})
    return {**params, "blocks": tuple(layers)}


def _ln(x: torch.Tensor, scale, bias, eps: float) -> torch.Tensor:
    """layer_norm (f32 statistics, output in x's dtype) as one fused op."""
    return F.layer_norm(x.float(), x.shape[-1:], scale.float(), bias.float(), eps).to(x.dtype)


def pack_decode_state(state, cfg: RWKV7Config) -> tuple:
    """The stacked model state (leaves (L, ...)) -> a tuple of per-layer
    dicts, each leaf its own contiguous buffer (which the decode step, with
    ``decode_wkv_packed``, updates in place), the WKV state in bf16 under
    ``decode_state_bf16``. A tuple already in that form comes back as is."""
    wkv_dt = torch.bfloat16 if cfg.decode_state_bf16 else None

    def layer(st):
        wkv = st["wkv"]
        return {"att_x": st["att_x"].contiguous(),
                "wkv": wkv.to(wkv_dt or wkv.dtype).contiguous(),
                "ffn_x": st["ffn_x"].contiguous()}

    if isinstance(state, tuple):
        if wkv_dt is None or all(st["wkv"].dtype == wkv_dt for st in state):
            return state
        return tuple(layer(st) for st in state)
    L = state["att_x"].shape[0]
    return tuple(layer({k: state[k][l].clone() for k in _STATE_KEYS}) for l in range(L))


def unpack_decode_state(state, cfg: RWKV7Config) -> Params:
    """Inverse of pack_decode_state: a tuple of layers -> stacked leaves."""
    if isinstance(state, tuple):
        return {k: torch.stack([st[k] for st in state]) for k in _STATE_KEYS}
    return state


def decode_step(params: Params, cfg: RWKV7Config, x: torch.Tensor, state
                ) -> Tuple[torch.Tensor, Any]:
    """One autoregressive step. x: (B, C) token embeddings (pre-ln0).

    `params` may hold the stacked blocks or their per-layer views
    (``layer_decode_views``), and `state` the stacked leaves or the tuple
    of ``pack_decode_state``; the new state comes back in the form it was
    given. With a tuple and ``cfg.decode_wkv_packed`` each layer's WKV
    state is updated in place. Blocks carrying fused_a/fused_b (or their
    int8 forms, ``pack_decode_params``) take the two-product branch, the
    others the seven-product one. Inside the layers the norms are
    PyTorch's fused layer_norm / group_norm / normalize on f32 (the same
    function as ops/norm.py, one op each: the eager step is bound by the
    host's op dispatch). Returns (hidden (B, C) in cfg.dtype, state)."""
    B, C = x.shape
    H, N, L, dt = cfg.num_heads, cfg.head_size, cfg.num_layers, cfg.dtype
    blocks = params["blocks"]
    layers = blocks if isinstance(blocks, tuple) else _unbind(blocks, L)
    layered = isinstance(state, tuple)
    states = state if layered else [{k: state[k][l] for k in _STATE_KEYS} for l in range(L)]
    inplace = layered and cfg.decode_wkv_packed
    cast = lambda p: p.to(dt)
    heads = lambda u: u.reshape(B, H, N).contiguous()

    x = layer_norm(x.to(dt), params["ln0_scale"], params["ln0_bias"], cfg.norm_eps)
    v_first = torch.zeros_like(x)
    new_states = []
    for l, (bp, st) in enumerate(zip(layers, states)):
        att = bp["att"]
        xn = _ln(x, bp["ln1_scale"], bp["ln1_bias"], cfg.norm_eps)
        xx = st["att_x"].to(dt) - xn
        if "fused_a" in att or "fused_a_q8" in att or "fused_a_q4" in att:
            fused = xn @ _qmat(att, "fused_a", dt) + xx @ _qmat(att, "fused_b", dt)
            sizes = [C, C, C, cfg.decay_lora, cfg.a_lora, cfg.v_lora]
            r, k, v, w_h, a_h, v_h, g_h = torch.split(
                fused, sizes + [fused.shape[-1] - sum(sizes)], -1)  # the gate takes the rest
            w_raw = -F.softplus(-(cast(att["w0"]) + torch.tanh(w_h) @ cast(att["w2"]))) - 0.5
            v_mix = torch.sigmoid(cast(att["v0"]) + v_h @ cast(att["v2"]))
            a = torch.sigmoid(cast(att["a0"]) + a_h @ cast(att["a2"]))
            g = torch.sigmoid(g_h) @ cast(att["g2"])
        else:
            xr, xw, xk, xv, xa, xg = (xn + xx * cast(att[f"x_{s}"]) for s in "rwkvag")
            r = xr @ _qmat(att, "receptance", dt)
            w_raw = -F.softplus(
                -(cast(att["w0"]) + _lora(xw, cast(att["w1"]), cast(att["w2"]), torch.tanh))
            ) - 0.5
            k = xk @ _qmat(att, "key", dt)
            v = xv @ _qmat(att, "value", dt)
            v_mix = torch.sigmoid(cast(att["v0"]) + _lora(xv, cast(att["v1"]), cast(att["v2"])))
            a = torch.sigmoid(cast(att["a0"]) + _lora(xa, cast(att["a1"]), cast(att["a2"])))
            g = _lora(xg, cast(att["g1"]), cast(att["g2"]), torch.sigmoid)
        if l == 0:
            v_first = v
        else:
            v = v + (v_first - v) * v_mix
        kk = F.normalize((k * cast(att["k_k"])).reshape(B, H, N).float(), dim=-1)
        kk = kk.reshape(B, C).to(dt)
        k = k * (1 + (a - 1) * cast(att["k_a"]))

        y, wkv_state = wkv7_ops.wkv7_step(
            st["wkv"], heads(r), heads(w_raw), heads(k), heads(v), heads(-kk), heads(kk * a),
            inplace=inplace)
        y = F.group_norm(y.reshape(B, C).float(), H, att["ln_x_scale"].float(),
                         att["ln_x_bias"].float(), cfg.ln_x_eps).to(dt)
        bonus = ((r.reshape(B, H, N) * k.reshape(B, H, N) * cast(att["r_k"]))
                 .sum(-1, keepdim=True) * v.reshape(B, H, N)).reshape(B, C)
        x = x + ((y + bonus) * g) @ _qmat(att, "output", dt)

        ffn = bp["ffn"]
        xn2 = _ln(x, bp["ln2_scale"], bp["ln2_bias"], cfg.norm_eps)
        xx2 = st["ffn_x"].to(dt) - xn2
        kf = torch.square(torch.relu((xn2 + xx2 * cast(ffn["x_k"])) @ _qmat(ffn, "key", dt)))
        x = x + kf @ _qmat(ffn, "value", dt)
        new_states.append({"att_x": xn, "wkv": wkv_state, "ffn_x": xn2})
    x = layer_norm(x, params["ln_out_scale"], params["ln_out_bias"], cfg.norm_eps)
    if layered:
        return x, tuple(new_states)
    return x, {k: torch.stack([st[k] for st in new_states]) for k in _STATE_KEYS}
