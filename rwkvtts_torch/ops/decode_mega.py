"""Whole-model RWKV-7 decode step for one row (B = 1) with int8 weights
(counterpart of rwkvtts_tpu/ops/decode_mega.py, the Cosy streaming step).

``decode_step_mega`` is the wrapper: tensors on a CUDA device launch the
hand-written kernels of ``csrc/decode_b1.cu`` (which replace the TPU kernel
``_mega_kernel``); tensors on the CPU take ``decode_step_plain``, which
keeps every rounding point of the TPU kernel (decode_mega.py:363-605):
the token-shift states, the residual, the r/k/v rows and the lora hiddens
stay f32; each product's lhs is cast to the matmul dtype (bf16, or f32
for an f32 config); the lora-out products take bf16 weights and a
bf16-cast lhs; the WKV state is written in the carry dtype. The state is
updated in place and returned.

It differs from the B=64 step (``decode_mega_b64``) in what it computes,
not only in the batch: the lora-out weights are bf16 (not int8 with
scales), the shift states are carried f32 and nothing between the
products is rounded to bf16.

Packing (``pack_mega``) quantizes as the JAX package's ``_q8_np`` does,
per original matrix, scales rounded to bf16, in a natural layout:
  rkv_q (L, C, 3C), li_q (L, C, 512), out_q (L, C, C), fk_q (L, C, 4C),
  fv_q (L, 4C, C) int8 with their (L, N) f32 scales (see decode_mega_b64);
  lo (L, 512, C) bf16 lora-out, groups (v, w, a, g) of 128 rows, zero rows
  on the padding (they kill the padded lanes, sigmoid(0) = 0.5 included);
  smalls (L, 24, C) f32; ln0_*, ln_out_* (C,) f32.
The decode state is {'att_x' (L, 1, C) f32, 'wkv' (L, 1, H, 64, 64) in
the carry dtype, 'ffn_x' (L, 1, C) f32}: the natural layout, not the TPU's
head pairs (``bridge.wkv_from_head_pairs`` converts at the test boundary).
"""
from __future__ import annotations

import ctypes
from typing import Dict, Tuple

import torch

from rwkvtts_torch import _build
from rwkvtts_torch.ops.decode_mega_b64 import _LG, _SM, LORA_PAD, NS, _softplus, pack_common
from rwkvtts_torch.ops.norm import layer_norm

Params = Dict[str, torch.Tensor]

# CUDA kernel launches made by decode_step_mega: in all, and by kernel (the
# order of decode_b1_step's counts). reset_launches() zeroes both.
KERNELS = ("ln_mix", "gemv", "glue")
launches = 0
kernel_launches = dict.fromkeys(KERNELS, 0)


def reset_launches() -> None:
    global launches
    launches = 0
    kernel_launches.update(dict.fromkeys(KERNELS, 0))


def pack_mega(params: Params, cfg) -> Params:
    """Quantize and pack the backbone parameters (on their device)."""
    C, L = cfg.hidden_size, cfg.num_layers
    att = params["blocks"]["att"]
    mega = pack_common(params, cfg)
    lo = torch.zeros(L, 4 * LORA_PAD, C, dtype=torch.bfloat16, device=mega["rkv_q"].device)
    for gi, name in enumerate(_LG):
        w = att[f"{name}2"]
        lo[:, gi * LORA_PAD:gi * LORA_PAD + w.shape[-2]] = w.to(torch.bfloat16)
    return {**mega, "lo": lo}


def pack_state(state: Params, wkv_dtype: torch.dtype) -> Params:
    """Prefill state (leaves (L, 1, ...)) -> the decode step's state: shift
    states f32, the WKV state in `wkv_dtype` (bf16 is the deployed carry,
    f32 the exact one), every leaf contiguous."""
    return {
        "att_x": state["att_x"].float().contiguous(),
        "wkv": state["wkv"].to(wkv_dtype).contiguous(),
        "ffn_x": state["ffn_x"].float().contiguous(),
    }


def unpack_state(mstate: Params, dtype: torch.dtype) -> Params:
    """The decode step's state -> the model-state form: shift states in
    `dtype`, the WKV state f32."""
    return {"att_x": mstate["att_x"].to(dtype), "wkv": mstate["wkv"].float(),
            "ffn_x": mstate["ffn_x"].to(dtype)}


def matmul_dtype(cfg) -> torch.dtype:
    """The products' lhs dtype: f32 for an f32 config, else bf16 (the TPU
    kernel's mm_dtype)."""
    return torch.float32 if cfg.dtype == torch.float32 else torch.bfloat16


# ---------------------------------------------------------------------------
# Plain version
# ---------------------------------------------------------------------------


def decode_step_plain(mega: Params, cfg, x: torch.Tensor, state: Params
                      ) -> Tuple[torch.Tensor, Params]:
    """The decode step in plain PyTorch, f32 math with the TPU kernel's
    rounding points; state updated in place."""
    C, L, H = cfg.hidden_size, cfg.num_layers, cfg.num_heads
    eps = cfg.norm_eps
    mm_dt = matmul_dtype(cfg)
    cast = lambda t: t.to(mm_dt).float()
    heads = lambda u: u.reshape(H, 64)
    x_res = layer_norm(x.float(), mega["ln0_scale"], mega["ln0_bias"], eps)
    v_first = None
    for l in range(L):
        sm = {k: mega["smalls"][l, i] for k, i in _SM.items()}

        def mm(lhs, q, s):  # mm-dtype lhs @ int8, f32 accumulate, scaled
            return (cast(lhs) @ q.float()) * s

        def shift_mix(key, scale, bias):
            xn = layer_norm(x_res, sm[scale], sm[bias], eps)
            xx = state[key][l].float() - xn
            state[key][l] = xn.to(state[key].dtype)
            return lambda row: xn + xx * row

        mix = shift_mix("att_x", "ln1_s", "ln1_b")
        r, k0, v_row = (mm(mix(sm[f"x_{n}"]), mega["rkv_q"][l, :, i * C:(i + 1) * C],
                           mega["rkv_s"][l, i * C:(i + 1) * C]) for i, n in enumerate("rkv"))
        lora = {}
        for gi, n in enumerate(_LG):
            cols = slice(gi * LORA_PAD, (gi + 1) * LORA_PAD)
            lh = mm(mix(sm[f"x_{n}"]), mega["li_q"][l, :, cols], mega["li_s"][l, cols])
            act = {"w": torch.tanh, "g": torch.sigmoid}.get(n, lambda t: t)
            lora[n] = cast(act(lh)) @ cast(mega["lo"][l, cols])

        wd = torch.exp(-torch.exp(-_softplus(-(sm["w0"] + lora["w"])) - 0.5))
        a_row = torch.sigmoid(sm["a0"] + lora["a"])
        if l == 0:
            v_eff = v_first = v_row
        else:
            v_eff = v_row + (v_first - v_row) * torch.sigmoid(sm["v0"] + lora["v"])
        kk = heads(k0 * sm["k_k"])
        k_eff = heads(k0 * (1.0 + (a_row - 1.0) * sm["k_a"]))
        kkn = kk * (1.0 / torch.sqrt(torch.clamp_min((kk * kk).sum(-1, keepdim=True), 1e-24)))
        z, bb = -kkn, kkn * heads(a_row)

        S = state["wkv"][l, 0].float()  # (H, 64, 64), rows the value dim
        sa = torch.einsum("hij,hj->hi", S, z)
        S = S * heads(wd)[:, None, :] + sa[..., None] * bb[:, None, :] \
            + heads(v_eff)[..., None] * k_eff[:, None, :]
        state["wkv"][l, 0] = S.to(state["wkv"].dtype)
        y = torch.einsum("hij,hj->hi", S, heads(r))
        m = y.mean(-1, keepdim=True)
        var = ((y - m) ** 2).mean(-1, keepdim=True)
        y_n = (y - m) * torch.rsqrt(var + cfg.ln_x_eps) * heads(sm["ln_x_s"]) + heads(sm["ln_x_b"])
        s_bh = (heads(r) * k_eff * heads(sm["r_k"])).sum(-1, keepdim=True)
        y_g = ((y_n + s_bh * heads(v_eff)) * heads(lora["g"])).reshape(1, C)
        x_res = x_res + mm(y_g, mega["out_q"][l], mega["out_s"][l])

        mix = shift_mix("ffn_x", "ln2_s", "ln2_b")
        acc_ffn = torch.square(torch.relu(mm(mix(sm["ffn_x_k"]), mega["fk_q"][l], mega["fk_s"][l])))
        x_res = x_res + mm(acc_ffn, mega["fv_q"][l], mega["fv_s"][l])
    h = layer_norm(x_res, mega["ln_out_scale"], mega["ln_out_bias"], eps)
    return h, state


# ---------------------------------------------------------------------------
# Wrapper
# ---------------------------------------------------------------------------


_MEGA_KEYS = ("rkv_q", "rkv_s", "li_q", "li_s", "lo", "out_q", "out_s",
              "fk_q", "fk_s", "fv_q", "fv_s", "smalls")
_STATE_DTYPES = {torch.float32: 0, torch.bfloat16: 1}  # the kernel's DT_F32 / DT_BF16


def decode_step_mega(mega: Params, cfg, x: torch.Tensor, state: Params
                     ) -> Tuple[torch.Tensor, Params]:
    """One decode step. x (1, C) token embedding (pre-ln0); state
    {'att_x' (L,1,C) f32, 'wkv' (L,1,H,64,64) f32 or bf16, 'ffn_x'
    (L,1,C) f32}, updated in place. Returns (hidden (1, C) f32 after
    ln_out, state)."""
    dev = x.device.type
    if dev == "cpu":
        return decode_step_plain(mega, cfg, x, state)
    if dev != "cuda":
        raise ValueError(f"decode_step_mega: no implementation for device {x.device}")
    return _launch(mega, cfg, x, state)


def _launch(mega, cfg, x, state):
    global launches
    C, L, H = cfg.hidden_size, cfg.num_layers, cfg.num_heads
    if matmul_dtype(cfg) != torch.bfloat16:
        raise ValueError("decode_step_mega: the CUDA kernel takes a bf16 lhs only "
                         f"(the config's dtype is {cfg.dtype})")
    x = x.float().contiguous()
    if x.shape != (1, C):
        raise ValueError(f"decode_step_mega: x is {tuple(x.shape)}, want {(1, C)}")
    wkv_dt = state["wkv"].dtype
    if wkv_dt not in _STATE_DTYPES:
        raise ValueError(f"decode_step_mega: WKV state dtype {wkv_dt} (want f32 or bf16)")
    want = {"att_x": ((L, 1, C), torch.float32), "ffn_x": ((L, 1, C), torch.float32),
            "wkv": ((L, 1, H, 64, 64), wkv_dt)}
    shapes = {
        "rkv_q": (L, C, 3 * C), "rkv_s": (L, 3 * C),
        "li_q": (L, C, 4 * LORA_PAD), "li_s": (L, 4 * LORA_PAD),
        "lo": (L, 4 * LORA_PAD, C), "out_q": (L, C, C), "out_s": (L, C),
        "fk_q": (L, C, 4 * C), "fk_s": (L, 4 * C), "fv_q": (L, 4 * C, C), "fv_s": (L, C),
        "smalls": (L, NS, C),
    }
    for name, (shape, dtype) in want.items():
        t = state[name]
        if t.shape != shape or t.dtype != dtype or t.device != x.device or not t.is_contiguous():
            raise ValueError(f"decode_step_mega: state[{name!r}] must be contiguous "
                             f"{shape} {dtype} on {x.device}")
    for name, shape in shapes.items():
        t = mega[name]
        dtype = {"lo": torch.bfloat16}.get(name, torch.int8 if name.endswith("_q") else torch.float32)
        if t.shape != shape or t.dtype != dtype or t.device != x.device or not t.is_contiguous():
            raise ValueError(f"decode_step_mega: mega[{name!r}] must be contiguous "
                             f"{shape} {dtype} on {x.device}")
    for name in ("ln0_scale", "ln0_bias", "ln_out_scale", "ln_out_bias"):
        t = mega[name]
        if t.shape != (C,) or t.dtype != torch.float32 or t.device != x.device:
            raise ValueError(f"decode_step_mega: mega[{name!r}] must be ({C},) f32")

    lib = _build.library()
    ws = torch.empty(lib.decode_b1_workspace_bytes(C), dtype=torch.uint8, device=x.device)
    h = torch.empty(1, C, dtype=torch.float32, device=x.device)
    ptr = lambda t: ctypes.c_void_p(t.data_ptr())
    counts = (ctypes.c_int * len(KERNELS))()
    err = lib.decode_b1_step(
        L, C, _STATE_DTYPES[wkv_dt], cfg.norm_eps, cfg.ln_x_eps, ptr(x), ptr(h),
        ptr(mega["ln0_scale"]), ptr(mega["ln0_bias"]),
        ptr(mega["ln_out_scale"]), ptr(mega["ln_out_bias"]),
        *(ptr(mega[k]) for k in _MEGA_KEYS),
        ptr(state["att_x"]), ptr(state["ffn_x"]), ptr(state["wkv"]), ptr(ws),
        counts, ctypes.c_void_p(torch.cuda.current_stream(x.device).cuda_stream),
    )
    for name, n in zip(KERNELS, counts):
        kernel_launches[name] += n
        launches += n
    _build.check(err, "decode_b1_step")
    return h, state
