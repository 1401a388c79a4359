"""Whole-model RWKV-7 decode step for a batch of 64 rows with int8 weights
and a bf16 state (counterpart of rwkvtts_tpu/ops/decode_mega_b64.py).

``decode_step_mega_b64`` is the wrapper: tensors on a CUDA device launch
the hand-written kernels of ``csrc/decode_b64.cu`` (which replace the TPU
kernel ``_mega_b64_kernel``); tensors on the CPU take
``decode_step_plain``, which keeps every rounding point of the TPU kernel
(decode_mega_b64.py:630-642), so kernel and plain version agree to a
tight bound. Either way the state is updated in place (it is large: 0.2 GB
at 1024 x 24) and returned.

Packing (``pack_mega_b64``) quantizes every matrix exactly as the JAX
package does (``rwkv7.q8`` == ``_q8_np``) but keeps a natural layout: one
(L, K, N) int8 array per product, not the TPU's tile stream.
  rkv_q  (L, C, 3C)  [W_r | W_k | W_v]          rkv_s (L, 3C)
  li_q   (L, C, 512) lora-in [v | w | a | g]    li_s  (L, 512)
  lo_q   (L, 512, C) lora-out, same groups      lo_s  (L, 4, C)
  out_q  (L, C, C)   out_s (L, C)
  fk_q   (L, C, 4C)  fk_s  (L, 4C)
  fv_q   (L, 4C, C)  fv_s  (L, C)
  smalls (L, 24, C) f32, rows as _SM; ln0_*/ln_out_* (C,) f32.
Every lora width is zero-padded to 128. The product scales are rounded to
bf16 (as the TPU ``s_stream``) and stored as f32; the lora-out scales stay
f32 (as the TPU ``lo_scales``).

On the card each layer is 8 launches (8 L + 2 a step): ln1, r/k/v with
lora-in, lora-out, the WKV glue, the output projection, ln2, FFN key and
FFN value. ``launch_plan`` says how each product is cut (128-column
tiles, K pieces run as one thread block cluster) and what shared memory a
CTA takes; the kernel refuses a plan it cannot run.
"""
from __future__ import annotations

import ctypes
from typing import Dict, Tuple

import torch

from rwkvtts_torch import _build
from rwkvtts_torch.models.rwkv7 import q8
from rwkvtts_torch.ops.norm import layer_norm

Params = Dict[str, torch.Tensor]

B = 64           # rows of a decode step
LORA_PAD = 128   # every lora width padded to this
NS = 24          # rows of the smalls block
# smalls rows (rwkvtts_tpu/ops/decode_mega.py::_SM)
_SM = {
    "ln1_s": 0, "ln1_b": 1, "ln2_s": 2, "ln2_b": 3,
    "x_r": 4, "x_k": 5, "x_v": 6, "x_w": 7, "x_a": 8, "x_g": 9,
    "w0": 10, "a0": 11, "v0": 12, "k_k": 13, "k_a": 14, "r_k": 15,
    "ln_x_s": 16, "ln_x_b": 17, "ffn_x_k": 18,
}
# lora groups in packed order
_LG = ("v", "w", "a", "g")

# CUDA kernel launches made by decode_step_mega_b64: in all, and by kernel
# (the order of decode_b64_step's counts). reset_launches() zeroes both.
# A step makes 2 L + 2 ln_rows, 5 L gemm_i8 and L wkv_glue launches.
KERNELS = ("ln_rows", "gemm_i8", "wkv_glue")
launches = 0
kernel_launches = dict.fromkeys(KERNELS, 0)


def reset_launches() -> None:
    global launches
    launches = 0
    kernel_launches.update(dict.fromkeys(KERNELS, 0))


def _smalls_source(blocks: Params) -> Dict[str, torch.Tensor]:
    att, ffn = blocks["att"], blocks["ffn"]
    return {
        "ln1_s": blocks["ln1_scale"], "ln1_b": blocks["ln1_bias"],
        "ln2_s": blocks["ln2_scale"], "ln2_b": blocks["ln2_bias"],
        "x_r": att["x_r"], "x_w": att["x_w"], "x_k": att["x_k"],
        "x_v": att["x_v"], "x_a": att["x_a"], "x_g": att["x_g"],
        "w0": att["w0"], "a0": att["a0"], "v0": att["v0"],
        "k_k": att["k_k"], "k_a": att["k_a"], "r_k": att["r_k"],
        "ln_x_s": att["ln_x_scale"], "ln_x_b": att["ln_x_bias"],
        "ffn_x_k": ffn["x_k"],
    }


class MegaPack(dict):
    """The packed weights. The CUDA route takes only a MegaPack: it checks
    the tensors on the pack's first step and keeps the (L, C, device) it
    checked in ``checked``; replacing an entry clears it."""

    checked = None

    def __setitem__(self, key, value):
        self.checked = None
        super().__setitem__(key, value)


def pack_mega_b64(params: Params, cfg) -> Params:
    """Quantize and pack the backbone parameters (on their device)."""
    C, L = cfg.hidden_size, cfg.num_layers
    att = params["blocks"]["att"]
    mega = pack_common(params, cfg)
    dev = mega["rkv_q"].device
    lo_q = torch.zeros(L, 4 * LORA_PAD, C, dtype=torch.int8, device=dev)
    lo_s = torch.zeros(L, 4, C, device=dev)
    for gi, name in enumerate(_LG):
        q, s = q8(att[f"{name}2"])
        lo_q[:, gi * LORA_PAD:gi * LORA_PAD + q.shape[-2]] = q
        lo_s[:, gi] = s.reshape(L, C)
    return MegaPack(mega, lo_q=lo_q, lo_s=lo_s)


def pack_common(params: Params, cfg) -> Params:
    """What the B=64 and the B=1 decode steps pack alike: every int8
    product but the lora-out, its bf16-rounded scales, the smalls block and
    the ln0 / ln_out vectors."""
    C, L = cfg.hidden_size, cfg.num_layers
    if cfg.head_size != 64 or C % 128:
        raise ValueError("the decode step takes head size 64 and C % 128 == 0")
    blocks = params["blocks"]
    att, ffn = blocks["att"], blocks["ffn"]
    dev = att["receptance"].device
    stream_scale = lambda s: s.to(torch.bfloat16).float().reshape(L, -1)

    def product(*mats):
        q, s = q8(torch.cat(mats, -1))  # per-output-channel: concat is free
        return q.contiguous(), stream_scale(s)

    li_q = torch.zeros(L, C, 4 * LORA_PAD, dtype=torch.int8, device=dev)
    li_s = torch.ones(L, 4 * LORA_PAD, device=dev)
    for gi, name in enumerate(_LG):
        q, s = q8(att[f"{name}1"])
        d = q.shape[-1]
        if d > LORA_PAD:
            raise ValueError(f"lora {name} width {d} > {LORA_PAD}")
        li_q[:, :, gi * LORA_PAD:gi * LORA_PAD + d] = q
        li_s[:, gi * LORA_PAD:gi * LORA_PAD + d] = stream_scale(s)

    smalls = torch.zeros(L, NS, C, device=dev)
    for name, src in _smalls_source(blocks).items():
        smalls[:, _SM[name]] = src.float().reshape(L, C)

    rkv_q, rkv_s = product(att["receptance"], att["key"], att["value"])
    out_q, out_s = product(att["output"])
    fk_q, fk_s = product(ffn["key"])
    fv_q, fv_s = product(ffn["value"])
    f32 = lambda t: t.float().contiguous()
    return {
        "rkv_q": rkv_q, "rkv_s": rkv_s, "li_q": li_q, "li_s": li_s,
        "out_q": out_q, "out_s": out_s,
        "fk_q": fk_q, "fk_s": fk_s, "fv_q": fv_q, "fv_s": fv_s,
        "smalls": smalls,
        "ln0_scale": f32(params["ln0_scale"]), "ln0_bias": f32(params["ln0_bias"]),
        "ln_out_scale": f32(params["ln_out_scale"]),
        "ln_out_bias": f32(params["ln_out_bias"]),
    }


def pack_state(state: Params) -> Params:
    """Prefill state -> the decode step's state: every leaf contiguous bf16
    in the natural layout (wkv (L, B, H, 64, 64))."""
    return {k: v.to(torch.bfloat16).contiguous() for k, v in state.items()}


# ---------------------------------------------------------------------------
# Plain version
# ---------------------------------------------------------------------------


def _rb(t: torch.Tensor) -> torch.Tensor:
    """Round to bf16, keep f32 (a rounding point of the TPU kernel)."""
    return t.to(torch.bfloat16).float()


def _softplus(z):
    # the TPU kernel's exp/log form (ops/decode_mega.py::_softplus)
    return torch.relu(z) + torch.log(1.0 + torch.exp(-z.abs()))


def decode_step_plain(mega: Params, cfg, x: torch.Tensor, state: Params
                      ) -> Tuple[torch.Tensor, Params]:
    """The decode step in plain PyTorch, f32 math with the kernel's bf16
    rounding points; state updated in place."""
    C, L, H = cfg.hidden_size, cfg.num_layers, cfg.num_heads
    eps = cfg.norm_eps
    Bn = x.shape[0]
    heads = lambda u: u.reshape(*u.shape[:-1], H, 64)
    x_res = layer_norm(x.float(), mega["ln0_scale"], mega["ln0_bias"], eps)
    v_first = None
    for l in range(L):
        sm = {k: mega["smalls"][l, i] for k, i in _SM.items()}

        def mm(lhs, q, s):  # bf16-valued lhs @ int8, f32 accumulate, scaled
            return (lhs @ q.float()) * s

        def shift_mix(key, scale, bias):
            xn = layer_norm(x_res, sm[scale], sm[bias], eps)
            xx = state[key][l].float() - xn
            state[key][l] = xn.to(state[key].dtype)
            xn_b, xx_b = _rb(xn), _rb(xx)
            return lambda row: _rb(xn_b + xx_b * row)

        mix = shift_mix("att_x", "ln1_s", "ln1_b")
        rkv = _rb(torch.cat(
            [mm(mix(sm[f"x_{n}"]), mega["rkv_q"][l, :, i * C:(i + 1) * C],
                mega["rkv_s"][l, i * C:(i + 1) * C]) for i, n in enumerate("rkv")], -1))
        r, k0, v_row = rkv[:, :C], rkv[:, C:2 * C], rkv[:, 2 * C:]
        lora = {}
        for gi, n in enumerate(_LG):
            cols = slice(gi * LORA_PAD, (gi + 1) * LORA_PAD)
            lh = mm(mix(sm[f"x_{n}"]), mega["li_q"][l, :, cols], mega["li_s"][l, cols])
            act = {"w": torch.tanh, "g": torch.sigmoid}.get(n, lambda t: t)
            lora[n] = mm(_rb(act(lh)), mega["lo_q"][l, cols], mega["lo_s"][l, gi])

        wd = _rb(torch.exp(-torch.exp(-_softplus(-(sm["w0"] + lora["w"])) - 0.5)))
        a_row = torch.sigmoid(sm["a0"] + lora["a"])
        if l == 0:
            v_eff = v_row
            v_first = _rb(v_eff)
        else:
            vmix = torch.sigmoid(sm["v0"] + lora["v"])
            v_eff = v_row + (v_first - v_row) * vmix
        v_s, a_s, g_s = _rb(v_eff), _rb(a_row), _rb(lora["g"])
        kk = heads(_rb(k0 * sm["k_k"]))
        k_eff = heads(_rb(k0 * (1.0 + (a_row - 1.0) * sm["k_a"])))
        kkn = kk * (1.0 / torch.sqrt(torch.clamp_min((kk * kk).sum(-1, keepdim=True), 1e-24)))
        z, bb = -kkn, kkn * heads(a_s)

        S = state["wkv"][l].float()
        sa = torch.einsum("bhij,bhj->bhi", S, z)
        S = (S * heads(wd)[:, :, None, :] + sa[..., None] * bb[:, :, None, :]
             + heads(v_s)[..., None] * k_eff[:, :, None, :])
        state["wkv"][l] = S.to(state["wkv"].dtype)
        y = torch.einsum("bhij,bhj->bhi", S, heads(r))
        m = y.mean(-1, keepdim=True)
        var = ((y - m) ** 2).mean(-1, keepdim=True)
        y_n = (y - m) * torch.rsqrt(var + cfg.ln_x_eps) * heads(sm["ln_x_s"]) + heads(sm["ln_x_b"])
        s_bh = (heads(r) * k_eff * heads(sm["r_k"])).sum(-1, keepdim=True)
        y_g = _rb(((y_n + s_bh * heads(v_s)) * heads(g_s)).reshape(Bn, C))
        x_res = x_res + mm(y_g, mega["out_q"][l], mega["out_s"][l])

        mix = shift_mix("ffn_x", "ln2_s", "ln2_b")
        acc_ffn = _rb(mm(mix(sm["ffn_x_k"]), mega["fk_q"][l], mega["fk_s"][l]))
        acc_ffn = _rb(torch.square(torch.relu(acc_ffn)))
        x_res = x_res + mm(acc_ffn, mega["fv_q"][l], mega["fv_s"][l])
    h = layer_norm(x_res, mega["ln_out_scale"], mega["ln_out_bias"], eps)
    return h, state


# ---------------------------------------------------------------------------
# Wrapper
# ---------------------------------------------------------------------------


_MEGA_KEYS = ("rkv_q", "rkv_s", "li_q", "li_s", "lo_q", "lo_s", "out_q",
              "out_s", "fk_q", "fk_s", "fv_q", "fv_s", "smalls")

# the product kernel's tiling (csrc/decode_b64.cu): 128-column tiles, K in
# stages of 64 rows, a piece of K at most 1024 rows (its lhs, 128 KB, stays
# in shared memory), at most 8 pieces (a portable cluster), at most 8
# weight stages in flight
NT, GK, KP_MAX, MAX_PIECES, RING_MAX = 128, 64, 1024, 8, 8
# CTAs a product aims at: the K pieces of a tile run as one cluster; on an
# H100 SXM (132 SMs) 112 CTAs in clusters of 4 started in one wave, 128 in
# two
WAVE = 112
SMEM_LIMIT = 232448       # shared memory a block may use (227 KB)
# the products of a layer in the order of decode_b64_step's pieces
PRODUCTS = ("rkv_li", "lo", "out", "fk", "fv")


def gemm_smem_bytes(k_piece: int) -> int:
    """Dynamic shared memory of a product CTA (decode_b64.cu
    gemm_smem_bytes): slack to align the TMA boxes to 1024 bytes, the lhs
    slice, the ring of 64 x 128-byte weight boxes, the f32 partial tile
    (rows padded by 4), the mbarriers."""
    ring = min(k_piece // GK, RING_MAX) * GK * 128
    return 1024 + B * k_piece * 2 + ring + B * (NT + 4) * 4 + 8 * (2 * RING_MAX + 1)


def workspace_bytes(C: int) -> int:
    """Bytes of the step's workspace (decode_b64.cu carve): x_res, the six
    mixes, acc_rkv, lora_act, lo_out, v_first, y_g, acc_ffn."""
    sizes = (B * C * 4, 6 * B * C * 2, B * 3 * C * 2, B * 4 * LORA_PAD * 2,
             4 * B * C * 4, B * C * 2, B * C * 2, B * 4 * C * 2)
    return sum((n + 255) // 256 * 256 for n in sizes)


def _pieces(K: int, tiles: int) -> int:
    """K pieces of a product with `tiles` 128-column tiles: double them while
    the CTAs fit one wave (WAVE), then while a piece exceeds KP_MAX."""
    p = 1
    while p < MAX_PIECES and K % (2 * p * GK) == 0 and 2 * p * tiles <= WAVE:
        p *= 2
    while p < MAX_PIECES and K % (2 * p * GK) == 0 and K // p > KP_MAX:
        p *= 2
    if K % (p * GK) or K // p > KP_MAX:
        raise ValueError(f"decode step: K = {K} does not cut into at most {MAX_PIECES} "
                         f"pieces of a multiple of {GK} rows, at most {KP_MAX}")
    return p


def launch_plan(C: int) -> Dict:
    """How the kernel cuts each product at width C: for each of PRODUCTS its
    K, N (all slices), tiles, K pieces, rows a piece, CTAs and shared bytes
    a CTA; and the workspace bytes."""
    if C % NT:
        raise ValueError(f"decode step: C = {C} is not a multiple of {NT}")
    shapes = {"rkv_li": (C, 3 * C + 4 * LORA_PAD), "lo": (LORA_PAD, 4 * C),
              "out": (C, C), "fk": (C, 4 * C), "fv": (4 * C, C)}
    plan = {}
    for name, (K, N) in shapes.items():
        tiles = N // NT
        p = _pieces(K, tiles)
        plan[name] = {"K": K, "N": N, "tiles": tiles, "pieces": p, "k_piece": K // p,
                      "ctas": tiles * p, "smem_bytes": gemm_smem_bytes(K // p)}
    return {"products": plan, "workspace_bytes": workspace_bytes(C)}


def decode_step_mega_b64(mega: Params, cfg, x: torch.Tensor, state: Params,
                         pdl: bool = True) -> Tuple[torch.Tensor, Params]:
    """One decode step. x (64, C) token embeddings (pre-ln0); state
    {'att_x' (L,64,C), 'wkv' (L,64,H,64,64), 'ffn_x' (L,64,C)} bf16,
    updated in place. Returns (hidden (64, C) f32 after ln_out, state).
    On the card `mega` must be a MegaPack (``pack_mega_b64``); pdl=False
    launches the chain without programmatic dependent launch, so that each
    kernel starts after the previous one ended and a profile gives each its
    own device time (with it, a kernel's span holds its wait)."""
    dev = x.device.type
    if dev == "cpu":
        return decode_step_plain(mega, cfg, x, state)
    if dev != "cuda":
        raise ValueError(f"decode_step_mega_b64: no implementation for device {x.device}")
    return _launch(mega, cfg, x, state, pdl)


def _check_tensors(mega: Params, L: int, C: int, device) -> None:
    shapes = {
        "rkv_q": (L, C, 3 * C), "rkv_s": (L, 3 * C),
        "li_q": (L, C, 4 * LORA_PAD), "li_s": (L, 4 * LORA_PAD),
        "lo_q": (L, 4 * LORA_PAD, C), "lo_s": (L, 4, C),
        "out_q": (L, C, C), "out_s": (L, C), "fk_q": (L, C, 4 * C),
        "fk_s": (L, 4 * C), "fv_q": (L, 4 * C, C), "fv_s": (L, C),
        "smalls": (L, NS, C),
    }
    for name, shape in shapes.items():
        t = mega[name]
        dtype = torch.int8 if name.endswith("_q") else torch.float32
        if t.shape != shape or t.dtype != dtype or t.device != device or not t.is_contiguous():
            raise ValueError(f"decode_step_mega_b64: mega[{name!r}] must be contiguous "
                             f"{shape} {dtype} on {device}")
    for name in ("ln0_scale", "ln0_bias", "ln_out_scale", "ln_out_bias"):
        t = mega[name]
        if t.shape != (C,) or t.dtype != torch.float32 or t.device != device:
            raise ValueError(f"decode_step_mega_b64: mega[{name!r}] must be ({C},) f32")


def _check_pack(mega: Params, L: int, C: int, device) -> None:
    """Check a MegaPack's tensors on its first step at (L, C, device)."""
    if not isinstance(mega, MegaPack):
        raise ValueError("decode_step_mega_b64: mega must be a MegaPack from pack_mega_b64")
    key = (L, C, str(device))
    if mega.checked != key:
        _check_tensors(mega, L, C, device)
        mega.checked = key


# the launch plan's pieces (a C array) and a workspace per (device, C): every
# launch is on the caller's stream, so one step at a time reuses it
_pieces_arrays: Dict[int, ctypes.Array] = {}
_workspaces: Dict[Tuple[int, int], torch.Tensor] = {}


def _launch(mega, cfg, x, state, pdl=True):
    global launches
    C, L, H = cfg.hidden_size, cfg.num_layers, cfg.num_heads
    x = x.float().contiguous()
    want = {
        "att_x": ((L, B, C), torch.bfloat16), "ffn_x": ((L, B, C), torch.bfloat16),
        "wkv": ((L, B, H, 64, 64), torch.bfloat16),
    }
    if x.shape != (B, C):
        raise ValueError(f"decode_step_mega_b64: x is {tuple(x.shape)}, want {(B, C)}")
    for name, (shape, dtype) in want.items():
        t = state[name]
        if t.shape != shape or t.dtype != dtype or t.device != x.device or not t.is_contiguous():
            raise ValueError(f"decode_step_mega_b64: state[{name!r}] must be contiguous "
                             f"{shape} {dtype} on {x.device}")
    _check_pack(mega, L, C, x.device)
    pieces = _pieces_arrays.get(C)
    if pieces is None:
        plan = launch_plan(C)["products"]
        pieces = _pieces_arrays[C] = (ctypes.c_int * len(PRODUCTS))(
            *(plan[n]["pieces"] for n in PRODUCTS))

    lib = _build.library()
    ws = _workspaces.get((x.device.index, C))
    if ws is None:
        ws = _workspaces[(x.device.index, C)] = torch.empty(
            lib.decode_b64_workspace_bytes(C), dtype=torch.uint8, device=x.device)
    h = torch.empty(B, C, dtype=torch.float32, device=x.device)
    ptr = lambda t: ctypes.c_void_p(t.data_ptr())
    counts = (ctypes.c_int * len(KERNELS))()
    err = lib.decode_b64_step(
        L, C, B, cfg.norm_eps, cfg.ln_x_eps, ptr(x), ptr(h),
        ptr(mega["ln0_scale"]), ptr(mega["ln0_bias"]),
        ptr(mega["ln_out_scale"]), ptr(mega["ln_out_bias"]),
        *(ptr(mega[k]) for k in _MEGA_KEYS),
        ptr(state["att_x"]), ptr(state["ffn_x"]), ptr(state["wkv"]), ptr(ws),
        pieces, int(pdl), counts, ctypes.c_void_p(torch.cuda.current_stream(x.device).cuda_stream),
    )
    for name, n in zip(KERNELS, counts):
        kernel_launches[name] += n
        launches += n
    _build.check(err, "decode_b64_step")
    return h, state
