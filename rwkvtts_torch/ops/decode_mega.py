"""Whole-model RWKV-7 decode step for one row (B = 1) with int8 weights
(counterpart of rwkvtts_tpu/ops/decode_mega.py, the Cosy streaming step).

``decode_step_mega`` is the wrapper: tensors on a CUDA device launch the
hand-written kernels of ``csrc/decode_b1.cu``, which replace the TPU kernel
``_mega_kernel`` (``launch_plan`` says how each product is cut,
``launches_per_step`` what a step launches: 5 L + 1); the pack is checked
on its first step and the workspace kept per device and width, so a step
does no check of its weights and no allocation but its result. Tensors on
the CPU take ``decode_step_plain``, which keeps every rounding point of the
TPU kernel (decode_mega.py:363-605):
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
from rwkvtts_torch.ops.decode_mega_b64 import (
    _LG, _SM, LORA_PAD, NS, SMEM_LIMIT, MegaPack, _softplus, pack_common)
from rwkvtts_torch.ops.norm import layer_norm

Params = Dict[str, torch.Tensor]

# CUDA kernel launches made by decode_step_mega: in all, and by kernel (the
# order of decode_b1_step's counts; launches_per_step gives a step's).
# reset_launches() zeroes both.
KERNELS = ("ln_out", "gemv", "glue")
launches = 0
kernel_launches = dict.fromkeys(KERNELS, 0)


def reset_launches() -> None:
    global launches
    launches = 0
    kernel_launches.update(dict.fromkeys(KERNELS, 0))


def pack_mega(params: Params, cfg) -> MegaPack:
    """Quantize and pack the backbone parameters (on their device). The
    CUDA route takes only what this returns (a MegaPack, checked on its
    first step; replacing an entry has it checked again)."""
    C, L = cfg.hidden_size, cfg.num_layers
    att = params["blocks"]["att"]
    mega = pack_common(params, cfg)
    lo = torch.zeros(L, 4 * LORA_PAD, C, dtype=torch.bfloat16, device=mega["rkv_q"].device)
    for gi, name in enumerate(_LG):
        w = att[f"{name}2"]
        lo[:, gi * LORA_PAD:gi * LORA_PAD + w.shape[-2]] = w.to(torch.bfloat16)
    return MegaPack(mega, lo=lo)


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

# the product kernel's tiling (csrc/decode_b1.cu): a tile is TB bytes (int8
# columns) of every weight row, 128 for r/k/v with lora-in and the FFN key,
# 64 for the C-wide output and FFN value; weights come in 8 KB TMA boxes; a
# CTA's piece of K is at most 64 KB of weights; the pieces of a tile run as
# one cluster, at most 8; the pieces are doubled while a product has fewer
# than 256 CTAs (about two an SM of the H100's 132)
BOX, PIECE_BYTES, MAX_PIECES, TARGET_CTAS, THREADS = 8192, 65536, 8, 256, 256
WARPS = THREADS // 32  # compute warps of every kernel (a product CTA adds a producer warp)
# the int8 products of a layer in the order of decode_b1_step's pieces (the
# lora-out runs inside the glue) and their tile bytes
PRODUCTS = ("rkv_li", "out", "fk", "fv")
_TILE = {"rkv_li": 128, "out": 64, "fk": 128, "fv": 64}


def gemv_smem_bytes(tb: int, k_piece: int) -> int:
    """Dynamic shared memory of a product CTA (decode_b1.cu
    gemv_smem_bytes): slack to align the boxes, the weight boxes, the lhs
    slice (f32), the warps' column sums, the cluster's partial sums of the
    CTA's columns, the mbarriers (the boxes', the partial sums')."""
    return (128 + k_piece * tb + 4 * k_piece + WARPS * tb * 4 + tb * 4
            + 8 * (PIECE_BYTES // BOX + 1))


def glue_smem_bytes() -> int:
    """Dynamic shared memory of a glue CTA (decode_b1.cu glue_smem_bytes):
    slack to align, the four 16 KB lora-out weight boxes of a head, the
    activated hiddens, the lora-out half sums, six per-channel vectors and
    y, the reduction scratch, the mbarrier."""
    return 128 + 4 * LORA_PAD * 128 + 4 * (4 * LORA_PAD + 8 * 64 + 7 * 64 + WARPS) + 8


def _pieces(K: int, tiles: int, tb: int) -> int:
    rows = BOX // tb  # a box's rows: pieces are whole boxes
    p = 1
    while K // p * tb > PIECE_BYTES and K % (2 * p * rows) == 0:
        p *= 2
    while tiles * p < TARGET_CTAS and 2 * p <= MAX_PIECES and K % (2 * p * rows) == 0:
        p *= 2
    if K % (p * rows) or K // p * tb > PIECE_BYTES or p > MAX_PIECES:
        raise ValueError(f"decode step: K = {K} does not cut into at most {MAX_PIECES} pieces "
                         f"of whole {rows}-row boxes, {PIECE_BYTES} bytes at most")
    return p


def _products(C: int) -> Dict[str, Tuple[int, int]]:
    """(K, N) of each product at width C."""
    return {"rkv_li": (C, 3 * C + 4 * LORA_PAD), "out": (C, C), "fk": (C, 4 * C),
            "fv": (4 * C, C)}


def workspace_bytes(C: int) -> int:
    """Bytes of the step's workspace (decode_b1.cu carve): x_res, r/k/v, the
    lora-in hiddens, relu(FFN key)^2, v_first, y_g, and the two normalised
    rows that become the shift states."""
    sizes = [4 * C, 4 * 3 * C, 4 * 4 * LORA_PAD, 2 * 4 * C, 4 * C, 2 * C, 4 * C, 4 * C]
    return sum((n + 255) // 256 * 256 for n in sizes)


def launch_plan(C: int) -> Dict:
    """How the kernel cuts each product at width C: for each of PRODUCTS
    its K, tile bytes, column tiles, K pieces (the cluster), rows a piece,
    CTAs and shared bytes a CTA; the glue's shared bytes a CTA; and the
    workspace bytes."""
    if C % 128 or C > 4096:
        raise ValueError(f"decode step: C = {C} must be a multiple of 128, at most 4096")
    plan = {}
    for name, (K, N) in _products(C).items():
        tb = _TILE[name]
        p = _pieces(K, N // tb, tb)
        if C % p:
            raise ValueError(f"decode step: C = {C} does not cut into the {p} pieces of {name}")
        plan[name] = {"K": K, "tile_bytes": tb, "tiles": N // tb, "pieces": p,
                      "k_piece": K // p, "ctas": N // tb * p,
                      "smem_bytes": gemv_smem_bytes(tb, K // p)}
    return {"products": plan, "glue_smem_bytes": glue_smem_bytes(),
            "workspace_bytes": workspace_bytes(C)}


def launches_per_step(L: int) -> Dict[str, int]:
    """The kernel launches of one step at L layers, by kernel: per layer
    r/k/v with lora-in (ln1 inside), the glue (lora-out inside), output,
    FFN key (ln2 inside), FFN value; then ln_out."""
    return {"ln_out": 1, "gemv": 4 * L, "glue": L}


def decode_step_mega(mega: Params, cfg, x: torch.Tensor, state: Params, pdl: bool = True
                     ) -> Tuple[torch.Tensor, Params]:
    """One decode step. x (1, C) token embedding (pre-ln0); state
    {'att_x' (L,1,C) f32, 'wkv' (L,1,H,64,64) f32 or bf16, 'ffn_x'
    (L,1,C) f32}, updated in place. Returns (hidden (1, C) f32 after
    ln_out, state). On the card `mega` must be a MegaPack (``pack_mega``);
    pdl=False launches the chain without programmatic dependent launch, so
    that a profile gives each kernel its own device time."""
    dev = x.device.type
    if dev == "cpu":
        return decode_step_plain(mega, cfg, x, state)
    if dev != "cuda":
        raise ValueError(f"decode_step_mega: no implementation for device {x.device}")
    return _launch(mega, cfg, x, state, pdl)


def _check_tensors(mega: Params, L: int, C: int, device) -> None:
    shapes = {
        "rkv_q": (L, C, 3 * C), "rkv_s": (L, 3 * C),
        "li_q": (L, C, 4 * LORA_PAD), "li_s": (L, 4 * LORA_PAD),
        "lo": (L, 4 * LORA_PAD, C), "out_q": (L, C, C), "out_s": (L, C),
        "fk_q": (L, C, 4 * C), "fk_s": (L, 4 * C), "fv_q": (L, 4 * C, C), "fv_s": (L, C),
        "smalls": (L, NS, C),
    }
    for name, shape in shapes.items():
        t = mega[name]
        dtype = {"lo": torch.bfloat16}.get(name, torch.int8 if name.endswith("_q") else torch.float32)
        if t.shape != shape or t.dtype != dtype or t.device != device or not t.is_contiguous():
            raise ValueError(f"decode_step_mega: mega[{name!r}] must be contiguous "
                             f"{shape} {dtype} on {device}")
    for name in ("ln0_scale", "ln0_bias", "ln_out_scale", "ln_out_bias"):
        t = mega[name]
        if t.shape != (C,) or t.dtype != torch.float32 or t.device != device:
            raise ValueError(f"decode_step_mega: mega[{name!r}] must be ({C},) f32")


def _check_pack(mega: Params, L: int, C: int, device) -> None:
    """Check a MegaPack's tensors on its first step at (L, C, device)."""
    if not isinstance(mega, MegaPack):
        raise ValueError("decode_step_mega: mega must be a MegaPack from pack_mega")
    key = (L, C, str(device))
    if mega.checked != key:
        _check_tensors(mega, L, C, device)
        mega.checked = key


# the launch plan's pieces (a C array) by C, and a workspace per (device,
# C): every launch is on the caller's stream, so one step at a time reuses
# it
_pieces_arrays: Dict[int, ctypes.Array] = {}
_workspaces: Dict[Tuple[int, int], torch.Tensor] = {}


def _launch(mega, cfg, x, state, pdl=True):
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
    for name, (shape, dtype) in want.items():
        t = state[name]
        if t.shape != shape or t.dtype != dtype or t.device != x.device or not t.is_contiguous():
            raise ValueError(f"decode_step_mega: state[{name!r}] must be contiguous "
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
            lib.decode_b1_workspace_bytes(C), dtype=torch.uint8, device=x.device)
    h = torch.empty(1, C, dtype=torch.float32, device=x.device)
    ptr = lambda t: ctypes.c_void_p(t.data_ptr())
    counts = (ctypes.c_int * len(KERNELS))()
    err = lib.decode_b1_step(
        L, C, _STATE_DTYPES[wkv_dt], cfg.norm_eps, cfg.ln_x_eps, ptr(x), ptr(h),
        ptr(mega["ln0_scale"]), ptr(mega["ln0_bias"]),
        ptr(mega["ln_out_scale"]), ptr(mega["ln_out_bias"]),
        *(ptr(mega[k]) for k in _MEGA_KEYS),
        ptr(state["att_x"]), ptr(state["ffn_x"]), ptr(state["wkv"]), ptr(ws),
        pieces, int(pdl), counts, ctypes.c_void_p(torch.cuda.current_stream(x.device).cuda_stream),
    )
    for name, n in zip(KERNELS, counts):
        kernel_launches[name] += n
        launches += n
    _build.check(err, "decode_b1_step")
    return h, state
