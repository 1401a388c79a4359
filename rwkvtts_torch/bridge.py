"""Bridge between the JAX package's arrays and the port's tensors, in numpy
(no JAX import): parameters name for name (both ways), the flow, HiFT,
S3 tokenizer, CAM++, BiCodec, XY_Tokenizer, Higgs and Whisper (ASR) trees
with their convolution weights in PyTorch's layout, the default
optimizer's Adam moments, and the decode states (B=64 and B=1) between the
TPU kernels' layouts and the port's natural one.

Parameter trees have the same names and shapes in both packages, so
``params_from_numpy`` copies leaf by leaf. The JAX decode-step state
``wkv`` is (L, P, 4096, 128) with P = C/128 head pairs, row i*64 + j
(i the value dim, j the key dim) and lane h*64 + b (h the head in the
pair, b the batch row) — rwkvtts_tpu/ops/decode_mega_b64.py:255-281. The
TPU step kernels (B=1 decode, the packed slot-pool step) pack head pairs
along lanes instead: (..., B H / 2, N, 2N). The port keeps
(L, B, H, N, N).
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

B = 64


def to_tensor(a, device=None) -> torch.Tensor:
    """numpy (or array-like, including ml_dtypes bfloat16) -> tensor of the
    same dtype; bf16 goes through an exact f32 copy."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16).to(device)
    return torch.from_numpy(np.array(a, copy=True)).to(device)


def to_numpy(t) -> np.ndarray:
    """Tensor -> numpy; bf16 comes back as f32 (exact). An array passes
    through."""
    if not isinstance(t, torch.Tensor):
        return np.asarray(t)
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.numpy()


def params_from_numpy(tree: Dict[str, Any], device=None) -> Dict[str, Any]:
    """A JAX parameter tree (leaves as numpy or JAX arrays) -> the port's."""
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, device) for k, v in tree.items()}
    return to_tensor(tree, device)


def conv_from_jax(w) -> np.ndarray:
    """A JAX conv1d kernel (K, in/g, out) -> PyTorch's (out, in/g, K)."""
    return np.ascontiguousarray(np.transpose(np.asarray(w), (2, 1, 0)))


def conv_transpose_from_jax(w, groups: int = 1) -> np.ndarray:
    """A JAX transposed-conv kernel, stored as the forward conv over the
    dilated input (K, in/g, out) with the taps flipped -> PyTorch's
    ConvTranspose1d weight (in, out/g, K): input channel gi·(in/g) + i and
    output o of group gi take w[K-1-k, i, gi·(out/g) + o]."""
    w = np.asarray(w)[::-1]
    K, cin_g, cout = w.shape
    w = w.reshape(K, cin_g, groups, cout // groups)       # (k, i, gi, o)
    w = np.transpose(w, (2, 1, 3, 0))                     # (gi, i, o, k)
    return np.ascontiguousarray(w.reshape(groups * cin_g, cout // groups, K))


def conv2d_from_jax(w) -> np.ndarray:
    """A JAX conv2d kernel (kh, kw, in, out) -> PyTorch's (out, in, kh, kw)."""
    return np.ascontiguousarray(np.transpose(np.asarray(w), (3, 2, 0, 1)))


def codec_params_from_numpy(tree, device=None, transposed=("ups",), _in_transposed=False):
    """A JAX flow, HiFT, S3 tokenizer, CAM++, XY_Tokenizer or Higgs
    parameter tree (dicts and lists) -> the port's, name for name: every
    3-D "w" is a convolution kernel and goes to PyTorch's layout; those
    anywhere under a key named in `transposed` (by default "ups", HiFT's
    upsampling stack, the only transposed convolutions of the Cosy trees)
    to ConvTranspose1d's (groups 1); every 4-D "w" (CAM++'s 2-D front end)
    to Conv2d's. Linears, codebooks and norms keep their layout. The one
    place where codec weights change layout (rwkvtts_torch/codecs/nn.py)."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            if k == "w" and np.ndim(v) == 3:
                conv = conv_transpose_from_jax if _in_transposed else conv_from_jax
                out[k] = to_tensor(conv(v), device)
            elif k == "w" and np.ndim(v) == 4:
                out[k] = to_tensor(conv2d_from_jax(v), device)
            else:
                out[k] = codec_params_from_numpy(v, device, transposed,
                                                 _in_transposed or k in transposed)
        return out
    if isinstance(tree, (list, tuple)):
        return [codec_params_from_numpy(v, device, transposed, _in_transposed) for v in tree]
    return to_tensor(tree, device)


def bicodec_params_from_numpy(tree, device=None, _transposed=None):
    """A JAX BiCodec parameter tree (rwkvtts_tpu/codecs/bicodec.py) -> the
    port's: every 3-D "w" is a convolution kernel (the Vocos stacks' and
    ECAPA's convolutions) and goes to Conv1d's layout, except under "up"
    (the wave generator's ConvTranspose1d, groups 1) and "deconv" (the
    sampling blocks' depthwise ConvTranspose1d, a group a channel).
    Linears, codebooks, latents and batch-norm statistics keep their
    layout."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            if k == "w" and np.ndim(v) == 3:
                if _transposed is None:
                    w = conv_from_jax(v)
                else:
                    w = conv_transpose_from_jax(v, np.shape(v)[2] if _transposed == "deconv" else 1)
                out[k] = to_tensor(w, device)
            else:
                out[k] = bicodec_params_from_numpy(
                    v, device, k if k in ("up", "deconv") else _transposed)
        return out
    if isinstance(tree, (list, tuple)):
        return [bicodec_params_from_numpy(v, device, _transposed) for v in tree]
    return to_tensor(tree, device)


def xy_tokenizer_params_from_numpy(tree, device=None):
    """A JAX XY_Tokenizer tree (rwkvtts_tpu/codecs/xy_tokenizer.py) -> the
    port's: the acoustic decoder's deconv1 / deconv2 and the upsample are
    transposed convolutions (the downsample's "up" is a plain one). The XY
    LM's tree goes through ``params_from_numpy``, name for name."""
    return codec_params_from_numpy(tree, device, ("deconv1", "deconv2", "upsample"))


def higgs_params_from_numpy(tree, device=None):
    """A JAX Higgs tree (rwkvtts_tpu/codecs/higgs.py) -> the port's: the
    decoder blocks' "up" are its transposed convolutions."""
    return codec_params_from_numpy(tree, device, ("up",))


def asr_params_from_numpy(tree, device=None):
    """A JAX ASR tree (rwkvtts_tpu/models/asr.py) -> the port's: the Whisper
    tower's two convolutions go to Conv1d's layout (its transformer layers
    are linears and norms, kept), the adapter, LLM and projectors name for
    name."""
    out = {k: params_from_numpy(v, device) for k, v in tree.items() if k != "whisper"}
    if "whisper" in tree:
        out["whisper"] = codec_params_from_numpy(tree["whisper"], device)
    return out


# The S2S tree (rwkvtts_tpu/models/s2s.py: the backbone with its [text |
# audio] embedding, `head` and `audio_head`) and the two-tower tree
# (rwkvtts_tpu/models/tts_two_tower.py: `text_lm`, `projector`, `audio_lm`)
# hold no convolution: they convert name for name.
s2s_params_from_numpy = two_tower_params_from_numpy = params_from_numpy


def params_to_numpy(tree: Dict[str, Any]) -> Dict[str, Any]:
    """The port's parameter tree (dicts and lists) -> numpy leaves (bf16 as
    exact f32): the inverse of ``params_from_numpy``. Numpy leaves pass
    through."""
    if isinstance(tree, dict):
        return {k: params_to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [params_to_numpy(v) for v in tree]
    return to_numpy(tree)


def _array_leaves(tree, prefix: str = ""):
    """(path, array) over a tree of dicts, skipping leaves without a shape
    (optax's MaskedNode marks a leaf outside a transform's group)."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _array_leaves(v, f"{prefix}{k}/")
    elif hasattr(tree, "shape"):
        yield prefix[:-1], tree


def adam_state_from_optax(opt_state, device=None) -> Dict[str, Any]:
    """The optax state of the JAX package's default optimizer
    (rwkvtts_tpu/train/optimizer.py::build_optimizer with grad_clip: the
    clip, then a multi_transform of the decay / nodecay / lr2x AdamW
    chains) -> the port's AdamW state {"mu", "nu", "count"}
    (rwkvtts_torch/train/optimizer.py), so a run moves between packages.
    The groups share one step count."""
    _, multi = opt_state
    mu: Dict[str, torch.Tensor] = {}
    nu: Dict[str, torch.Tensor] = {}
    counts = set()
    for masked in multi.inner_states.values():
        adam = masked.inner_state[0]  # ScaleByAdamState(count, mu, nu)
        for path, leaf in _array_leaves(adam.mu):
            mu[path] = to_tensor(leaf, device).float()
        for path, leaf in _array_leaves(adam.nu):
            nu[path] = to_tensor(leaf, device).float()
        counts.add(int(np.asarray(adam.count)))
    if len(counts) != 1:
        raise ValueError(f"optax groups disagree on the step count: {sorted(counts)}")
    return {"mu": mu, "nu": nu,
            "count": torch.tensor(counts.pop(), dtype=torch.int32, device=device)}


def wkv_from_mega(wkv: np.ndarray, num_heads: int) -> np.ndarray:
    """(L, P, 4096, 128) transposed blocks -> (L, B, H, 64, 64)."""
    L, P = wkv.shape[:2]
    w = np.asarray(wkv).reshape(L, P, 64, 64, 2, B)   # (L, p, i, j, h, b)
    w = np.transpose(w, (0, 5, 1, 4, 2, 3))            # (L, b, p, h, i, j)
    return w.reshape(L, B, num_heads, 64, 64)


def wkv_to_mega(wkv: np.ndarray) -> np.ndarray:
    """(L, B, H, 64, 64) -> the transposed (L, P, 4096, 128) blocks."""
    L, Bn, H = wkv.shape[:3]
    P = H // 2
    w = np.asarray(wkv).reshape(L, Bn, P, 2, 64, 64)   # (L, b, p, h, i, j)
    w = np.transpose(w, (0, 2, 4, 5, 3, 1))            # (L, p, i, j, h, b)
    return w.reshape(L, P, 4096, 128)


def state_from_mega(mstate: Dict[str, Any], num_heads: int, device=None
                    ) -> Dict[str, torch.Tensor]:
    """JAX megakernel state {'att_x', 'wkv', 'ffn_x'} -> the port's decode
    state (bf16, natural layout)."""
    conv = lambda a: to_tensor(a, device).to(torch.bfloat16).contiguous()
    return {
        "att_x": conv(mstate["att_x"]),
        "wkv": conv(wkv_from_mega(np.asarray(mstate["wkv"]), num_heads)),
        "ffn_x": conv(mstate["ffn_x"]),
    }


def state_to_mega(state: Dict[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    """The port's decode state -> the JAX megakernel layout (numpy f32
    holding bf16 values; cast to bf16 on the JAX side)."""
    return {
        "att_x": to_numpy(state["att_x"]),
        "wkv": wkv_to_mega(to_numpy(state["wkv"])),
        "ffn_x": to_numpy(state["ffn_x"]),
    }


def wkv_from_packed(wkv: np.ndarray, batch: int, num_heads: int) -> np.ndarray:
    """The TPU step kernels' head-pair-packed state (..., P, N, 2N), P =
    B H / 2, row i (value dim) and lane h N + j (head h of the pair, key
    dim j) -> (..., B, H, N, N)
    (rwkvtts_tpu/ops/wkv7_step_pallas.py::unpack_state)."""
    w = np.asarray(wkv)
    *lead, P, N, N2 = w.shape
    w = w.reshape(*lead, batch, num_heads // 2, N, 2, N)   # (..., b, p, i, h, j)
    w = np.moveaxis(w, -2, -3)                              # (..., b, p, h, i, j)
    return w.reshape(*lead, batch, num_heads, N, N)


def wkv_to_packed(wkv: np.ndarray) -> np.ndarray:
    """(..., B, H, N, N) -> the head-pair-packed (..., B H / 2, N, 2N)
    (rwkvtts_tpu/ops/wkv7_step_pallas.py::pack_state)."""
    w = np.asarray(wkv)
    *lead, Bn, H, N, _ = w.shape
    w = w.reshape(*lead, Bn, H // 2, 2, N, N)               # (..., b, p, h, i, j)
    w = np.moveaxis(w, -3, -2)                              # (..., b, p, i, h, j)
    return w.reshape(*lead, Bn * (H // 2), N, 2 * N)


def wkv_from_head_pairs(wkv: np.ndarray, num_heads: int) -> np.ndarray:
    """The B=1 TPU kernel's state (L, P, 64, 128) -> (L, 1, H, 64, 64)."""
    return wkv_from_packed(wkv, 1, num_heads)


def wkv_to_head_pairs(wkv: np.ndarray) -> np.ndarray:
    """(L, 1, H, 64, 64) -> the B=1 TPU kernel's (L, P, 64, 128)."""
    return wkv_to_packed(wkv)


def state_from_mega_b1(mstate: Dict[str, Any], num_heads: int, device=None
                       ) -> Dict[str, torch.Tensor]:
    """JAX B=1 megakernel state -> the port's B=1 decode state: shift states
    f32, the WKV state in the JAX carry's dtype (bf16 or f32), natural
    layout."""
    wkv = np.asarray(mstate["wkv"])
    dt = torch.bfloat16 if wkv.dtype.name == "bfloat16" else torch.float32
    f32 = lambda a: to_tensor(np.asarray(a, np.float32), device).contiguous()
    return {"att_x": f32(mstate["att_x"]),
            "wkv": f32(wkv_from_head_pairs(wkv.astype(np.float32), num_heads)).to(dt),
            "ffn_x": f32(mstate["ffn_x"])}


def state_to_mega_b1(state: Dict[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    """The port's B=1 decode state -> the JAX megakernel layout (numpy f32;
    cast the WKV state to the carry dtype on the JAX side)."""
    return {"att_x": to_numpy(state["att_x"]),
            "wkv": wkv_to_head_pairs(to_numpy(state["wkv"])),
            "ffn_x": to_numpy(state["ffn_x"])}
