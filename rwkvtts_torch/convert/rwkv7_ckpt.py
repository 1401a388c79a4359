"""RWKV-7 checkpoint interchange: fla-HF / BlinkDL torch formats <-> the
port's parameter trees, as numpy (counterpart of
rwkvtts_tpu/convert/rwkv7_ckpt.py): the loaders, the BlinkDL exporter and
the fp32 -> bf16 cast of a deployment checkpoint.

Formats read:
  * fla HF naming (model.layers.{i}.attn.{x_r..x_g, r/k/v/o_proj,
    {w,a,v,g}_lora.lora.{0,2}, k_k, k_a, r_k, g_norm}, attn_norm/ffn_norm/
    pre_norm, model.norm, model.embeddings, lm_head);
  * BlinkDL naming (emb, blocks.{i}.{ln0,ln1,ln2,att.*,ffn.*}, ln_x,
    ln_out, head);
  * the v1 stacked token-shift deltas (attn.x_x -> x_r..x_g).

Trees are numpy; ``bridge.params_from_numpy`` makes tensors of them.

    python -m rwkvtts_torch.convert.rwkv7_ckpt cast-bf16 model.pth model_bf16.pth
"""
from __future__ import annotations

import json
import struct
from typing import Any, Dict, Mapping

import numpy as np
import torch

from rwkvtts_torch import bridge

Params = Dict[str, Any]
SD = Mapping[str, np.ndarray]

_XS = ("r", "w", "k", "v", "a", "g")


def load_torch_or_safetensors(path: str) -> Dict[str, np.ndarray]:
    """Read a .pth/.pt/.bin (torch) or .safetensors checkpoint to numpy."""
    if str(path).endswith(".safetensors"):
        return load_safetensors(path)
    sd = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(sd, dict) and "state_dict" in sd:
        sd = sd["state_dict"]
    return {k: v.float().numpy() for k, v in sd.items()}


def migrate_x_x(sd: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """v1 ckpts store the six token-shift deltas stacked as attn.x_x."""
    out = dict(sd)
    for key in list(out.keys()):
        if key.endswith(".x_x"):
            x_x = out.pop(key)
            base = key[: -len(".x_x")]
            for i, s in enumerate(_XS):
                out[f"{base}.x_{s}"] = x_x[i].reshape(1, 1, -1)
    return out


def _flat(x):
    return np.asarray(x).reshape(-1)


def infer_config_kwargs(sd: SD) -> Dict[str, Any]:
    """Derive (vocab, hidden, layers, head_size) from a ckpt
    (utils/rwkv_utilities.py parity). Works for both namings."""
    if "model.embeddings.weight" in sd or "text_embedding.weight" in sd:
        # RWKV7CosyLM exports carry text_embedding.weight instead of
        # model.embeddings.weight (cosy_llm.py layout) — hidden/layers/head
        # derive the same way from the fla-named blocks
        emb = sd.get("model.embeddings.weight", sd.get("text_embedding.weight"))
        n_layer = 1 + max(
            int(k.split(".")[2]) for k in sd if k.startswith("model.layers.")
        )
        rk = sd["model.layers.0.attn.r_k"]
    else:
        emb = sd["emb.weight"]
        n_layer = 1 + max(
            int(k.split(".")[1]) for k in sd if k.startswith("blocks.")
        )
        rk = sd["blocks.0.att.r_k"]
    return dict(
        vocab_size=emb.shape[0],
        hidden_size=emb.shape[1],
        num_layers=n_layer,
        head_size=rk.shape[1],
    )


def _block_from_fla(sd: SD, i: int) -> Params:
    a = f"model.layers.{i}.attn"
    f = f"model.layers.{i}.ffn"
    T = lambda k: np.ascontiguousarray(np.asarray(sd[k]).T)
    att = {
        **{f"x_{s}": _flat(sd[f"{a}.x_{s}"]) for s in _XS},
        "w0": _flat(sd[f"{a}.w_lora.lora.2.bias"]),
        "w1": T(f"{a}.w_lora.lora.0.weight"),
        "w2": T(f"{a}.w_lora.lora.2.weight"),
        "a0": _flat(sd[f"{a}.a_lora.lora.2.bias"]),
        "a1": T(f"{a}.a_lora.lora.0.weight"),
        "a2": T(f"{a}.a_lora.lora.2.weight"),
        "g1": T(f"{a}.g_lora.lora.0.weight"),
        "g2": T(f"{a}.g_lora.lora.2.weight"),
        "k_k": _flat(sd[f"{a}.k_k"]),
        "k_a": _flat(sd[f"{a}.k_a"]),
        "r_k": np.asarray(sd[f"{a}.r_k"]),
        "receptance": T(f"{a}.r_proj.weight"),
        "key": T(f"{a}.k_proj.weight"),
        "value": T(f"{a}.v_proj.weight"),
        "output": T(f"{a}.o_proj.weight"),
        "ln_x_scale": np.asarray(sd[f"{a}.g_norm.weight"]),
        "ln_x_bias": np.asarray(sd[f"{a}.g_norm.bias"]),
    }
    if f"{a}.v_lora.lora.2.bias" in sd:  # layers > 0
        att["v0"] = _flat(sd[f"{a}.v_lora.lora.2.bias"])
        att["v1"] = T(f"{a}.v_lora.lora.0.weight")
        att["v2"] = T(f"{a}.v_lora.lora.2.weight")
    return {
        "ln1_scale": np.asarray(sd[f"model.layers.{i}.attn_norm.weight"]),
        "ln1_bias": np.asarray(sd[f"model.layers.{i}.attn_norm.bias"]),
        "ln2_scale": np.asarray(sd[f"model.layers.{i}.ffn_norm.weight"]),
        "ln2_bias": np.asarray(sd[f"model.layers.{i}.ffn_norm.bias"]),
        "att": att,
        "ffn": {
            "x_k": _flat(sd[f"{f}.x_k"]),
            "key": T(f"{f}.key.weight"),
            "value": T(f"{f}.value.weight"),
        },
    }


def _block_from_blinkdl(sd: SD, i: int) -> Params:
    a = f"blocks.{i}.att"
    f = f"blocks.{i}.ffn"
    T = lambda k: np.ascontiguousarray(np.asarray(sd[k]).T)
    att = {
        **{f"x_{s}": _flat(sd[f"{a}.x_{s}"]) for s in _XS},
        # BlinkDL stores loras in math orientation already (x @ w1 @ w2)
        "w0": _flat(sd[f"{a}.w0"]),
        "w1": np.asarray(sd[f"{a}.w1"]),
        "w2": np.asarray(sd[f"{a}.w2"]),
        "a0": _flat(sd[f"{a}.a0"]),
        "a1": np.asarray(sd[f"{a}.a1"]),
        "a2": np.asarray(sd[f"{a}.a2"]),
        "g1": np.asarray(sd[f"{a}.g1"]),
        "g2": np.asarray(sd[f"{a}.g2"]),
        "k_k": _flat(sd[f"{a}.k_k"]),
        "k_a": _flat(sd[f"{a}.k_a"]),
        "r_k": np.asarray(sd[f"{a}.r_k"]),
        "receptance": T(f"{a}.receptance.weight"),
        "key": T(f"{a}.key.weight"),
        "value": T(f"{a}.value.weight"),
        "output": T(f"{a}.output.weight"),
        "ln_x_scale": np.asarray(sd[f"{a}.ln_x.weight"]),
        "ln_x_bias": np.asarray(sd[f"{a}.ln_x.bias"]),
    }
    if f"{a}.v0" in sd:
        att["v0"] = _flat(sd[f"{a}.v0"])
        att["v1"] = np.asarray(sd[f"{a}.v1"])
        att["v2"] = np.asarray(sd[f"{a}.v2"])
    return {
        "ln1_scale": np.asarray(sd[f"blocks.{i}.ln1.weight"]),
        "ln1_bias": np.asarray(sd[f"blocks.{i}.ln1.bias"]),
        "ln2_scale": np.asarray(sd[f"blocks.{i}.ln2.weight"]),
        "ln2_bias": np.asarray(sd[f"blocks.{i}.ln2.bias"]),
        "att": att,
        "ffn": {
            "x_k": _flat(sd[f"{f}.x_k"]),
            "key": T(f"{f}.key.weight"),
            "value": T(f"{f}.value.weight"),
        },
    }


def _fill_layer0_vlora(blocks, cfg):
    """Layer 0 has no v-lora in checkpoints; our stacked pytree carries
    (ignored) placeholders there for uniformity."""
    b0 = blocks[0]["att"]
    if "v0" not in b0:
        ref = next((b for b in blocks if "v0" in b["att"]), None)
        if ref is not None:
            ref = ref["att"]
            b0["v0"] = np.zeros_like(ref["v0"])
            b0["v1"] = np.zeros_like(ref["v1"])
            b0["v2"] = np.zeros_like(ref["v2"])
        else:  # single-layer model: no layer carries a v-lora at all
            C = cfg.hidden_size
            b0["v0"] = np.zeros((C,), np.float32)
            b0["v1"] = np.zeros((C, cfg.v_lora), np.float32)
            b0["v2"] = np.zeros((cfg.v_lora, C), np.float32)
    return blocks


def _stack(blocks):
    if isinstance(blocks[0], dict):
        return {k: _stack([b[k] for b in blocks]) for k in blocks[0]}
    return np.stack(blocks)


def fla_to_rwkv7(sd: SD, cfg, prefix: str = "") -> Params:
    """fla-HF state_dict -> rwkv7 params pytree."""
    if prefix:
        sd = {k[len(prefix):]: v for k, v in sd.items() if k.startswith(prefix)}
    sd = migrate_x_x(dict(sd))
    blocks = [_block_from_fla(sd, i) for i in range(cfg.num_layers)]
    blocks = _fill_layer0_vlora(blocks, cfg)
    p: Params = {
        "blocks": _stack(blocks),
        "ln0_scale": np.asarray(sd["model.layers.0.pre_norm.weight"]),
        "ln0_bias": np.asarray(sd["model.layers.0.pre_norm.bias"]),
        "ln_out_scale": np.asarray(sd["model.norm.weight"]),
        "ln_out_bias": np.asarray(sd["model.norm.bias"]),
    }
    if getattr(cfg, "with_embedding", True) and "model.embeddings.weight" in sd:
        p["embedding"] = np.asarray(sd["model.embeddings.weight"])
    if getattr(cfg, "with_head", True) and "lm_head.weight" in sd:
        p["head"] = np.ascontiguousarray(np.asarray(sd["lm_head.weight"]).T)
    return p


def blinkdl_to_rwkv7(sd: SD, cfg) -> Params:
    """BlinkDL-format state_dict -> rwkv7 params pytree."""
    sd = migrate_x_x(dict(sd))
    blocks = [_block_from_blinkdl(sd, i) for i in range(cfg.num_layers)]
    blocks = _fill_layer0_vlora(blocks, cfg)
    p: Params = {
        "blocks": _stack(blocks),
        "ln0_scale": np.asarray(sd["blocks.0.ln0.weight"]),
        "ln0_bias": np.asarray(sd["blocks.0.ln0.bias"]),
        "ln_out_scale": np.asarray(sd["ln_out.weight"]),
        "ln_out_bias": np.asarray(sd["ln_out.bias"]),
    }
    if getattr(cfg, "with_embedding", True) and "emb.weight" in sd:
        p["embedding"] = np.asarray(sd["emb.weight"])
    if getattr(cfg, "with_head", True) and "head.weight" in sd:
        p["head"] = np.ascontiguousarray(np.asarray(sd["head.weight"]).T)
    return p


def load_safetensors(path: str) -> Dict[str, np.ndarray]:
    """Minimal safetensors reader (no `safetensors` package needed; a copy
    of rwkvtts_tpu/codecs/torch_import.py::load_safetensors). bf16
    tensors come back as f32."""
    dtype_map = {
        "F32": np.float32, "F16": np.float16, "BF16": None,
        "I64": np.int64, "I32": np.int32, "U8": np.uint8, "BOOL": np.bool_,
        "F64": np.float64,
    }
    out: Dict[str, np.ndarray] = {}
    with open(path, "rb") as f:
        (hlen,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(hlen))
        data = f.read()
    for name, meta in header.items():
        if name == "__metadata__":
            continue
        lo, hi = meta["data_offsets"]
        raw = data[lo:hi]
        if meta["dtype"] == "BF16":
            u16 = np.frombuffer(raw, np.uint16).astype(np.uint32) << 16
            arr = u16.view(np.float32)
        else:
            arr = np.frombuffer(raw, dtype_map[meta["dtype"]])
        out[name] = arr.reshape(meta["shape"]).copy()
    return out


def rwkv7_to_blinkdl(params: Params, cfg) -> Dict[str, np.ndarray]:
    """The port's RWKV-7 parameters (tensors or numpy) -> a BlinkDL-named
    state dict of numpy arrays, the deployment / eval interchange format
    of ChatRWKV and WebRWKV (the reference's eval/eval_tts_base.py:146).
    Layer 0's placeholder v-lora is left out, as checkpoints have none."""
    params = bridge.params_to_numpy(params)
    blocks = params["blocks"]
    out: Dict[str, np.ndarray] = {}
    r2 = lambda x: np.asarray(x, np.float32).reshape(1, 1, -1)
    T = lambda x: np.ascontiguousarray(x.T)
    for i in range(cfg.num_layers):
        a, f = f"blocks.{i}.att", f"blocks.{i}.ffn"
        att = {k: v[i] for k, v in blocks["att"].items()}
        ffn = {k: v[i] for k, v in blocks["ffn"].items()}
        for s in _XS:
            out[f"{a}.x_{s}"] = r2(att[f"x_{s}"])
        for n in ("w", "a") + (("v",) if i > 0 else ()):
            out[f"{a}.{n}0"] = r2(att[f"{n}0"])
            out[f"{a}.{n}1"] = att[f"{n}1"]
            out[f"{a}.{n}2"] = att[f"{n}2"]
        out[f"{a}.g1"] = att["g1"]
        out[f"{a}.g2"] = att["g2"]
        out[f"{a}.k_k"] = r2(att["k_k"])
        out[f"{a}.k_a"] = r2(att["k_a"])
        out[f"{a}.r_k"] = att["r_k"]
        for n in ("receptance", "key", "value", "output"):
            out[f"{a}.{n}.weight"] = T(att[n])
        out[f"{a}.ln_x.weight"] = att["ln_x_scale"]
        out[f"{a}.ln_x.bias"] = att["ln_x_bias"]
        for n in ("ln1", "ln2"):
            out[f"blocks.{i}.{n}.weight"] = blocks[f"{n}_scale"][i]
            out[f"blocks.{i}.{n}.bias"] = blocks[f"{n}_bias"][i]
        out[f"{f}.x_k"] = r2(ffn["x_k"])
        out[f"{f}.key.weight"] = T(ffn["key"])
        out[f"{f}.value.weight"] = T(ffn["value"])
    out["blocks.0.ln0.weight"] = params["ln0_scale"]
    out["blocks.0.ln0.bias"] = params["ln0_bias"]
    out["ln_out.weight"] = params["ln_out_scale"]
    out["ln_out.bias"] = params["ln_out_bias"]
    if "embedding" in params:
        out["emb.weight"] = params["embedding"]
    if "head" in params:
        out["head.weight"] = T(params["head"])
    return out


def cast_fp32_to_bf16(in_path: str, out_path: str) -> int:
    """Rewrite a torch checkpoint with every fp32 tensor cast to bf16 (the
    reference's utils/convert_from_fp32_to_bf16.py, the deployment format
    of the ChatRWKV / WebRWKV runtimes); other entries pass through.
    Returns the number of tensors cast."""
    sd = torch.load(in_path, map_location="cpu", weights_only=True)
    out, n = {}, 0
    for k, v in sd.items():
        if getattr(v, "dtype", None) == torch.float32:
            v = v.bfloat16()
            n += 1
        out[k] = v
    torch.save(out, out_path)
    return n


def main(argv=None) -> None:
    import argparse

    p = argparse.ArgumentParser(prog="python -m rwkvtts_torch.convert.rwkv7_ckpt",
                                description="checkpoint interchange utilities")
    sub = p.add_subparsers(dest="cmd", required=True)
    sc = sub.add_parser("cast-bf16", help="fp32 -> bf16 torch checkpoint")
    sc.add_argument("input")
    sc.add_argument("output")
    args = p.parse_args(argv)
    n = cast_fp32_to_bf16(args.input, args.output)
    print(f"cast {n} fp32 tensors -> {args.output}")


if __name__ == "__main__":
    main()
