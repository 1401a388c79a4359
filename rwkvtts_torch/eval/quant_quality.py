"""How often the quantized decode modes agree with the bf16 model
(counterpart of scripts/measure_int8_quality.py, same protocol and JSON
keys).

Protocol: a Spark model at ``--hidden`` x ``--layers`` with random
weights from a seed, its matrices in bf16; the init's zero matrices (the
lora-in, output and FFN value matrices) drawn nonzero too, as N(0, 1/in):
with them zero no block changes the hidden state, and every mode agrees
whatever its quantization (the JAX script measures at that init). B = 8
prompts of 64 random
text tokens (B = 64 with ``--mega``). The full-precision comparator (the
fused bf16 decode weights, an f32 WKV state carry) rolls out ``--steps``
greedy tokens. Then

  * teacher-forced: the comparator's stream is fed back through the
    comparator and through the quantized mode, each step's top-1 choice
    recorded; the agreement is the share of equal choices (no
    compounding);
  * free-running: the quantized mode's own greedy rollout, its share of
    tokens equal to the comparator's, and the median step of each row's
    first divergence.

Modes: int8 weights (default), ``--int4`` (group-wise, 64 rows a scale),
``--state-bf16`` (the same weights, the WKV state carried in bf16),
``--state-bf16 --int8`` (both), ``--mega`` (the B=64 whole-step decode
kernel: int8 projections and lora-out, a bf16 state), and the control
``--unfused`` (the comparator's own bf16 weights through the seven-product
step: only the rounding order differs, so its agreement is the floor that
rounding alone sets on these random weights, whose logits lie close
together). Every mode but
``--mega`` decodes through ``rwkv7.decode_step`` (the WKV step kernel on a
card). ``wall_s`` is the seconds of the mode's own rollout and teacher
forcing. It runs on the card unless ``--device cpu`` is given, and prints
one JSON line:

    python -m rwkvtts_torch.eval.quant_quality --int4 [--hidden 1024 --layers 24 --steps 256]
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import time
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from rwkvtts_torch.infer import generate as gen
from rwkvtts_torch.models import rwkv7, spark
from rwkvtts_torch.ops import decode_mega_b64 as dmb

T_PROMPT = 64
MODES = ("int8", "int4-g64", "state-bf16", "int8+state-bf16", "mega-b64", "bf16-unfused")


def prompts(batch: int, device, seed: int = 1):
    """`batch` prompts of T_PROMPT random text ids in [0, 4000), the last
    position a tag: (tokens, modality, attention_mask) on `device`."""
    g = torch.Generator().manual_seed(seed)
    tokens = torch.randint(0, 4000, (batch, T_PROMPT), generator=g)
    modality = torch.full((batch, T_PROMPT), spark.MOD_TEXT, dtype=torch.long)
    modality[:, -1] = spark.MOD_TAG
    mask = torch.ones(batch, T_PROMPT, dtype=torch.long)
    return tokens.to(device), modality.to(device), mask.to(device)


@torch.inference_mode()
def forced_choices(params, cfg: spark.SparkTTSConfig, tokens, modality, mask,
                   forced: torch.Tensor, mega=None) -> torch.Tensor:
    """Teacher forcing: the prefill, then at each step the greedy choice of
    the f32 logits, after which forced[:, i] (not the choice) is fed
    through the decode step: ``rwkv7.decode_step`` on `params`
    (``pack_decode_params``'s tree), or the B=64 whole-step kernel on
    `mega`. Returns the choices (B, forced.shape[1])."""
    bb = cfg.backbone
    h, state = spark.prefill(params, cfg, tokens, modality, mask)
    if mega is None:
        state = rwkv7.pack_decode_state(state, bb)
        views = rwkv7.layer_decode_views(params, bb)
        step = lambda x, st: rwkv7.decode_step(views, bb, x, st)
    else:
        state = dmb.pack_state(state)
        step = lambda x, st: dmb.decode_step_mega_b64(mega, bb, x, st)
    head = params["head"].to(bb.dtype)
    choices = []
    for i in range(forced.shape[1]):
        choices.append(torch.argmax((h @ head).float(), -1))
        h, state = step(spark.decode_embed(params, cfg, forced[:, i]), state)
        h = h.to(bb.dtype)
    return torch.stack(choices, 1)


def nonzero_blocks(params, g: torch.Generator) -> None:
    """Draw the matrices the init leaves zero (each block's lora-in w1 /
    a1 / v1 / g1, its output and FFN value) as N(0, 1/in) from `g`, in
    place."""
    att, ffn = params["blocks"]["att"], params["blocks"]["ffn"]
    for tree, name in [(att, n) for n in ("w1", "a1", "v1", "g1", "output")] + [(ffn, "value")]:
        t = tree[name]
        tree[name] = torch.randn(t.shape, generator=g, device=t.device) * t.shape[-2] ** -0.5


def rollout(params, cfg: spark.SparkTTSConfig, tokens, modality, mask, steps: int,
            mega=None) -> torch.Tensor:
    """`steps` greedy tokens (top-k 1, the JAX script's sampling: ties drawn
    among by noise from a generator seeded 2) through ``spark_generate`` on
    `params`, or ``spark_generate_mega_b64`` on `mega`."""
    kw = dict(max_new_tokens=steps, top_k=1, top_p=1.0, temperature=1.0,
              generator=torch.Generator(device=tokens.device).manual_seed(2))
    if mega is None:
        return gen.spark_generate(params, cfg, tokens, modality, mask, **kw)[0]
    return gen.spark_generate_mega_b64(params, mega, cfg, tokens, modality, mask, **kw)[0]


def measure(modes: Sequence[str], hidden: int = 1024, layers: int = 24, steps: int = 256,
            device="cuda", seed: int = 0) -> List[Dict]:
    """Each mode of `modes` (MODES) against the comparator, which runs once
    for each batch size the modes need; one JSON record a mode."""
    bad = [m for m in modes if m not in MODES]
    if bad:
        raise ValueError(f"quant_quality: modes {bad} are not among {MODES}")
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("quant_quality: no CUDA device; pass --device cpu to run on the CPU")
    cfg = spark.default_config(hidden_size=hidden, num_layers=layers)
    g = torch.Generator(device=dev).manual_seed(seed)
    params = spark.init_params(g, cfg)
    nonzero_blocks(params, g)
    params = rwkv7.tree_map(lambda t: t.to(torch.bfloat16) if t.dim() >= 2 else t, params)
    p_fp = rwkv7.pack_decode_params(params, cfg.backbone)
    bf16_state = dataclasses.replace(
        cfg, backbone=dataclasses.replace(cfg.backbone, decode_state_bf16=True))
    comparators: Dict[int, tuple] = {}
    records = []
    for mode in modes:
        mega: Optional[dict] = None
        cfg_q, p_q = cfg, p_fp
        if mode == "mega-b64":
            mega, p_q = dmb.pack_mega_b64(params, cfg.backbone), params
        elif mode == "bf16-unfused":
            p_q = rwkv7.pack_decode_params(params, cfg.backbone, fuse_projections=False)
        elif mode in ("state-bf16", "int8+state-bf16"):
            cfg_q = bf16_state
            if mode == "int8+state-bf16":
                p_q = rwkv7.pack_decode_params(params, cfg.backbone, quantize_int8=True)
        else:
            p_q = rwkv7.pack_decode_params(params, cfg.backbone, quantize_int8=mode == "int8",
                                           quantize_int4=mode == "int4-g64")
        B = dmb.B if mode == "mega-b64" else 8
        if B not in comparators:
            batch = prompts(B, dev)
            ref = rollout(p_fp, cfg, *batch, steps)
            comparators[B] = (batch, ref, forced_choices(p_fp, cfg, *batch, ref))
        batch, ref, fp_choices = comparators[B]
        t0 = time.perf_counter()
        q_roll = rollout(p_q, cfg_q, *batch, steps, mega=mega)
        q_choices = forced_choices(p_q, cfg_q, *batch, ref, mega=mega)
        agree = float((fp_choices == q_choices).float().mean())
        ref_np, q_roll = ref.cpu().numpy(), q_roll.cpu().numpy()
        div = []
        for i in range(B):
            d = np.flatnonzero(ref_np[i] != q_roll[i])
            div.append(int(d[0]) if d.size else steps)
        quant = {"mega-b64": "mega-b64 (int8 proj + int8 lora-out + bf16 state)"}.get(mode, mode)
        records.append({
            "teacher_forced_top1_agreement": round(agree, 4),
            "free_running_token_agreement": round(float((ref_np == q_roll).mean()), 4),
            "median_first_divergence_step": int(np.median(div)),
            "quant": quant,
            "config": f"{hidden}x{layers} random-init, B={B}, greedy, {steps} steps",
            "wall_s": round(time.perf_counter() - t0, 1),
        })
        del mega, p_q
    return records


def mode_of(args) -> str:
    """The mode the JAX script's flags select."""
    if args.mega:
        return "mega-b64"
    if args.unfused:
        return "bf16-unfused"
    if args.state_bf16:
        return "int8+state-bf16" if args.int8 else "state-bf16"
    return "int4-g64" if args.int4 else "int8"


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--int4", action="store_true", help="int4 group-wise weights, not int8")
    ap.add_argument("--int8", action="store_true",
                    help="with --state-bf16: int8 weights and the bf16 state together")
    ap.add_argument("--state-bf16", action="store_true",
                    help="the bf16 WKV state carry (the same weights)")
    ap.add_argument("--mega", action="store_true",
                    help="the B=64 whole-step decode kernel (int8, bf16 state)")
    ap.add_argument("--unfused", action="store_true",
                    help="the control: bf16 weights through the seven-product step")
    ap.add_argument("--hidden", type=int, default=1024)
    ap.add_argument("--layers", type=int, default=24)
    ap.add_argument("--steps", type=int, default=256)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    print(json.dumps(measure([mode_of(args)], args.hidden, args.layers, args.steps,
                             args.device)[0]))


if __name__ == "__main__":
    main()
