"""Smoke run of the PyTorch + CUDA port (``rwkvtts_torch``) on one NVIDIA GPU.

It builds the port's two hand-written CUDA kernels from ``rwkvtts_torch/csrc``,
holds each against its plain PyTorch version on the card, checks a small
generation against the plain path on the CPU, then drives the main path once:
Spark speech-LM batched generation at 1024 hidden x 24 layers (random weights
from a seed), B = 64, a 128-token prompt and 256 new tokens at top-k 50 /
top-p 0.95, the configuration of ``bench.py``.

Phases, each printing its own lines; any failure raises, so the run exits
non-zero and prints no result:

  1. device  the card's name and power limit (nvidia-smi); no CUDA device is an error
  2. build   nvcc of rwkvtts_torch/csrc/*.cu into a ctypes library
  3. wkv7    the prefill kernel vs ops/wkv7.wkv7_scan (f32 reference)
  4. decode  the B=64 decode step vs decode_step_plain, 4 chained steps
  5. small   greedy generation at hidden 256 x 2 layers: kernels on the card
             vs plain versions on the CPU
  6. main    the full-size generation, launch counts, audio tok/s

The line before the last is the kernel table as JSON; the last line is
``{"ok": true, "device": {...}}``. Run from the repository root:

    python3 chip_smoke.py
"""
from __future__ import annotations

import json
import subprocess
import time

import torch

# the kernels' C entry points and the TPU kernels they replace
WKV7_SOURCE = "rwkvtts_torch/csrc/wkv7_fwd.cu"
WKV7_REPLACES = "rwkvtts_tpu/ops/wkv7_pallas.py:269"
DECODE_SOURCE = "rwkvtts_torch/csrc/decode_b64.cu"
DECODE_REPLACES = "rwkvtts_tpu/ops/decode_mega_b64.py:289"

B = 64
PROMPT, NEW_TOKENS = 128, 256


def rel(a: torch.Tensor, b: torch.Tensor) -> float:
    """max |a - b| / max |b|."""
    a, b = a.float(), b.float()
    return ((a - b).abs().max() / b.abs().max().clamp_min(1e-30)).item()


def max_abs(a: torch.Tensor, b: torch.Tensor) -> float:
    return (a.float() - b.float()).abs().max().item()


def cuda_ms(fn, reps: int) -> float:
    """Mean milliseconds per call between CUDA events, after one warm call."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"chip_smoke: {what}")


# ---------------------------------------------------------------------------
# 3. WKV7 forward
# ---------------------------------------------------------------------------


def wkv_inputs(g: torch.Generator, Bn: int, T: int, H: int, dtype):
    """Inputs in the model's ranges: w_raw <= -0.5, z = -kk and b = kk * a
    with kk unit-norm per head."""
    dev = g.device
    f = lambda: torch.randn(Bn, T, H, 64, generator=g, device=dev)
    r, k, v = f(), 0.3 * f(), f()
    w_raw = -0.5 - f().abs()
    kk = torch.nn.functional.normalize(f(), dim=-1)
    a = torch.sigmoid(f())
    ins = [x.to(dtype).contiguous() for x in (r, w_raw, k, v, -kk, kk * a)]
    state = 0.1 * torch.randn(Bn, H, 64, 64, generator=g, device=dev)
    resets = torch.rand(Bn, T, generator=g, device=dev) < 0.05
    return ins, state, resets


def phase_wkv7(dev) -> dict:
    from rwkvtts_torch.ops import wkv7_cuda
    from rwkvtts_torch.ops.wkv7 import wkv7_scan

    g = torch.Generator(device=dev).manual_seed(1)
    for dtype, tol in ((torch.float32, 1e-4), (torch.bfloat16, 2e-2)):
        for with_state in (True, False):
            ins, state, resets = wkv_inputs(g, 4, 200, 16, dtype)
            st, rs = (state, resets) if with_state else (None, None)
            y_k, s_k = wkv7_cuda.wkv7_fwd(*ins, st, rs)
            y_p, s_p = wkv7_scan(*(x.float() for x in ins), st, rs)
            ey, es = rel(y_k, y_p), rel(s_k, s_p)
            print(f"wkv7: {str(dtype)[6:]} B=4 T=200 H=16 state+resets={with_state}: "
                  f"y rel {ey:.3e}, state rel {es:.3e} (limit {tol:g})")
            check(y_k.dtype == dtype and s_k.dtype == torch.float32, "wkv7 output dtypes")
            check(ey <= tol and es <= tol, "wkv7 kernel disagrees with wkv7_scan")

    # the main path's shape: the prefill of 64 prompts of 128 tokens, H = 16,
    # bf16, a zero initial state and no resets
    ins, _, _ = wkv_inputs(g, B, PROMPT, 16, torch.bfloat16)
    state = torch.zeros(B, 16, 64, 64, device=dev)
    y_k, s_k = wkv7_cuda.wkv7_fwd(*ins, state, None)
    y_p, s_p = wkv7_scan(*(x.float() for x in ins), state, None)
    ey, es = rel(y_k, y_p), rel(s_k, s_p)
    check(ey <= 2e-2 and es <= 2e-2, "wkv7 kernel disagrees at the main path's shape")
    ms = cuda_ms(lambda: wkv7_cuda.wkv7_fwd(*ins, state, None), 20)
    plain_ms = cuda_ms(lambda: wkv7_scan(*ins, state, None), 2)
    print(f"wkv7: bf16 B={B} T={PROMPT} H=16 (main path): y rel {ey:.3e}, state rel "
          f"{es:.3e}; kernel {ms:.4f} ms, plain {plain_ms:.4f} ms")
    return {"name": "wkv7_fwd", "route": "cuda", "source": WKV7_SOURCE,
            "replaces": WKV7_REPLACES, "max_abs_err": max_abs(y_k, y_p),
            "ms": ms, "plain_ms": plain_ms}


# ---------------------------------------------------------------------------
# 4. Decode step
# ---------------------------------------------------------------------------


def randomize(params: dict, g: torch.Generator) -> None:
    """Make the lora-in, output and FFN value matrices nonzero (the init
    zeroes them) so every term of the step is exercised."""
    att, ffn = params["blocks"]["att"], params["blocks"]["ffn"]
    for tree, name in [(att, n) for n in ("w1", "a1", "v1", "g1", "output")] + [(ffn, "value")]:
        t = tree[name]
        tree[name] = torch.randn(t.shape, generator=g, device=t.device) * t.shape[-2] ** -0.5


def phase_decode(dev) -> tuple[dict, dict]:
    from rwkvtts_torch.models import rwkv7
    from rwkvtts_torch.ops import decode_mega_b64 as dmb

    cfg = rwkv7.RWKV7Config(vocab_size=8193, hidden_size=1024, num_layers=24)
    L, C, H = cfg.num_layers, cfg.hidden_size, cfg.num_heads
    g = torch.Generator(device=dev).manual_seed(2)
    params = rwkv7.init_params(g, cfg)
    randomize(params, g)
    mega = dmb.pack_mega_b64(params, cfg)
    del params
    bf = lambda *shape, s: (s * torch.randn(*shape, generator=g, device=dev)).to(torch.bfloat16)
    st_k = {"att_x": bf(L, B, C, s=0.5), "wkv": bf(L, B, H, 64, 64, s=0.1),
            "ffn_x": bf(L, B, C, s=0.5)}
    st_p = {k: v.clone() for k, v in st_k.items()}
    err = 0.0
    for i in range(4):
        x = torch.randn(B, C, generator=g, device=dev)
        h_k, _ = dmb.decode_step_mega_b64(mega, cfg, x, st_k)
        h_p, _ = dmb.decode_step_plain(mega, cfg, x, st_p)
        eh = rel(h_k, h_p)
        err = max(err, max_abs(h_k, h_p))
        print(f"decode: step {i}: hidden rel {eh:.3e} (limit 2e-2)")
        check(bool(torch.isfinite(h_k).all()), "decode hidden is not finite")
        check(eh <= 2e-2, "decode kernel disagrees with decode_step_plain")
    for leaf in ("att_x", "ffn_x", "wkv"):
        es = rel(st_k[leaf], st_p[leaf])
        print(f"decode: after 4 steps: state {leaf} rel {es:.3e} (limit 2e-2)")
        check(es <= 2e-2, f"decode state {leaf} disagrees")

    dmb.reset_launches()
    dmb.decode_step_mega_b64(mega, cfg, x, st_k)
    per_step = dict(dmb.kernel_launches)
    ms = cuda_ms(lambda: dmb.decode_step_mega_b64(mega, cfg, x, st_k), 20)
    plain_ms = cuda_ms(lambda: dmb.decode_step_plain(mega, cfg, x, st_p), 3)
    print(f"decode: C={C} L={L} B={B}: {per_step} launches a step; kernel "
          f"{ms:.4f} ms, plain {plain_ms:.4f} ms a step")
    return ({"name": "decode_b64_step", "route": "cuda", "source": DECODE_SOURCE,
             "replaces": DECODE_REPLACES, "max_abs_err": err, "ms": ms,
             "plain_ms": plain_ms}, per_step)


# ---------------------------------------------------------------------------
# 5. Small generation: kernels on the card vs plain versions on the CPU
# ---------------------------------------------------------------------------


def left_padded_prompt(g: torch.Generator, T: int):
    from rwkvtts_torch.models import spark

    tokens = torch.randint(0, 4000, (B, T), generator=g)
    modality = torch.full((B, T), spark.MOD_TEXT)
    modality[:, -1] = spark.MOD_TAG
    tokens[:, -1] = spark.TAG_START_TTS
    mask = torch.ones(B, T, dtype=torch.int32)
    for b, n in enumerate(torch.randint(0, T // 2, (B,), generator=g).tolist()):
        mask[b, :n] = 0
        modality[b, :n] = spark.MOD_PAD
        tokens[b, :n] = 0
    return tokens, modality, mask


def phase_small(dev) -> None:
    from rwkvtts_torch.infer.generate import spark_generate_mega_b64
    from rwkvtts_torch.models import rwkv7, spark
    from rwkvtts_torch.ops import decode_mega_b64 as dmb

    cfg = spark.default_config(hidden_size=256, num_layers=2, dtype=torch.float32)
    g = torch.Generator().manual_seed(3)
    params = spark.init_params(g, cfg)
    randomize(params, g)
    params["head"] = 10.0 * params["head"]  # greedy gaps far above rounding noise
    prompt = left_padded_prompt(g, 8)
    n_new, V = 8, cfg.backbone.vocab_size
    out = {}
    for where in ("cpu", dev):
        p = rwkv7.tree_map(lambda t: t.to(where), params)
        mega = dmb.pack_mega_b64(p, cfg.backbone)
        out[str(where)] = spark_generate_mega_b64(
            p, mega, cfg, *(t.to(where) for t in prompt), max_new_tokens=n_new,
            top_k=1, top_p=1.0, noise=torch.zeros(n_new, B, V, device=where))
    (t_cpu, _), (t_gpu, _) = out["cpu"], out[str(dev)]
    same = (t_gpu.cpu() == t_cpu).float()
    first, agree = same[:, 0].mean().item(), same.mean().item()
    # the first token depends only on the f32 prefill and must match; later
    # ones go through the int8 decode step, whose bf16 rounding points can
    # flip a near-tie, and a flip changes the rest of its row
    print(f"small: hidden 256 x 2 layers, B={B}, 8 + {n_new} tokens, greedy, vs the "
          f"plain path on the CPU: first token {first:.4f} equal (limit 1), "
          f"all tokens {agree:.4f} equal (limit 0.95)")
    check(first == 1.0 and agree >= 0.95, "small generation disagrees with the plain path")


# ---------------------------------------------------------------------------
# 6. Main path
# ---------------------------------------------------------------------------


def phase_main(dev, card: str, per_step: dict) -> dict:
    from rwkvtts_torch.infer.generate import spark_generate_mega_b64
    from rwkvtts_torch.models import rwkv7, spark
    from rwkvtts_torch.ops import decode_mega_b64 as dmb
    from rwkvtts_torch.ops import wkv7_cuda

    cfg = spark.default_config(hidden_size=1024, num_layers=24)
    t0 = time.perf_counter()
    params = spark.init_params(torch.Generator(device=dev).manual_seed(0), cfg)
    params = rwkv7.tree_map(lambda t: t.to(torch.bfloat16) if t.ndim >= 2 else t, params)
    mega = dmb.pack_mega_b64(params, cfg.backbone)
    torch.cuda.synchronize()
    print(f"main: Spark {cfg.backbone.hidden_size} x {cfg.backbone.num_layers} params "
          f"and int8 pack built in {time.perf_counter() - t0:.1f} s")

    def run(seed):
        g = torch.Generator(device=dev).manual_seed(seed)
        tokens = torch.randint(0, 4000, (B, PROMPT), generator=g, device=dev)
        modality = torch.full((B, PROMPT), spark.MOD_TEXT, device=dev)
        modality[:, -1] = spark.MOD_TAG
        mask = torch.ones(B, PROMPT, dtype=torch.int32, device=dev)
        return spark_generate_mega_b64(
            params, mega, cfg, tokens, modality, mask, max_new_tokens=NEW_TOKENS,
            temperature=1.0, top_k=50, top_p=0.95, generator=g)

    run(1)
    torch.cuda.synchronize()
    wkv7_cuda.reset_launches()
    dmb.reset_launches()
    t0 = time.perf_counter()
    toks, lengths = run(2)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = {"wkv7_fwd": wkv7_cuda.launches, "decode_b64_step": dmb.launches}
    by_kernel = dict(dmb.kernel_launches)

    check(toks.shape == (B, NEW_TOKENS) and lengths.shape == (B,), "output shapes")
    check(bool(((toks >= 0) & (toks <= cfg.eos_token_id)).all()), "token out of [0, 8192]")
    check(bool(((lengths >= 0) & (lengths <= NEW_TOKENS)).all()), "length out of range")
    check(launches["wkv7_fwd"] == cfg.backbone.num_layers,
          f"wkv7 kernel launched {launches['wkv7_fwd']} times in the prefill")
    for name, n in per_step.items():
        check(by_kernel[name] >= NEW_TOKENS * n,
              f"decode kernel {name} launched {by_kernel[name]} times, "
              f"want >= {NEW_TOKENS} x {n}")
    tps = B * NEW_TOKENS / seconds
    print(f"main: launches {launches}, decode by kernel {by_kernel}")
    print(f"main: B={B}, {PROMPT} + {NEW_TOKENS} tokens: {seconds:.4f} s, "
          f"{tps:.1f} audio tok/s on {card}; mean length {lengths.float().mean().item():.1f}")
    return {"launches": launches, "by_kernel": by_kernel}


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; "
                         "this script needs an NVIDIA GPU")
    from rwkvtts_torch import _build

    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(card)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}")

    t0 = time.perf_counter()
    _build.library()
    lib_path = _build.library_path()
    print(f"build: {time.perf_counter() - t0:.1f} s "
          f"(nvcc {_build.last_build_seconds:.1f} s) -> {lib_path.name}")
    for line in lib_path.with_suffix(".log").read_text().splitlines():
        if "Used" in line or "Compiling entry" in line:
            print("build: " + line.strip())

    wkv_row = phase_wkv7(dev)
    decode_row, per_step = phase_decode(dev)
    phase_small(dev)
    main_run = phase_main(dev, card, per_step)

    wkv_row["launches"] = main_run["launches"]["wkv7_fwd"]
    decode_row["launches"] = main_run["launches"]["decode_b64_step"]
    decode_row["launches_by_kernel"] = main_run["by_kernel"]
    print(json.dumps({"kernels": [wkv_row, decode_row]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
