"""Per-phase clock profile of the chunked WKV7 kernels on the card: the fused
pair (csrc/wkv7_fused.cu) and the unfused forward (csrc/wkv7_fwd.cu).

Builds an instrumented copy of rwkvtts_torch/csrc, in which thread 0 of each
CTA reads clock64() after every barrier of the chunk loop (and at its end)
and CTA 0's sums are read back, into rwkvtts_torch/csrc/build/phase_clock/.
Then it runs, at the training shape (8, 2048, 16) bf16 on phase 8's inputs,
the fused saving forward and backward once under autograd and the fused
primal once; and the unfused forward once at each shape of
chip_smoke.WKV_FWD_SHAPES (generation prefill, Cosy prefill, one admission
bucket, the saving forward of training). It prints the cycles a chunk by
phase and their sum, with the instrumented build's ms
(chip_smoke.fused_times, chip_smoke.wkv7_fwd_times). The stamps cost a
little; compare phases, not the ms, with the uninstrumented kernels.

    python3 scripts/profile_wkv7_fused.py
"""
from __future__ import annotations

import ctypes
import shutil
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402
from rwkvtts_torch import _build  # noqa: E402

PHASES = {
    "fused forward": ["prologue", "decays", "pairwise A Kz QB QK",
                      "inverse; z0 S, Kz v, q0 S, QK v", "sa, y, state update, anchors",
                      "GroupNorm, bonus, y out"],
    "fused backward": ["prologue", "decays", "pairwise", "inverse; z0 S, Kz v, q0 S, QK v",
                       "sa, y", "GroupNorm adjoint", "state gradient chain",
                       "pairwise gradients", "qt zt bt kt gradients", "dlogw scan, sums",
                       "dlogw scan", "prologue adjoint, writes"],
    "forward": ["inputs to tiles", "decays", "pairwise A Kz QB QK",
                "inverse; z0 S, Kz v, q0 S, QK v", "sa, y out, state update, anchors"],
}

# each instrumented kernel: its source, where its body starts and ends, the
# head and the tail of its chunk loop, and its slot in the file's clock table
KERNELS = {
    "fused forward": ("wkv7_fused.cu", "wkv7_fused_fwd_kernel(",
                      "template <typename T>\n__global__",
                      "    for (int ci = 0; ci < nc; ++ci) {\n",
                      "        if (valid) st4<T>(y + base + tt * step, out);\n    }\n", 0),
    "fused backward": ("wkv7_fused.cu", "wkv7_fused_bwd_kernel(", "template <typename K>",
                       "    for (int ci = nc - 1; ci >= 0; --ci) {\n",
                       "        cur ^= 1;\n    }\n", 1),
    "forward": ("wkv7_fwd.cu", "wkv7_fwd_kernel(",
                "template <typename T, bool SAVE>\nint launch_fwd",
                "    for (int c = 0; c < nc; ++c) {\n",
                "S, i0);\n        }\n    }\n", 0),
}

PRE = r'''
__device__ unsigned long long g_prof[2][16];
#define PROF_DECL __shared__ unsigned long long sprof[16]; int ph = 0; \
    long long last = clock64(); if (threadIdx.x < 16) sprof[threadIdx.x] = 0;
#define PROF() do { if (threadIdx.x == 0) { long long t_ = clock64(); \
    sprof[ph] += t_ - last; last = t_; } ++ph; } while (0)
#define PROF_END(K) do { if (threadIdx.x == 0 && blockIdx.x == 0) \
    for (int q_ = 0; q_ < 16; ++q_) g_prof[K][q_] = sprof[q_]; } while (0)
'''


def instrument(src: str, stem: str, kernels: list) -> str:
    """A source with a stamp after each barrier of the given kernels' chunk
    loops, and `<stem>_prof` to read CTA 0's sums back."""
    src = src.replace("using namespace wkv7c;\n", "using namespace wkv7c;\n" + PRE, 1)
    for _, start, end, loop, tail, k in kernels:
        i = src.index(start)
        j = src.index(end, i)
        body = src[i:j]
        for old, new in ((loop, "    PROF_DECL\n" + loop + "        ph = 0;\n"),
                         ("__syncthreads();", "__syncthreads(); PROF();"),
                         (tail, tail[:tail.rindex("    }\n")] + "        PROF();\n    }\n"
                          f"    PROF_END({k});\n")):
            if old not in body:
                raise RuntimeError(f"instrument: {old!r} not found in {start}")
            body = body.replace(old, new, 1) if old != "__syncthreads();" else body.replace(old, new)
        src = src[:i] + body + src[j:]
    return src + f'''
extern "C" int {stem}_prof(unsigned long long* out) {{
    return (int)cudaMemcpyFromSymbol(out, g_prof, sizeof(g_prof));
}}
'''


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("profile_wkv7_fused: needs an NVIDIA GPU")
    dst = _build.BUILD_DIR / "phase_clock"
    shutil.rmtree(dst, ignore_errors=True)
    shutil.copytree(_build.CSRC, dst, ignore=shutil.ignore_patterns("build"))
    for name in ("wkv7_fused.cu", "wkv7_fwd.cu"):
        spots = [v for v in KERNELS.values() if v[0] == name]
        (dst / name).write_text(instrument((dst / name).read_text(), Path(name).stem, spots))
    _build.CSRC, _build.BUILD_DIR = dst, dst / "build"
    lib = _build.library()
    for name in ("wkv7_fused_prof", "wkv7_fwd_prof"):
        getattr(lib, name).argtypes = [ctypes.c_void_p]
    from rwkvtts_torch.ops import wkv7_cuda

    print(chip_smoke.subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip())
    times = chip_smoke.fused_times_of_tree("instrumented")
    fwd_times = chip_smoke.wkv7_fwd_times("instrumented wkv7 fwd")
    dev = torch.device("cuda", 0)
    g = torch.Generator(device=dev).manual_seed(8)
    B, T, H = chip_smoke.TRAIN_B, chip_smoke.TRAIN_T, chip_smoke.TRAIN_H
    seq, prm, _, _ = chip_smoke.fused_inputs(g, B, T, H, torch.bfloat16)
    buf = (ctypes.c_ulonglong * 32)()

    def report(what: str, kernel: str, n_chunks: int) -> list:
        torch.cuda.synchronize()
        reader = lib.wkv7_fwd_prof if kernel == "forward" else lib.wkv7_fused_prof
        chip_smoke.check(reader(ctypes.cast(buf, ctypes.c_void_p)) == 0,
                         "reading the phase clock")
        names, k = PHASES[kernel], KERNELS[kernel][-1]
        cyc = [x / n_chunks for x in list(buf)[16 * k:16 * k + len(names)]]
        print(f"{what}: {sum(cyc):.0f} cycles a chunk (CTA 0, {n_chunks} chunks): "
              + "; ".join(f"{n} {c:.0f}" for n, c in zip(names, cyc)))
        return cyc

    n_chunks = -(-T // wkv7_cuda.CHUNK)
    ins = [x.detach().clone().requires_grad_() for x in seq + prm]
    y, s = wkv7_cuda.wkv7_fused(*ins)
    report("fused saving forward", "fused forward", n_chunks)
    torch.autograd.grad((y, s), ins, (torch.ones_like(y), torch.zeros_like(s)))
    report("fused backward", "fused backward", n_chunks)
    with torch.no_grad():
        wkv7_cuda.wkv7_fused(*seq, *prm)
    report("fused primal forward", "fused forward", n_chunks)
    print(f"instrumented build: {times}")

    g = torch.Generator(device=dev).manual_seed(3)
    for name, Bn, T, H, saving in chip_smoke.WKV_FWD_SHAPES:
        ins, _, _ = chip_smoke.wkv_inputs(g, Bn, T, H, torch.bfloat16)
        state = None if saving else torch.zeros(Bn, H, 64, 64, device=dev)
        wkv7_cuda._fwd(*ins, state, None, save=saving)
        report(f"wkv7 fwd {name} ({Bn}, {T}, {H})", "forward",
               -(-T // wkv7_cuda.CHUNK))
    print(f"instrumented wkv7 fwd: {fwd_times}")


if __name__ == "__main__":
    main()
