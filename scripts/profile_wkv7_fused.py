"""Per-phase clock profile of the chunked fused WKV7 kernels on the card.

Builds an instrumented copy of rwkvtts_torch/csrc, in which thread 0 of each
CTA reads clock64() after every barrier of the chunk loop (and at its end)
and CTA 0's sums are read back, into rwkvtts_torch/csrc/build/phase_clock/.
Then it runs, at the training shape (8, 2048, 16) bf16 on phase 8's inputs,
the saving forward and the backward once under autograd and the primal
forward once, and prints the cycles a chunk by phase and their sum, with
the instrumented build's ms (chip_smoke.fused_times). The stamps cost a
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
    "forward": ["prologue", "decays", "pairwise A Kz QB QK",
                "inverse; z0 S, Kz v, q0 S, QK v", "sa, y, state update, anchors",
                "GroupNorm, bonus, y out"],
    "backward": ["prologue", "decays", "pairwise", "inverse; z0 S, Kz v, q0 S, QK v",
                 "sa, y", "GroupNorm adjoint", "state gradient chain",
                 "pairwise gradients", "qt zt bt kt gradients", "dlogw scan, sums",
                 "dlogw scan", "prologue adjoint, writes"],
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


def instrument(src: str) -> str:
    """wkv7_fused.cu with a stamp after each barrier of the two chunk loops."""
    src = src.replace("using namespace wkv7c;\n", "using namespace wkv7c;\n" + PRE, 1)
    for k, (start, end, loop, tail) in enumerate((
            ("wkv7_fused_fwd_kernel(", "template <typename T>\n__global__",
             "    for (int ci = 0; ci < nc; ++ci) {\n",
             "        if (valid) st4<T>(y + base + tt * step, out);\n    }\n"),
            ("wkv7_fused_bwd_kernel(", "template <typename K>",
             "    for (int ci = nc - 1; ci >= 0; --ci) {\n", "        cur ^= 1;\n    }\n"))):
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
    return src + '''
extern "C" int wkv7_fused_prof(unsigned long long* out) {
    return (int)cudaMemcpyFromSymbol(out, g_prof, sizeof(g_prof));
}
'''


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("profile_wkv7_fused: needs an NVIDIA GPU")
    dst = _build.BUILD_DIR / "phase_clock"
    shutil.rmtree(dst, ignore_errors=True)
    shutil.copytree(_build.CSRC, dst, ignore=shutil.ignore_patterns("build"))
    (dst / "wkv7_fused.cu").write_text(instrument((dst / "wkv7_fused.cu").read_text()))
    _build.CSRC, _build.BUILD_DIR = dst, dst / "build"
    lib = _build.library()
    lib.wkv7_fused_prof.argtypes = [ctypes.c_void_p]
    from rwkvtts_torch.ops import wkv7_cuda

    print(chip_smoke.subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip())
    times = chip_smoke.fused_times_of_tree("instrumented")
    dev = torch.device("cuda", 0)
    g = torch.Generator(device=dev).manual_seed(8)
    B, T, H = chip_smoke.TRAIN_B, chip_smoke.TRAIN_T, chip_smoke.TRAIN_H
    seq, prm, _, _ = chip_smoke.fused_inputs(g, B, T, H, torch.bfloat16)
    n_chunks = -(-T // wkv7_cuda.CHUNK)
    buf = (ctypes.c_ulonglong * 32)()

    def report(what: str, kernel: int) -> list:
        torch.cuda.synchronize()
        chip_smoke.check(lib.wkv7_fused_prof(ctypes.cast(buf, ctypes.c_void_p)) == 0,
                         "reading the phase clock")
        names = PHASES["forward" if kernel == 0 else "backward"]
        cyc = [x / n_chunks for x in list(buf)[16 * kernel:16 * kernel + len(names)]]
        print(f"{what}: {sum(cyc):.0f} cycles a chunk (CTA 0, {n_chunks} chunks): "
              + "; ".join(f"{n} {c:.0f}" for n, c in zip(names, cyc)))
        return cyc

    ins = [x.detach().clone().requires_grad_() for x in seq + prm]
    y, s = wkv7_cuda.wkv7_fused(*ins)
    report("saving forward", 0)
    torch.autograd.grad((y, s), ins, (torch.ones_like(y), torch.zeros_like(s)))
    report("backward", 1)
    with torch.no_grad():
        wkv7_cuda.wkv7_fused(*seq, *prm)
    report("primal forward", 0)
    print(f"instrumented build: {times}")


if __name__ == "__main__":
    main()
