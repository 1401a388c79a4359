"""Timeline of the B=1 decode step (csrc/decode_b1.cu) on the card.

Builds an instrumented copy of rwkvtts_torch/csrc into
rwkvtts_torch/csrc/build/timeline/, in which thread 0 of every CTA of the
step's kernels writes %globaltimer at six points: its start, the return of
griddepcontrol.wait, its lhs (products) or lora-out weights (glue) ready,
its last weight box consumed (products) or lora-out done (glue), its
partial sums received (the reducing CTAs of a product) or WKV update done
(glue), and its end. Then it runs the step at 2048 x 24 on phase 11's
weights (bf16 carry), with and without programmatic dependent launch, and
prints for each kernel of the layer the mean over layers 1 .. L - 2 of each
stamp's latest CTA, in microseconds after the previous kernel's last CTA
ended, and the mean time from that end to its own. The stamps cost a
little: compare phases, not the step's ms, with the uninstrumented build.

    python3 scripts/profile_decode_b1.py
"""
from __future__ import annotations

import ctypes
import shutil
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402
from rwkvtts_torch import _build  # noqa: E402

KERNELS = ("rkv_li", "glue", "out", "fk", "fv")  # a layer's launches, in order
STAMPS = ("start", "waited", "lhs / lora-out weights", "boxes / lora-out",
          "sums / update", "end")
MAX_CTAS = 512

PRE = r'''
__device__ unsigned long long g_stamps[128 * 512 * 6];
namespace {
// thread 0 of the CTA writes the time at point i of launch seq
__device__ __forceinline__ void stamp(int seq, int i) {
    if (threadIdx.x == 0) {
        unsigned long long t;
        asm volatile("mov.u64 %0, %globaltimer;" : "=l"(t));
        g_stamps[((size_t)seq * 512 + blockIdx.x) * 6 + i] = t;
    }
}
}  // namespace
'''

# (anchor, the same with a stamp) in decode_b1.cu; a product's launch is
# 5 layer + SEQ<PROD>, the glue's 5 layer + 1
EDITS = (
    ("    const int plane = sg.plane0 + lt / sg.tiles_per_plane;\n",
     "    const int plane = sg.plane0 + lt / sg.tiles_per_plane;\n"
     "    const int seq = 5 * sg.layer + (PROD == P_RKV_LI ? 0 : PROD + 1);\n"
     "    stamp(seq, 0);\n"),
    ("    pdl_wait();\n    // this CTA's columns of the output",
     "    pdl_wait();\n    stamp(seq, 1);\n    // this CTA's columns of the output"),
    ("    sync_compute();\n    // the next kernel launches",
     "    sync_compute();\n    stamp(seq, 2);\n    // the next kernel launches"),
    ("    // the warp's rows (lanes TPR apart) in a fixed order",
     "    stamp(seq, 3);\n    // the warp's rows (lanes TPR apart) in a fixed order"),
    ("        if (tid < TB) epilogue(sg, n0 + tid, sum * sg.s[n0 + tid], old);\n        return;",
     "        if (tid < TB) epilogue(sg, n0 + tid, sum * sg.s[n0 + tid], old);\n"
     "        stamp(seq, 5);\n        return;"),
    ("        mbar_wait(sumbar, 0);\n        float s = 0.f;",
     "        mbar_wait(sumbar, 0);\n        stamp(seq, 4);\n        float s = 0.f;"),
    ("        epilogue(sg, n, s * sg.s[n], old);\n    }\n}",
     "        epilogue(sg, n, s * sg.s[n], old);\n        stamp(seq, 5);\n    }\n}"),
    ("    const int C = g.C;\n    if (tid == 0) {\n        mbar_init(bar, 1);",
     "    const int C = g.C, seq = 5 * g.layer + 1;\n    stamp(seq, 0);\n"
     "    if (tid == 0) {\n        mbar_init(bar, 1);"),
    ("    pdl_wait();\n    float r = 0.f, k0 = 0.f",
     "    pdl_wait();\n    stamp(seq, 1);\n    float r = 0.f, k0 = 0.f"),
    ("    mbar_wait(bar, 0);\n    {", "    mbar_wait(bar, 0);\n    stamp(seq, 2);\n    {"),
    ("    // prep of channel c", "    stamp(seq, 3);\n    // prep of channel c"),
    ("    if (lane < GLUE_ROWS) sy[row0 + lane] = y_mine;\n    __syncthreads();",
     "    if (lane < GLUE_ROWS) sy[row0 + lane] = y_mine;\n    __syncthreads();\n"
     "    stamp(seq, 4);"),
    ("        g.y_g[c] = __float2bfloat16((y_n + s_bh * v) * gate);\n    }\n}",
     "        g.y_g[c] = __float2bfloat16((y_n + s_bh * v) * gate);\n    }\n"
     "    stamp(seq, 5);\n}"),
)


def instrument(src: str) -> str:
    src = src.replace('#include "sm90.cuh"\n', '#include "sm90.cuh"\n' + PRE, 1)
    for old, new in EDITS:
        if src.count(old) != 1:
            raise RuntimeError(f"instrument: {old!r} is not found once in decode_b1.cu")
        src = src.replace(old, new)
    return src + '''
extern "C" int decode_b1_stamps(unsigned long long* out) {
    return (int)cudaMemcpyFromSymbol(out, g_stamps, sizeof(g_stamps));
}
'''


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("profile_decode_b1: needs an NVIDIA GPU")
    dst = _build.BUILD_DIR / "timeline"
    shutil.rmtree(dst, ignore_errors=True)
    shutil.copytree(_build.CSRC, dst, ignore=shutil.ignore_patterns("build"))
    (dst / "decode_b1.cu").write_text(instrument((dst / "decode_b1.cu").read_text()))
    _build.CSRC, _build.BUILD_DIR = dst, dst / "build"
    lib = _build.library()
    lib.decode_b1_stamps.argtypes = [ctypes.c_void_p]
    from rwkvtts_torch.ops import decode_mega as dm

    print(chip_smoke.subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip())
    dev = torch.device("cuda", 0)
    cfg, mega, g = chip_smoke.b1_setup(dev)
    state = chip_smoke.b1_state(g, cfg, torch.bfloat16)
    x = torch.randn(1, cfg.hidden_size, generator=g, device=dev)
    L = cfg.num_layers
    plan = dm.launch_plan(cfg.hidden_size)["products"]
    ctas = [plan["rkv_li"]["ctas"], cfg.num_heads, plan["out"]["ctas"], plan["fk"]["ctas"],
            plan["fv"]["ctas"]]
    buf = np.zeros(128 * MAX_CTAS * 6, dtype=np.uint64)
    for pdl in (True, False):
        for _ in range(5):
            dm.decode_step_mega(mega, cfg, x, state, pdl=pdl)
        torch.cuda.synchronize()
        ms = chip_smoke.cuda_ms(lambda: dm.decode_step_mega(mega, cfg, x, state, pdl=pdl), 10)
        dm.decode_step_mega(mega, cfg, x, state, pdl=pdl)
        torch.cuda.synchronize()
        chip_smoke.check(lib.decode_b1_stamps(buf.ctypes.data) == 0, "reading the stamps")
        s = buf.reshape(128, MAX_CTAS, 6).astype(np.int64)
        t0 = s[0, :ctas[0], 0].min()
        s[s < t0] = 0  # stamps left by earlier steps (CTAs that write none here)
        latest = np.array([[s[5 * l + k, :ctas[k], i].max() for i in range(6)]
                           for l in range(L) for k in range(5)], dtype=np.float64)
        ends = latest[:, 5]
        rows = {k: [] for k in KERNELS}
        for j in range(5, 5 * (L - 1)):  # layers 1 .. L - 2
            prev = ends[j - 1]
            rows[KERNELS[j % 5]].append([(latest[j, i] - prev) / 1e3 if latest[j, i] else
                                         np.nan for i in range(6)])
        print(f"decode b1 timeline, pdl={pdl}: {ms:.4f} ms a step (instrumented build); "
              f"{(ends[-1] - t0) / 1e6:.4f} ms from the first CTA's start to the last FFN "
              "value's end")
        for k in KERNELS:
            m = np.nanmean(np.array(rows[k]), axis=0)
            print(f"  {k:6s}: us after the previous kernel's end, latest CTA: "
                  + ", ".join(f"{n} {v:.2f}" for n, v in zip(STAMPS, m)))


if __name__ == "__main__":
    main()
