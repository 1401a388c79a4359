"""Kernel 2 (csrc/wkv7_fwd.cu) at one CTA an SM against the two it is built
for, timed in turns in one process on the card.

The forward is built so that two of its CTAs reside on an SM: at most 128
registers a thread (``__launch_bounds__(256, 2)``) and, in bf16, 102,016
bytes of shared memory a CTA. This copies rwkvtts_torch/csrc into
rwkvtts_torch/csrc/build/one_cta/, where the forward asks for PAD more bytes
of shared memory a CTA than it uses, so that two no longer fit the SM's
228 KB (1 KB of it reserved a CTA), and nothing else changes. It checks that
both builds give the same bits, then times kernel 2 as built and so padded
in turns (as built, one CTA, one CTA, as built) with
``chip_smoke.wkv7_fwd_times`` at the shapes of the paths that run it.

    python3 scripts/wkv7_fwd_occupancy.py
"""
import shutil
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402
from rwkvtts_torch import _build  # noqa: E402

PAD = 16384
SMEM = "return FWD_FLOATS * (int)sizeof(float) + 2 * NIN * L * N * (int)sizeof(T);"
SM_BYTES, CTA_RESERVED = 233472, 1024


def padded_csrc() -> Path:
    """A copy of the sources whose forward asks for PAD more shared memory."""
    dst = _build.BUILD_DIR / "one_cta"
    shutil.rmtree(dst, ignore_errors=True)
    shutil.copytree(_build.CSRC, dst, ignore=shutil.ignore_patterns("build"))
    src = (dst / "wkv7_fwd.cu").read_text()
    if SMEM not in src:
        raise RuntimeError("wkv7_fwd_occupancy: the forward's shared memory size not found")
    (dst / "wkv7_fwd.cu").write_text(src.replace(SMEM, SMEM[:-1] + f" + {PAD};"))
    return dst


def use(csrc: Path) -> None:
    """Make the next launch use the library built from `csrc`."""
    _build.CSRC, _build.BUILD_DIR = csrc, csrc / "build"
    _build.library.cache_clear()


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("wkv7_fwd_occupancy: needs an NVIDIA GPU")
    from rwkvtts_torch.ops import wkv7_cuda

    print(chip_smoke.subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip())
    built, padded = _build.CSRC, padded_csrc()
    dev = torch.device("cuda", 0)
    g = torch.Generator(device=dev).manual_seed(5)
    ins, state, resets = chip_smoke.wkv_inputs(g, 64, 128, 16, torch.bfloat16)
    outs = {}
    for name, csrc in (("as built", built), ("one CTA an SM", padded)):
        use(csrc)
        smem = _build.library().wkv7_fwd_smem_bytes(1)
        ctas = SM_BYTES // (smem + CTA_RESERVED)
        print(f"{name}: {smem} bytes of shared memory a CTA in bf16, room for {ctas} an SM")
        chip_smoke.check(ctas == (2 if csrc == built else 1), "the builds' occupancy")
        outs[name] = wkv7_cuda._fwd(*ins, state, resets, save=True)
    same = all(torch.equal(a, b) for a, b in zip(*outs.values()))
    print(f"both builds, (64, 128, 16) bf16 saving: y, final state and anchors "
          f"bit-identical: {same}")
    chip_smoke.check(same, "the padded build gives other bits")
    for name, csrc in (("as built", built), ("one CTA an SM", padded),
                       ("one CTA an SM", padded), ("as built", built)):
        use(csrc)
        chip_smoke.wkv7_fwd_times(name)


if __name__ == "__main__":
    main()
