"""The WKV7 forward kernel's launch plan (csrc/wkv7_fwd.cu):
``wkv7_cuda.fwd_plan`` against the kernel source's constants at the shapes
of the paths that run it, and its refusals. The algebra the kernel follows
is checked against the TPU kernel in test_torch_wkv7_chunked.py, and the
kernel itself against ``wkv7_scan`` on the card by chip_smoke.py (phase
3)."""
import pytest
import torch
from test_torch_wkv7_train import _chunk_header_constants

from rwkvtts_torch.ops import wkv7_cuda

# the paths' shapes (B, T, H): the generation prefill (1024 CTAs), the Cosy
# prefill, one admission bucket of the server and the unfused training
# forward
SHAPES = [(64, 128, 16), (1, 320, 32), (8, 128, 16), (8, 2048, 16)]


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("dtype,esize", [(torch.bfloat16, 2), (torch.float32, 4)])
def test_fwd_plan_matches_the_kernel_source(shape, dtype, esize):
    """Grid, threads, chunks and shared memory bytes: the fused forward's f32
    tiles and the 6 step inputs of two chunks in the input dtype, within the
    card's 227 KB; two CTAs an SM in bf16."""
    B, T, H = shape
    plan = wkv7_cuda.fwd_plan(B, T, H, dtype)
    c = _chunk_header_constants()
    assert plan["grid"] == B * H and plan["threads"] == c["NT"] == 256
    assert plan["chunk"] == c["L"] == 16 and plan["n_chunks"] == -(-T // 16)
    staged = 2 * c["UNFUSED_FWD_INPUTS"] * c["L"] * c["N"] * esize
    assert plan["smem_bytes"] == 4 * c["FWD_FLOATS"] + staged <= 232448
    if dtype == torch.bfloat16:
        assert 2 * (plan["smem_bytes"] + 1024) <= 233472  # the SM's 228 KB, 1 KB a CTA reserved


@pytest.mark.parametrize("B,T,H", [(8, 0, 16), (0, 200, 16), (8, 200, 0), (2**16, 1, 2**16)])
def test_fwd_plan_refuses_what_the_kernel_cannot_take(B, T, H):
    with pytest.raises(ValueError):
        wkv7_cuda.fwd_plan(B, T, H)
