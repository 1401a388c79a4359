"""Parity of the port's WKV7 decode step (rwkvtts_torch/ops/wkv7_step_packed.py,
the plain version its CUDA kernel is held to on the card) with the JAX
package's packed step (rwkvtts_tpu/ops/wkv7_step_pallas.py): the TPU kernel
in interpret mode and its XLA reference, on the head-pair-packed layout,
which the bridge converts to and from the port's natural (B, H, N, N).
Inputs from a numpy seed."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rwkvtts_tpu.ops import wkv7_step_pallas as jsp
from rwkvtts_torch import bridge
from rwkvtts_torch.ops import wkv7 as twkv7
from rwkvtts_torch.ops import wkv7_step_packed as tsp

torch.set_num_threads(2)

B, H = 3, 4


def _inputs(N, seed=0):
    """State (B, H, N, N) and r, w_raw, k, v, z, b (B, H, N), f32, in the
    model's ranges (w_raw <= -0.5)."""
    rng = np.random.default_rng(seed)
    f = lambda *shape: rng.standard_normal(shape).astype(np.float32)
    state = 0.3 * f(B, H, N, N)
    vecs = [f(B, H, N), -0.5 - np.abs(f(B, H, N)), 0.3 * f(B, H, N), f(B, H, N),
            0.3 * f(B, H, N), 0.3 * f(B, H, N)]
    return state, vecs


def _rel(a, b):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return float(np.abs(a - b).max() / np.abs(b).max())


def _bf16_ulp(x):
    """One bf16 unit in the last place at |x| (normal range)."""
    ax = np.maximum(np.abs(np.asarray(x, np.float32)), np.float32(2.0 ** -126))
    return np.exp2(np.floor(np.log2(ax)) - 7)


@pytest.mark.parametrize("carry,N", [("f32", 16), ("bf16", 16), ("f32", 64), ("bf16", 64)])
def test_step_matches_tpu_kernel_and_ref(carry, N):
    state, vecs = _inputs(N, seed=N)
    jdt = jnp.float32 if carry == "f32" else jnp.bfloat16
    tdt = torch.float32 if carry == "f32" else torch.bfloat16
    jstate = jnp.asarray(bridge.wkv_to_packed(state)).astype(jdt)
    jvecs = [jnp.asarray(v) for v in vecs]
    y_i, s_i = jsp.wkv7_step_packed(jstate, *jvecs, interpret=True)
    y_r, s_r = jsp.wkv7_step_packed_ref(jstate, *jvecs)

    # the port starts from the same carry values (bf16-rounded for bf16)
    tstate = torch.from_numpy(state).to(tdt)
    ptr = tstate.data_ptr()
    y_t, s_t = tsp.wkv7_step_packed(tstate, *(torch.from_numpy(v) for v in vecs))
    assert s_t.data_ptr() == ptr and s_t.dtype == tdt  # in place, carry dtype kept

    s_t = bridge.to_numpy(s_t)
    for y_j, s_j in ((y_i, s_i), (y_r, s_r)):
        s_j = bridge.wkv_from_packed(np.asarray(s_j.astype(jnp.float32)), B, H)
        assert _rel(y_t, y_j) <= 1e-5
        if carry == "f32":
            assert _rel(s_t, s_j) <= 1e-5
        else:
            # both round the f32 update to bf16: equal, or one bf16 ulp
            # apart, beyond the f32 tolerance (which matters only where the
            # update cancels to far below the state's scale)
            f32_tol = 1e-5 * np.abs(s_j).max()
            assert np.all(np.abs(s_t - s_j) <= _bf16_ulp(s_j) + f32_tol)
            assert np.mean(s_t == s_j) > 0.99


def test_step_dispatch_fresh_buffer_and_in_place():
    state, vecs = _inputs(16, seed=1)
    s0 = torch.from_numpy(state)
    tv = [torch.from_numpy(v) for v in vecs]
    y_a, s_a = twkv7.wkv7_step(s0, *tv)  # default: a fresh buffer
    assert s_a.data_ptr() != s0.data_ptr()
    np.testing.assert_array_equal(s0.numpy(), state)  # input untouched
    s1 = s0.clone()
    y_b, s_b = twkv7.wkv7_step(s1, *tv, inplace=True)
    assert s_b.data_ptr() == s1.data_ptr()
    torch.testing.assert_close(y_a, y_b, rtol=0, atol=0)
    torch.testing.assert_close(s_a, s_b, rtol=0, atol=0)
    # y comes back in v's dtype, the state in the carry's
    y_c, s_c = twkv7.wkv7_step(s0.to(torch.bfloat16), *(t.to(torch.bfloat16) for t in tv))
    assert y_c.dtype == torch.bfloat16 and s_c.dtype == torch.bfloat16


@pytest.mark.parametrize("lead,Bn,Hn,N", [((), 3, 4, 16), ((2,), 1, 16, 64), ((2, 3), 2, 2, 8)])
def test_packed_converters_match_pack_state(lead, Bn, Hn, N):
    s = np.random.default_rng(2).standard_normal((*lead, Bn, Hn, N, N)).astype(np.float32)
    packed = bridge.wkv_to_packed(s)
    np.testing.assert_array_equal(packed, np.asarray(jsp.pack_state(jnp.asarray(s))))
    np.testing.assert_array_equal(bridge.wkv_from_packed(packed, Bn, Hn), s)
    np.testing.assert_array_equal(
        bridge.wkv_from_packed(packed, Bn, Hn),
        np.asarray(jsp.unpack_state(jnp.asarray(packed), Bn, Hn)))
