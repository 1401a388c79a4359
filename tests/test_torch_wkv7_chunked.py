"""Parity of the port's chunked WKV7 algebra (``ops/wkv7.py::wkv7_chunked``,
the statement the chunked CUDA kernels of csrc/wkv7_{fwd,bwd,fused}.cu
follow) with the JAX package on the CPU: y and the final state against JAX
``wkv7_chunked`` and ``wkv7_scan``, and every gradient through torch
autograd against ``jax.grad`` of both; in the kernels' 16-step chunks also
against the TPU forward kernel (``wkv7_pallas``, interpret mode), with every
w_raw at -0.5 too; f32, within 1e-4 of max |ref|."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rwkvtts_tpu.ops import wkv7 as jwkv7
from rwkvtts_tpu.ops.wkv7_pallas import wkv7_pallas
from rwkvtts_torch.ops import wkv7 as twkv7

torch.set_num_threads(2)

B, H, N = 2, 2, 64
NAMES = ["r", "w_raw", "k", "v", "z", "b", "state"]


def _rel(a, b):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return float(np.abs(a - b).max() / (np.abs(b).max() + 1e-12))


@functools.lru_cache(maxsize=None)
def _inputs(T, with_state, with_resets, minus_half=False):
    """The model's ranges (w_raw <= -0.5, z = -kk, b = kk a with kk
    unit-norm), or every w_raw at -0.5 (the fastest decay the model's clamp
    allows); resets at a 16-step chunk boundary, mid-chunk and at two
    adjacent positions."""
    rng = np.random.default_rng(T)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    r, k, v = f(B, T, H, N), 0.3 * f(B, T, H, N), f(B, T, H, N)
    w_raw = -0.5 - np.abs(f(B, T, H, N))
    if minus_half:
        w_raw = np.full_like(w_raw, -0.5)
    kk = f(B, T, H, N)
    kk /= np.linalg.norm(kk, axis=-1, keepdims=True)
    a = 1 / (1 + np.exp(-f(B, T, H, N)))
    state = 0.1 * f(B, H, N, N) if with_state else None
    resets = None
    if with_resets:
        resets = np.zeros((B, T), bool)
        resets[0, 16] = resets[0, 5] = resets[1, 29] = resets[1, 30] = True
    dy, ds = f(B, T, H, N), 0.1 * f(B, H, N, N)
    return [r, w_raw, k, v, -kk, kk * a], state, resets, dy, ds


@functools.lru_cache(maxsize=None)
def _jax_ref(name, T, with_state, with_resets, chunk):
    """y, the final state and the gradients of sum(y dy) + sum(s ds)
    through the JAX function `name`."""
    ins, state, resets, dy, ds = _inputs(T, with_state, with_resets)
    fn = (functools.partial(jwkv7.wkv7_chunked, chunk=chunk) if name == "chunked"
          else jwkv7.wkv7_scan)

    def loss(args):
        *xs, st = args
        y, s = fn(*xs, st if with_state else None,
                  None if resets is None else jnp.asarray(resets))
        return (y * dy).sum() + (s * ds).sum(), (y, s)

    args = [jnp.asarray(x) for x in ins] + [
        jnp.asarray(state) if with_state else jnp.zeros((B, H, N, N), jnp.float32)]
    (_, (y, s)), g = jax.jit(jax.value_and_grad(loss, has_aux=True))(args)
    g = g if with_state else g[:-1]
    return np.asarray(y), np.asarray(s), [np.asarray(x) for x in g]


@pytest.mark.parametrize("T", [37, 48, 70])
@pytest.mark.parametrize("chunk", [16, 64])
@pytest.mark.parametrize("with_state,with_resets", [(False, False), (True, True)])
def test_wkv7_chunked_matches_jax(T, chunk, with_state, with_resets):
    ins, state, resets, dy, ds = _inputs(T, with_state, with_resets)
    t = [torch.tensor(x, requires_grad=True) for x in ins]
    st = torch.tensor(state, requires_grad=True) if with_state else None
    y, s = twkv7.wkv7_chunked(*t, st, None if resets is None else torch.from_numpy(resets),
                              chunk=chunk)
    loss = (y * torch.from_numpy(dy)).sum() + (s * torch.from_numpy(ds)).sum()
    grads = torch.autograd.grad(loss, t + ([st] if with_state else []))
    assert y.shape == (B, T, H, N) and s.shape == (B, H, N, N)
    for ref in ("chunked", "scan"):
        y_j, s_j, g_j = _jax_ref(ref, T, with_state, with_resets,
                                 chunk if ref == "chunked" else 0)
        assert _rel(y.detach(), y_j) <= 1e-4, ref
        assert _rel(s.detach(), s_j) <= 1e-4, ref
        assert len(grads) == len(g_j) == (7 if with_state else 6)
        for name, a, b in zip(NAMES, grads, g_j):
            assert _rel(a, b) <= 1e-4, (ref, name)


@pytest.mark.parametrize("minus_half", [False, True])
def test_wkv7_chunked_matches_the_tpu_kernel(minus_half):
    """In the kernels' 16-step chunks (a partial last chunk, resets inside
    and at a boundary, an initial state): y and the final state against the
    TPU forward kernel in interpret mode and the JAX scan."""
    ins, state, resets, _, _ = _inputs(70, True, True, minus_half)
    y_t, s_t = twkv7.wkv7_chunked(*(torch.from_numpy(x) for x in ins), torch.from_numpy(state),
                                  torch.from_numpy(resets), chunk=16)
    j = [jnp.asarray(x) for x in ins] + [jnp.asarray(state), jnp.asarray(resets)]
    for y_ref, s_ref in (jwkv7.wkv7_scan(*j), wkv7_pallas(*j, chunk=16, interpret=True)):
        assert _rel(y_t, y_ref) <= 1e-4
        assert _rel(s_t, s_ref) <= 1e-4


def test_wkv7_chunked_matches_the_plain_scan_in_bf16_inputs():
    """bf16 inputs: the chunked form and wkv7_scan agree in the output
    dtype contract (y in v's dtype, the state in f32) and within bf16's
    rounding of y."""
    ins, state, resets, _, _ = _inputs(48, True, True)
    t = [torch.from_numpy(x).to(torch.bfloat16) for x in ins]
    st, rs = torch.from_numpy(state), torch.from_numpy(resets)
    y_c, s_c = twkv7.wkv7_chunked(*t, st, rs, chunk=16)
    y_s, s_s = twkv7.wkv7_scan(*t, st, rs)
    assert y_c.dtype == torch.bfloat16 and s_c.dtype == torch.float32
    assert _rel(y_c.float(), y_s.float()) <= 1e-2
    assert _rel(s_c, s_s) <= 1e-4
