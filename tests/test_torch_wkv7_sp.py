"""Sequence parallelism in the port on the CPU against the JAX package: the
plain two-level WKV7 ``ops/wkv7.wkv7_chunked_sp`` against JAX's
``wkv7_chunked_sp`` (tests/test_wkv7_sp.py's cases: spans and T with
padding, resets across span boundaries, the entry state, bf16 in and out,
gradients against jax.grad), the route the model takes (``wkv7_spans``: two
runs of the whole-sequence ``wkv7`` a span, then the compose) against it,
and the dp=2 x sp=2 train step with wkv_spans 4 over four gloo ranks
against JAX's single-device step."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rwkvtts_tpu.ops import wkv7 as jw
from rwkvtts_torch.ops import wkv7 as tw

from test_torch_parallel import check_against_jax, jax_step, run_mesh, spark_setup

torch.set_num_threads(2)

_jsp = jax.jit(jw.wkv7_chunked_sp, static_argnames=("chunk", "spans"))


def _inputs(seed, B=2, T=48, H=3, N=8):
    """r, w_raw, k, v, z, b (B, T, H, N) and a state, f32 numpy, drawn as
    tests/test_wkv7.py's make_inputs draws them (w_raw <= -0.5, z = -kk,
    b = kk a with kk unit rows)."""
    rng = np.random.default_rng(seed)
    shp = (B, T, H, N)
    f = lambda x: np.asarray(x, np.float32)
    r, k, v = (f(rng.standard_normal(shp) * 0.4) for _ in range(3))
    w_raw = f(-0.5 - np.log1p(np.exp(rng.standard_normal(shp))))
    kk = rng.standard_normal(shp)
    kk /= np.linalg.norm(kk, axis=-1, keepdims=True) + 1e-12
    a = 1 / (1 + np.exp(-rng.standard_normal(shp)))
    state = f(rng.standard_normal((B, H, N, N)) * 0.3)
    return r, w_raw, k, v, f(-kk), f(kk * a), state


def _close(got, want, tol):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert np.abs(got - want).max() <= tol * (np.abs(want).max() + 1e-12), \
        np.abs(got - want).max()


@pytest.mark.parametrize("spans", [1, 2, 4])
@pytest.mark.parametrize("T", [64, 48, 37])
def test_plain_sp_matches_jax(spans, T):
    """y and the final state of the port's plain wkv7_chunked_sp (chunk 16,
    the entry state given, T padded to chunk x spans) and of the route
    through the plain wkv7 against JAX's wkv7_chunked_sp, within 1e-5 of
    the largest value."""
    args = _inputs(0, T=T)
    y_j, s_j = _jsp(*map(jnp.asarray, args), chunk=16, spans=spans)
    targs = [torch.from_numpy(a) for a in args]
    for y, s in (tw.wkv7_chunked_sp(*targs, chunk=16, spans=spans),
                 tw.wkv7_spans(*targs, spans=spans)):
        _close(y.numpy(), y_j, 1e-5)
        _close(s.numpy(), s_j, 1e-5)


def test_resets_entry_state_and_bf16():
    """Resets inside spans and exactly at a span boundary, with an entry
    state, on both port forms against JAX; bf16 inputs give a bf16 y and an
    f32 state, within bf16's rounding of JAX's; the dispatch ``wkv7(...,
    spans=)`` is the route."""
    B, T = 2, 64
    args = _inputs(2, B=B, T=T)
    resets = np.zeros((B, T), bool)
    resets[0, 13] = resets[0, 32] = resets[1, 50] = True
    y_j, s_j = _jsp(*map(jnp.asarray, args), jnp.asarray(resets), chunk=8, spans=4)
    targs = [torch.from_numpy(a) for a in args] + [torch.from_numpy(resets)]
    for y, s in (tw.wkv7_chunked_sp(*targs, chunk=8, spans=4), tw.wkv7_spans(*targs, spans=4),
                 tw.wkv7(*targs[:6], state=targs[6], resets=targs[7], spans=4)):
        _close(y.numpy(), y_j, 1e-5)
        _close(s.numpy(), s_j, 1e-5)
    bf = lambda a: jnp.asarray(a).astype(jnp.bfloat16)
    y_j, s_j = _jsp(*map(bf, args[:6]), jnp.asarray(args[6]), chunk=16, spans=4)
    tb = [torch.from_numpy(a).bfloat16() for a in args[:6]] + [torch.from_numpy(args[6])]
    for y, s in (tw.wkv7_chunked_sp(*tb, chunk=16, spans=4), tw.wkv7_spans(*tb, spans=4)):
        assert y.dtype == torch.bfloat16 and s.dtype == torch.float32
        _close(y.float().numpy(), np.asarray(y_j, np.float32), 1e-2)
        _close(s.numpy(), s_j, 1e-5)


def test_gradients_match_jax_grad():
    """The gradients of (y^2).sum() + 0.1 (s^2).sum() w.r.t. r, w_raw, k,
    v, z, b and the state through both port forms (autograd) against
    jax.grad of JAX's wkv7_chunked_sp, with resets, within 1e-4 of each
    gradient's largest."""
    B, T = 1, 32
    args = _inputs(4, B=B, T=T, H=2)
    resets = np.zeros((B, T), bool)
    resets[0, 8] = True

    def jloss(a):
        y, s = jw.wkv7_chunked_sp(*a, jnp.asarray(resets), chunk=8, spans=4)
        return (y ** 2).sum() + (s ** 2).sum() * 0.1

    g_j = jax.jit(jax.grad(jloss))(tuple(map(jnp.asarray, args)))
    for fn in (lambda *a: tw.wkv7_chunked_sp(*a, chunk=8, spans=4),
               lambda *a: tw.wkv7_spans(*a, spans=4)):
        leaves = [torch.from_numpy(a).requires_grad_() for a in args]
        y, s = fn(*leaves, torch.from_numpy(resets))
        g_t = torch.autograd.grad((y ** 2).sum() + (s ** 2).sum() * 0.1, leaves)
        for name, gt, gj in zip("r w_raw k v z b state".split(), g_t, g_j):
            _close(gt.numpy(), gj, 1e-4)


def test_dp_sp_step_matches_jax(tmp_path):
    """dp=2 x sp=2 over 4 gloo ranks with wkv_spans 4 (each rank 2 spans of
    16 steps, the token shift's halo and the next label from the next rank)
    on tests/test_parallel.py's sp batch, resets inside a span and at a span
    boundary: loss, grad norm, post-step parameters and moments against
    JAX's single-device step."""
    jcfg, tcfg, params, batch = spark_setup(spans=4, chunk=8)
    jm, jparams, jstates = jax_step(jcfg, params, batch)
    res = run_mesh(tmp_path, {"dp": 2, "sp": 2}, tcfg, params, batch)
    check_against_jax(res, jm, jparams, jstates[-1])
