"""Parity of the port's differentiable WKV7 ops with the JAX package, on the
CPU: ``wkv7_cuda.wkv7`` (whose CPU path is autograd through the plain
``wkv7_scan``) against ``jax.grad`` through JAX ``wkv7_scan``, and the plain
fused-prep version ``wkv7_fused_plain`` against ``wkv7_pallas_fused``
(interpret mode) and ``jax.grad`` of the composed band it replaces. The
CUDA kernels themselves are held to these plain versions on the card by
chip_smoke.py (phases 7-8)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rwkvtts_tpu.ops import wkv7 as jwkv7
from rwkvtts_tpu.ops.wkv7_pallas import wkv7_pallas_fused
from rwkvtts_torch.ops import wkv7 as twkv7
from rwkvtts_torch.ops import wkv7_cuda

torch.set_num_threads(2)

LN_EPS = 64e-5


def _rel(a, b):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return float(np.abs(a - b).max() / (np.abs(b).max() + 1e-12))


def _wkv_inputs(seed, B=2, T=70, H=2, N=64):
    """The model's ranges: w_raw <= -0.5 (the CUDA backward's contract),
    z = -kk and b = kk a with kk unit-norm."""
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    r, k, v = f(B, T, H, N), 0.3 * f(B, T, H, N), f(B, T, H, N)
    w_raw = -0.5 - np.abs(f(B, T, H, N))
    kk = f(B, T, H, N)
    kk /= np.linalg.norm(kk, axis=-1, keepdims=True)
    a = 1 / (1 + np.exp(-f(B, T, H, N)))
    state = 0.1 * f(B, H, N, N)
    resets = rng.random((B, T)) < 0.05
    resets[0, 16] = resets[1, 37] = True
    dy, ds = f(B, T, H, N), 0.1 * f(B, H, N, N)
    return [r, w_raw, k, v, -kk, kk * a], state, resets, dy, ds


def _torch_grads(fn, ins, state, resets, dy, ds):
    """Outputs and gradients (inputs, then the state if given) of
    sum(y dy) + sum(s_fin ds) through `fn` under torch autograd."""
    t = [torch.tensor(x, requires_grad=True) for x in ins]
    st = None if state is None else torch.tensor(state, requires_grad=True)
    y, s = fn(*t, st, None if resets is None else torch.from_numpy(resets))
    loss = (y * torch.from_numpy(dy)).sum() + (s * torch.from_numpy(ds)).sum()
    grads = torch.autograd.grad(loss, t + ([] if st is None else [st]))
    return y.detach().numpy(), s.detach().numpy(), [g.numpy() for g in grads]


def _jax_grads(fn, ins, state, resets, dy, ds):
    def loss(args):
        *xs, st = args
        y, s = fn(*xs, st, None if resets is None else jnp.asarray(resets))
        return (y * dy).sum() + (s * ds).sum(), (y, s)

    args = [jnp.asarray(x) for x in ins] + [
        jnp.zeros(ds.shape, jnp.float32) if state is None else jnp.asarray(state)]
    (_, (y, s)), g = jax.value_and_grad(loss, has_aux=True)(args)
    g = g if state is not None else g[:-1]
    return np.asarray(y), np.asarray(s), [np.asarray(x) for x in g]


@pytest.mark.parametrize("with_state,with_resets", [
    (False, False), (True, False), (False, True), (True, True)])
def test_wkv7_grads_match_jax_scan(with_state, with_resets):
    """f32, B=2, T=70, H=2, head 64: y, the final state and every gradient
    (r, w_raw, k, v, z, b and the initial state) within 1e-4 of max |ref|."""
    ins, state, resets, dy, ds = _wkv_inputs(1)
    st = state if with_state else None
    rs = resets if with_resets else None
    y_t, s_t, g_t = _torch_grads(wkv7_cuda.wkv7, ins, st, rs, dy, ds)
    y_j, s_j, g_j = _jax_grads(jwkv7.wkv7_scan, ins, st, rs, dy, ds)
    assert _rel(y_t, y_j) <= 1e-4 and _rel(s_t, s_j) <= 1e-4
    assert len(g_t) == len(g_j) == (7 if with_state else 6)
    for name, a, b in zip(["r", "w_raw", "k", "v", "z", "b", "state"], g_t, g_j):
        assert _rel(a, b) <= 1e-4, name


def _fused_inputs(seed, B=2, T=48, H=2, N=64):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    softplus = lambda x: np.log1p(np.exp(x))
    seq = [0.4 * f(B, T, H, N), -0.5 - softplus(f(B, T, H, N)), 0.4 * f(B, T, H, N),
           0.4 * f(B, T, H, N), 1 / (1 + np.exp(-f(B, T, H, N)))]
    prm = [0.7 + 0.1 * f(H, N), 1.0 + 0.05 * f(H, N), -0.04 + 0.1 * f(H, N),
           1.0 + 0.1 * f(H, N), 0.05 * f(H, N)]
    state = (0.3 * f(B, H, N, N)).astype(np.float32)
    resets = np.zeros((B, T), bool)
    resets[0, 13] = resets[1, 5] = resets[1, 32] = True
    dy, ds = f(B, T, H, N), 0.1 * f(B, H, N, N)
    return [x.astype(np.float32) for x in seq + prm], state, resets, dy, ds


def _jax_composed(r, w_raw, k_raw, v, a, k_k, k_a, r_k, ln_w, ln_b, state, resets):
    """The band wkv7_pallas_fused replaces, composed from the JAX package's
    plain ops (all f32)."""
    kx = k_raw * k_k
    s = (kx * kx).sum(-1, keepdims=True)
    kk = kx / jnp.sqrt(jnp.maximum(s, 1e-24))
    keff = k_raw * (1.0 + (a - 1.0) * k_a)
    y, sf = jwkv7.wkv7_scan(r, w_raw, keff, v, -kk, kk * a, state, resets)
    mu = y.mean(-1, keepdims=True)
    var = ((y - mu) ** 2).mean(-1, keepdims=True)
    yn = (y - mu) / jnp.sqrt(var + LN_EPS) * ln_w + ln_b
    return yn + (r * keff * r_k).sum(-1, keepdims=True) * v, sf


def _fused_plain(*args):
    return twkv7.wkv7_fused_plain(*args, ln_eps=LN_EPS)


@pytest.mark.parametrize("T,with_resets", [(48, False), (37, True)])
def test_fused_plain_matches_pallas_fused(T, with_resets):
    """The plain fused forward vs the JAX fused Pallas kernel (interpret
    mode): f32, head 64, state given; y and final state within 1e-4."""
    ins, state, resets, _, _ = _fused_inputs(2, T=T)
    rs = resets[:, :T] if with_resets else None
    y_t, s_t = _fused_plain(*(torch.from_numpy(x) for x in ins), torch.from_numpy(state),
                            None if rs is None else torch.from_numpy(rs))
    y_p, s_p = wkv7_pallas_fused(*(jnp.asarray(x) for x in ins), jnp.asarray(state),
                                 None if rs is None else jnp.asarray(rs), ln_eps=LN_EPS,
                                 chunk=16, group=2, interpret=True)
    assert _rel(y_t.numpy(), y_p) <= 1e-4
    assert _rel(s_t.numpy(), s_p) <= 1e-4


@pytest.mark.parametrize("with_state,with_resets", [(False, False), (True, True)])
def test_fused_grads_match_jax_composed(with_state, with_resets):
    """Every gradient of the plain fused version (r, w_raw, k_raw, v, a, the
    five per-head parameters, the state) vs jax.grad of the composed band:
    f32, head 64, within 1e-4 of max |ref|."""
    ins, state, resets, dy, ds = _fused_inputs(3)
    st = state if with_state else None
    rs = resets if with_resets else None
    y_t, s_t, g_t = _torch_grads(_fused_plain, ins, st, rs, dy, ds)
    y_j, s_j, g_j = _jax_grads(_jax_composed, ins, st, rs, dy, ds)
    assert _rel(y_t, y_j) <= 1e-4 and _rel(s_t, s_j) <= 1e-4
    names = "r w_raw k_raw v a k_k k_a r_k ln_w ln_b state".split()
    assert len(g_t) == len(g_j) == (11 if with_state else 10)
    for name, a, b in zip(names, g_t, g_j):
        assert a.shape == b.shape, name
        assert _rel(a, b) <= 1e-4, name


def test_wrappers_take_the_plain_versions_on_the_cpu():
    """On CPU tensors wkv7 / wkv7_fused are the plain versions (bitwise),
    with the kernels' output contract: y in v's dtype, the state in f32."""
    ins, state, resets, _, _ = _fused_inputs(4, T=40)
    t = [torch.from_numpy(x) for x in ins]
    st, rs = torch.from_numpy(state), torch.from_numpy(resets)
    y_w, s_w = wkv7_cuda.wkv7_fused(*t, st, rs, LN_EPS)
    y_p, s_p = _fused_plain(*t, st, rs)
    assert torch.equal(y_w, y_p) and torch.equal(s_w, s_p)
    bf = [x.to(torch.bfloat16) for x in t[:5]] + t[5:]
    y_b, s_b = wkv7_cuda.wkv7_fused(*bf, st, rs, LN_EPS)
    assert y_b.dtype == torch.bfloat16 and s_b.dtype == torch.float32
    wins, wst, wrs, _, _ = _wkv_inputs(5, T=40)
    wt = [torch.from_numpy(x).to(torch.bfloat16).requires_grad_() for x in wins]
    y, s = wkv7_cuda.wkv7(*wt, torch.from_numpy(wst), torch.from_numpy(wrs))
    assert y.dtype == torch.bfloat16 and s.dtype == torch.float32
    grads = torch.autograd.grad(y.float().sum() + s.sum(), wt)
    assert all(g.dtype == torch.bfloat16 for g in grads)


def test_wkv7_grads_match_jax_scan_at_the_fastest_decay():
    """Every w_raw at -0.5, the fastest decay the model's clamp allows (the
    worst case for the CUDA backward's stepping back): wkv7 on the CPU
    (autograd through wkv7_scan) vs jax.grad through JAX wkv7_scan, f32,
    state and resets, every output and gradient within 1e-4."""
    ins, state, resets, dy, ds = _wkv_inputs(6)
    ins[1] = np.full_like(ins[1], -0.5)
    y_t, s_t, g_t = _torch_grads(wkv7_cuda.wkv7, ins, state, resets, dy, ds)
    y_j, s_j, g_j = _jax_grads(jwkv7.wkv7_scan, ins, state, resets, dy, ds)
    assert _rel(y_t, y_j) <= 1e-4 and _rel(s_t, s_j) <= 1e-4
    assert len(g_t) == len(g_j) == 7
    for name, a, b in zip(["r", "w_raw", "k", "v", "z", "b", "state"], g_t, g_j):
        assert _rel(a, b) <= 1e-4, name


def test_fused_grads_match_jax_composed_at_the_fastest_decay():
    """wkv7_fused_plain at w_raw = -0.5 everywhere vs jax.grad of the
    composed band: f32, state and resets, within 1e-4."""
    ins, state, resets, dy, ds = _fused_inputs(7)
    ins[1] = np.full_like(ins[1], -0.5)
    y_t, s_t, g_t = _torch_grads(_fused_plain, ins, state, resets, dy, ds)
    y_j, s_j, g_j = _jax_grads(_jax_composed, ins, state, resets, dy, ds)
    assert _rel(y_t, y_j) <= 1e-4 and _rel(s_t, s_j) <= 1e-4
    names = "r w_raw k_raw v a k_k k_a r_k ln_w ln_b state".split()
    assert len(g_t) == len(g_j) == 11
    for name, a, b in zip(names, g_t, g_j):
        assert _rel(a, b) <= 1e-4, name


def _chunk_header_constants():
    """The integer constants of csrc/wkv7_chunk.cuh, evaluated in order."""
    import re
    from pathlib import Path

    src = (Path(wkv7_cuda.__file__).resolve().parents[1] / "csrc" / "wkv7_chunk.cuh").read_text()
    env = {"N": 64}
    for name, expr in re.findall(r"constexpr int (\w+) = ([^;]+);", src):
        env[name] = eval(expr.replace("wkv7::CHUNK", str(wkv7_cuda.CHUNK)), {}, dict(env))
    return env


@pytest.mark.parametrize("T", [1, 200, 2048])
def test_fused_plan_fits_the_card(T):
    """The fused kernels' launch arithmetic at the training shape's B and H:
    one CTA of 256 threads a (b, h), ceil(T / 16) chunks, shared memory
    within the card's 227 KB a CTA and equal to what the kernel source's
    constants give."""
    plan = wkv7_cuda.fused_plan(8, T, 16)
    c = _chunk_header_constants()
    assert plan["grid"] == 8 * 16 and plan["threads"] == c["NT"] == 256
    assert plan["chunk"] == c["L"] == 16 and plan["n_chunks"] == -(-T // 16)
    assert plan["fwd_smem_bytes"] == 4 * c["FWD_FLOATS"]
    assert plan["bwd_smem_bytes"] == 4 * c["BWD_FLOATS"]
    assert max(plan["fwd_smem_bytes"], plan["bwd_smem_bytes"]) <= 232448


@pytest.mark.parametrize("B,T,H", [(8, 0, 16), (0, 200, 16), (8, 200, 0), (2**16, 1, 2**16)])
def test_fused_plan_refuses_what_the_kernels_cannot_take(B, T, H):
    with pytest.raises(ValueError):
        wkv7_cuda.fused_plan(B, T, H)


@pytest.mark.parametrize("T", [1, 200, 2048])
@pytest.mark.parametrize("dtype,esize", [(torch.bfloat16, 2), (torch.float32, 4)])
def test_bwd_plan_fits_the_card(T, dtype, esize):
    """The chunked backward's launch arithmetic (csrc/wkv7_bwd.cu) at the
    training shape's B and H: one CTA of 256 threads a (b, h), ceil(T / 16)
    chunks, shared memory within the card's 227 KB and equal to what the
    kernel source's constants give (the f32 tiles, then the step inputs of
    two chunks in the input dtype)."""
    plan = wkv7_cuda.bwd_plan(8, T, 16, dtype)
    c = _chunk_header_constants()
    assert plan["grid"] == 8 * 16 and plan["threads"] == c["NT"] == 256
    assert plan["chunk"] == c["L"] == 16 and plan["n_chunks"] == -(-T // 16)
    staged = 2 * c["UNFUSED_BWD_INPUTS"] * c["L"] * c["N"] * esize
    assert plan["smem_bytes"] == 4 * c["UNFUSED_BWD_FLOATS"] + staged <= 232448


@pytest.mark.parametrize("B,T,H", [(8, 0, 16), (0, 200, 16), (8, 200, 0), (2**16, 1, 2**16)])
def test_bwd_plan_refuses_what_the_kernel_cannot_take(B, T, H):
    with pytest.raises(ValueError):
        wkv7_cuda.bwd_plan(B, T, H)


@pytest.mark.parametrize("T", [1, 16, 70])
def test_training_forward_saves_only_the_anchors(T):
    """The training forward saves the state after every 16th step and after
    the last, which is all the chunked backward reads: nothing a step (the
    per-step sa of the step-back backward is gone)."""
    saved = wkv7_cuda._saved_states(2, T, 3, torch.empty(0))
    assert isinstance(saved, torch.Tensor)
    assert saved.shape == (2, 3, -(-T // 16), 64, 64) and saved.dtype == torch.float32
