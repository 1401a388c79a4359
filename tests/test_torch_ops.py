"""Parity of the port's ops (rwkvtts_torch/ops) with the JAX package's, on
the CPU: norms, the WKV7 forward (plain port vs the JAX scan and the JAX
Pallas kernel in interpret mode) and the sampler; plus the port's import
isolation from JAX and its refusal to fall back silently."""
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rwkvtts_tpu.ops import norm as jnorm
from rwkvtts_tpu.ops import sampling as jsampling
from rwkvtts_tpu.ops import wkv7 as jwkv7
from rwkvtts_tpu.ops.wkv7_pallas import wkv7_pallas
from rwkvtts_torch import _build
from rwkvtts_torch.ops import norm as tnorm
from rwkvtts_torch.ops import sampling as tsampling
from rwkvtts_torch.ops import wkv7 as twkv7
from rwkvtts_torch.ops import wkv7_cuda

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _rel(a, b):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return float(np.abs(a - b).max() / (np.abs(b).max() + 1e-12))


def test_norms_match_jax():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((3, 5, 256)).astype(np.float32) * 3 + 1
    s = rng.standard_normal(256).astype(np.float32)
    b = rng.standard_normal(256).astype(np.float32)
    t = torch.from_numpy
    pairs = [
        (tnorm.layer_norm(t(x), t(s), t(b), 1e-5), jnorm.layer_norm(x, s, b, 1e-5)),
        (tnorm.group_norm(t(x), t(s), t(b), 4, 64e-5),
         jnorm.group_norm(x, s, b, 4, 64e-5)),
        (tnorm.l2_normalize(t(x)), jnorm.l2_normalize(x)),
    ]
    for got, want in pairs:
        assert _rel(got.numpy(), want) <= 1e-6
    # exactly-zero rows stay finite (eps^2 clamped before the sqrt)
    z = np.zeros((2, 64), np.float32)
    assert np.array_equal(tnorm.l2_normalize(t(z)).numpy(), z)


def _wkv_inputs(seed, B=2, T=70, H=4, N=64):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    r, k, v = f(B, T, H, N), 0.3 * f(B, T, H, N), f(B, T, H, N)
    w_raw = -0.5 - np.abs(f(B, T, H, N))          # model range: w_raw <= -0.5
    kk = f(B, T, H, N)
    kk /= np.linalg.norm(kk, axis=-1, keepdims=True)
    a = 1 / (1 + np.exp(-f(B, T, H, N)))
    state = 0.1 * f(B, H, N, N)
    resets = rng.random((B, T)) < 0.05
    resets[0, T // 2] = True
    return (r, w_raw, k, v, -kk, kk * a), state, resets


@pytest.mark.parametrize("with_state", [False, True])
def test_wkv7_forward_matches_jax(with_state):
    """Plain port (the CPU path of the kernel wrapper) vs the JAX scan and
    the JAX Pallas forward kernel (interpret mode): f32, B=2, T=70, H=4;
    y and final state within 1e-4 of max |ref|."""
    ins, state, resets = _wkv_inputs(1)
    st = state if with_state else None
    rs = resets if with_state else None
    y_t, s_t = twkv7.wkv7(*(torch.from_numpy(x) for x in ins),
                          state=None if st is None else torch.from_numpy(st),
                          resets=None if rs is None else torch.from_numpy(rs))
    j = lambda x: None if x is None else jnp.asarray(x)
    y_s, s_s = jwkv7.wkv7_scan(*(j(x) for x in ins), j(st), j(rs))
    y_p, s_p = wkv7_pallas(*(j(x) for x in ins), j(st), j(rs), chunk=64,
                           interpret=True)
    for y_ref, s_ref in ((y_s, s_s), (y_p, s_p)):
        assert _rel(y_t.numpy(), y_ref) <= 1e-4
        assert _rel(s_t.numpy(), s_ref) <= 1e-4


def test_wkv7_step_matches_jax():
    ins, state, _ = _wkv_inputs(2, T=1)
    step_in = [x[:, 0] for x in ins]
    y_t, s_t = twkv7.wkv7_step(torch.from_numpy(state),
                               *(torch.from_numpy(x) for x in step_in))
    y_j, s_j = jwkv7.wkv7_step(jnp.asarray(state), *(jnp.asarray(x) for x in step_in))
    assert _rel(y_t.numpy(), y_j) <= 1e-5
    assert _rel(s_t.numpy(), s_j) <= 1e-5


def _no_tie_logits(rng, B, V):
    # a random permutation of distinct, well-separated values per row
    base = np.linspace(-6.0, 6.0, V, dtype=np.float32)
    return np.stack([rng.permutation(base) for _ in range(B)])


@pytest.mark.parametrize("temperature,top_k,top_p", [
    (1.0, 50, 0.95), (0.7, 50, 0.95), (1.0, 1, 0.95), (1.0, 1, 1.0), (1.0, 0, 0.9),
])
def test_sampler_matches_jax_given_the_same_noise(temperature, top_k, top_p):
    rng = np.random.default_rng(3)
    B, V = 64, 8193
    logits = _no_tie_logits(rng, B, V)
    key = jax.random.PRNGKey(11)
    want = np.asarray(jsampling.sample(key, jnp.asarray(logits), temperature=temperature,
                                       top_k=top_k, top_p=top_p))
    fused = 0 < top_k < V and top_p < 1.0
    noise = jax.random.gumbel(key, (B, top_k if fused else V), jnp.float32)
    got = tsampling.sample(torch.from_numpy(logits), temperature=temperature,
                           top_k=top_k, top_p=top_p,
                           noise=torch.from_numpy(np.array(noise)))
    np.testing.assert_array_equal(got.numpy(), want)


def test_sampler_draws_from_a_generator():
    logits = torch.from_numpy(_no_tie_logits(np.random.default_rng(0), 8, 100))
    g = lambda: torch.Generator().manual_seed(5)
    a = tsampling.sample(logits, top_k=50, top_p=0.95, generator=g())
    b = tsampling.sample(logits, top_k=50, top_p=0.95, generator=g())
    assert torch.equal(a, b)
    # every draw is among each row's 50 largest logits
    top = torch.topk(logits, 50).indices
    assert (top == a[:, None]).any(-1).all()
    with pytest.raises(ValueError, match="noise"):
        tsampling.sample(logits, top_k=50, top_p=0.95)


def test_port_imports_no_jax():
    """Every rwkvtts_torch module imports with jax blocked on sys.meta_path."""
    code = r"""
import importlib, pkgutil, sys

class Block:
    def find_spec(self, name, path=None, target=None):
        if name == "jax" or name.startswith(("jax.", "jaxlib", "rwkvtts_tpu")):
            raise ImportError("blocked: " + name)

sys.meta_path.insert(0, Block())
import rwkvtts_torch
names = [m.name for m in pkgutil.walk_packages(rwkvtts_torch.__path__, "rwkvtts_torch.")]
for n in names:
    importlib.import_module(n)
assert not any(m == "jax" or m.startswith("jax.") for m in sys.modules)
print(len(names))
"""
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 25  # the train slice's modules included


def test_kernel_wrappers_do_not_fall_back(monkeypatch, tmp_path):
    """A tensor that is neither on the CPU nor on a CUDA device is refused,
    not computed by the plain version; and with no CUDA compiler the kernel
    build raises instead of degrading."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the kernels can build here")
    ins = [torch.empty(1, 4, 1, 64, device="meta") for _ in range(6)]
    prm = [torch.empty(1, 64, device="meta") for _ in range(5)]
    for call in (lambda: wkv7_cuda.wkv7_fwd(*ins), lambda: wkv7_cuda.wkv7(*ins),
                 lambda: wkv7_cuda.wkv7_fused(*ins[:5], *prm)):
        with pytest.raises(ValueError, match="no implementation"):
            call()
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(_build, "library_path", lambda: tmp_path / "absent.so")
    _build.library.cache_clear()
    seq = [torch.zeros(1, 4, 1, 64) for _ in range(6)]
    params = [torch.zeros(1, 64) for _ in range(5)]
    try:
        with pytest.raises(RuntimeError, match="nvcc not found"):
            _build.library()
        for save in (False, True):
            with pytest.raises(RuntimeError, match="nvcc not found"):
                wkv7_cuda._fwd(*seq, None, None, save=save)
            with pytest.raises(RuntimeError, match="nvcc not found"):
                wkv7_cuda._fused_fwd(*seq[:5], params, None, None, 64e-5, save=save)
    finally:
        _build.library.cache_clear()
    assert all(n == 0 for n in wkv7_cuda.launches.values())
