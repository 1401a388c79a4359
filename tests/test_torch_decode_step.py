"""Parity of the port's model decode step (rwkvtts_torch/models/rwkv7.py:
pack_decode_params, pack_decode_state / unpack_decode_state,
layer_decode_views, decode_step) with the JAX package's
(rwkvtts_tpu/models/rwkv7.py) on identical weights: fused and unfused
projections, int8 on and off, the in-place (packed) step and the fresh
buffer, f32 and bf16 WKV carry, four chained steps. Weights and inputs
from a numpy seed; the JAX side takes the packed step's XLA reference on
the CPU, the port its plain step."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rwkvtts_tpu.models import rwkv7 as jrwkv7
from rwkvtts_torch import bridge
from rwkvtts_torch.models import rwkv7 as trwkv7

torch.set_num_threads(2)

C, L, HS, BATCH = 64, 2, 16, 3


def _cfgs(model_dtype="f32", packed=False, state_bf16=False):
    jdt = jnp.float32 if model_dtype == "f32" else jnp.bfloat16
    tdt = torch.float32 if model_dtype == "f32" else torch.bfloat16
    kw = dict(vocab_size=32, hidden_size=C, num_layers=L, head_size=HS, gate_lora=16,
              decode_wkv_packed=packed, decode_state_bf16=state_bf16)
    return (jrwkv7.RWKV7Config(dtype=jdt, wkv_chunk=4, remat=False, **kw),
            trwkv7.RWKV7Config(dtype=tdt, **kw))


@pytest.fixture(scope="module")
def weights():
    """Numpy parameters of the JAX tree (the port's init draws the JAX
    package's tree and distributions), loras, output and FFN value nonzero
    so every term of the step is exercised."""
    _, tcfg = _cfgs()
    params = bridge.params_to_numpy(trwkv7.init_params(torch.Generator().manual_seed(0), tcfg))
    rng = np.random.default_rng(1)
    att, ffn = params["blocks"]["att"], params["blocks"]["ffn"]
    for tree, name in [(att, n) for n in ("w1", "a1", "v1", "g1", "output")] + [(ffn, "value")]:
        tree[name] = (0.3 * rng.standard_normal(tree[name].shape)).astype(np.float32)
    return params


def _inputs(seed):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    state = {"att_x": f(L, BATCH, C), "wkv": 0.3 * f(L, BATCH, C // HS, HS, HS),
             "ffn_x": f(L, BATCH, C)}
    return state, [f(BATCH, C) for _ in range(4)]


def _rel(a, b):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return float(np.abs(a - b).max() / np.abs(b).max())


def _cast(tree, model_dtype, jax_side):
    """The launcher's rule: parameters with two or more dims in the model
    dtype (bf16), the rest kept."""
    if model_dtype == "f32":
        return tree if not jax_side else jax.tree.map(jnp.asarray, tree)
    if jax_side:
        return jax.tree.map(lambda x: jnp.asarray(x, jnp.bfloat16) if x.ndim >= 2
                            else jnp.asarray(x), tree)
    return trwkv7.tree_map(lambda t: t.to(torch.bfloat16) if t.dim() >= 2 else t, tree)


# (fused projections, int8, packed (in place), bf16 carry, model dtype)
CASES = [
    (True, False, True, False, "f32"),    # the launcher's default
    (True, True, True, True, "f32"),
    (False, False, False, True, "f32"),
    (False, True, False, False, "f32"),
    (True, False, False, False, "f32"),
    (False, False, True, False, "f32"),
    (True, False, True, False, "bf16"),   # the launcher's default in bf16
]


@pytest.mark.parametrize("fused,int8,packed,state_bf16,model_dtype", CASES)
def test_decode_step_matches_jax(weights, fused, int8, packed, state_bf16, model_dtype):
    jcfg, tcfg = _cfgs(model_dtype, packed, state_bf16)
    state, xs = _inputs(seed=7)
    jp = jrwkv7.layer_decode_views(jrwkv7.pack_decode_params(
        _cast(weights, model_dtype, True), jcfg, quantize_int8=int8,
        fuse_projections=fused), jcfg)
    tp = trwkv7.layer_decode_views(trwkv7.pack_decode_params(
        _cast(bridge.params_from_numpy(weights), model_dtype, False), tcfg,
        quantize_int8=int8, fuse_projections=fused), tcfg)
    jdt = jcfg.dtype
    jstate = jrwkv7.pack_decode_state(
        {k: jnp.asarray(v, jnp.float32 if k == "wkv" else jdt) for k, v in state.items()}, jcfg)
    tstate = trwkv7.pack_decode_state(
        {k: torch.from_numpy(v).to(torch.float32 if k == "wkv" else tcfg.dtype)
         for k, v in state.items()}, tcfg)
    assert isinstance(tstate, tuple) and len(tstate) == L
    wkv_ptrs = [st["wkv"].data_ptr() for st in tstate]
    jstep = jax.jit(lambda p, x, s: jrwkv7.decode_step(p, jcfg, x, s))
    tol = 1e-4 if model_dtype == "f32" else 2e-2
    for x in xs:
        jh, jstate = jstep(jp, jnp.asarray(x), jstate)
        th, tstate = trwkv7.decode_step(tp, tcfg, torch.from_numpy(x), tstate)
        assert th.dtype == tcfg.dtype
        assert _rel(bridge.to_numpy(th), np.asarray(jh.astype(jnp.float32))) <= tol
    # in place under decode_wkv_packed: every layer's state keeps its buffer
    assert ([st["wkv"].data_ptr() for st in tstate] == wkv_ptrs) == packed
    assert tstate[0]["wkv"].dtype == (torch.bfloat16 if state_bf16 else torch.float32)
    jfin = jrwkv7.unpack_decode_state(jstate, jcfg)
    tfin = trwkv7.unpack_decode_state(tstate, tcfg)
    for k in ("att_x", "wkv", "ffn_x"):
        # a leaf stored in bf16 is held to bf16's tolerance: the two sides
        # round nearly equal f32 updates, and one can land a bf16 ulp away
        leaf_tol = 2e-2 if tfin[k].dtype == torch.bfloat16 else tol
        assert _rel(bridge.to_numpy(tfin[k]), np.asarray(jfin[k].astype(jnp.float32))) <= leaf_tol, k


def test_decode_step_stacked_form_matches_layered(weights):
    """Stacked params and state (the JAX scan form) give the layered
    result, and leave the given state untouched."""
    _, tcfg = _cfgs(packed=True)
    state, xs = _inputs(seed=8)
    tp = trwkv7.pack_decode_params(bridge.params_from_numpy(weights), tcfg)
    stacked = {k: torch.from_numpy(v) for k, v in state.items()}
    h_s, st_s = trwkv7.decode_step(tp, tcfg, torch.from_numpy(xs[0]), stacked)
    np.testing.assert_array_equal(stacked["wkv"].numpy(), state["wkv"])
    h_l, st_l = trwkv7.decode_step(trwkv7.layer_decode_views(tp, tcfg), tcfg,
                                   torch.from_numpy(xs[0]),
                                   trwkv7.pack_decode_state(stacked, tcfg))
    torch.testing.assert_close(h_s, h_l, rtol=0, atol=0)
    for k, v in trwkv7.unpack_decode_state(st_l, tcfg).items():
        torch.testing.assert_close(st_s[k], v, rtol=0, atol=0)


@pytest.mark.parametrize("fused", [True, False])
def test_pack_decode_params_int8_equals_jax(weights, fused):
    jcfg, tcfg = _cfgs(model_dtype="bf16")
    jp = jrwkv7.pack_decode_params(_cast(weights, "bf16", True), jcfg, quantize_int8=True,
                                   fuse_projections=fused)
    tp = trwkv7.pack_decode_params(_cast(bridge.params_from_numpy(weights), "bf16", False),
                                   tcfg, quantize_int8=True, fuse_projections=fused)
    names = ([("att", "fused_a_q8"), ("att", "fused_b_q8"), ("att", "output_q8")] if fused
             else [("att", f"{n}_q8") for n in ("receptance", "key", "value", "output")])
    names += [("ffn", "key_q8"), ("ffn", "value_q8")]
    for group, name in names:
        jq, tq = jp["blocks"][group][name], tp["blocks"][group][name]
        assert tq["q"].dtype == torch.int8
        np.testing.assert_array_equal(tq["q"].numpy(), np.asarray(jq["q"]), err_msg=name)
        np.testing.assert_array_equal(bridge.to_numpy(tq["s"]),
                                      np.asarray(jq["s"].astype(jnp.float32)), err_msg=name)
    assert set(tp["blocks"]["att"]) == set(jp["blocks"]["att"])
    assert set(tp["blocks"]["ffn"]) == set(jp["blocks"]["ffn"])


def test_decode_state_pack_roundtrip():
    _, tcfg = _cfgs(packed=True)
    state, _ = _inputs(seed=9)
    stacked = {k: torch.from_numpy(v) for k, v in state.items()}
    packed = trwkv7.pack_decode_state(stacked, tcfg)
    assert trwkv7.pack_decode_state(packed, tcfg) is packed
    assert all(st[k].is_contiguous() for st in packed for k in st)
    packed[0]["wkv"].add_(1.0)  # its own buffer: the stacked state is not touched
    np.testing.assert_array_equal(stacked["wkv"].numpy(), state["wkv"])
    packed[0]["wkv"].sub_(1.0)
    for k, v in trwkv7.unpack_decode_state(packed, tcfg).items():
        np.testing.assert_allclose(v.numpy(), state[k], rtol=0, atol=1e-6)
    _, bcfg = _cfgs(state_bf16=True)
    back = trwkv7.unpack_decode_state(trwkv7.pack_decode_state(stacked, bcfg), bcfg)
    assert back["wkv"].dtype == torch.bfloat16
    torch.testing.assert_close(back["wkv"], stacked["wkv"].to(torch.bfloat16), rtol=0, atol=0)
