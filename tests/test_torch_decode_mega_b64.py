"""Parity of the port's B=64 decode step (rwkvtts_torch/ops/decode_mega_b64.py)
with the JAX package's (rwkvtts_tpu/ops/decode_mega_b64.py).

The JAX side runs its TPU kernel in interpret mode on the CPU; the port
runs its plain version (the CPU path of the wrapper). Same weights through
the bridge, same inputs from a numpy seed."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rwkvtts_tpu.models import rwkv7
from rwkvtts_tpu.ops import decode_mega_b64 as dmb
from rwkvtts_tpu.ops.decode_mega import _q8_np
from rwkvtts_torch import bridge
from rwkvtts_torch.models import rwkv7 as trwkv7
from rwkvtts_torch.ops import decode_mega_b64 as tdmb

torch.set_num_threads(2)


def _cfgs(C=256, L=2):
    jcfg = rwkv7.RWKV7Config(vocab_size=32, hidden_size=C, num_layers=L,
                             head_size=64, gate_lora=64, dtype=jnp.float32,
                             wkv_chunk=4, remat=False)
    tcfg = trwkv7.RWKV7Config(vocab_size=32, hidden_size=C, num_layers=L,
                              head_size=64, gate_lora=64, dtype=torch.float32)
    return jcfg, tcfg


def _randomized_params(cfg, seed=0):
    """As tests/test_decode_mega_b64.py: loras, output and FFN value made
    nonzero so every term of the step is exercised."""
    params = jax.jit(rwkv7.init_params, static_argnums=1)(jax.random.PRNGKey(seed), cfg)
    k = jax.random.PRNGKey(seed + 1)
    att = dict(params["blocks"]["att"])
    for name in ("w1", "a1", "v1", "g1", "output"):
        k, sub = jax.random.split(k)
        att[name] = 0.1 * jax.random.normal(sub, att[name].shape)
    ffn = dict(params["blocks"]["ffn"])
    k, sub = jax.random.split(k)
    ffn["value"] = 0.1 * jax.random.normal(sub, ffn["value"].shape)
    params["blocks"] = dict(params["blocks"], att=att, ffn=ffn)
    return jax.tree.map(np.asarray, params)


def _rel(a, b):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return float(np.abs(a - b).max() / (np.abs(b).max() + 1e-12))


def test_pack_int8_matches_q8_np():
    jcfg, tcfg = _cfgs()
    params = _randomized_params(jcfg, seed=2)
    mega = tdmb.pack_mega_b64(bridge.params_from_numpy(params), tcfg)
    att, ffn = params["blocks"]["att"], params["blocks"]["ffn"]
    C = tcfg.hidden_size
    as_np = lambda t: t.numpy()
    bf16 = lambda s: np.asarray(jnp.asarray(s, jnp.bfloat16).astype(jnp.float32))
    for l in range(tcfg.num_layers):
        checks = [
            ("rkv", att["receptance"][l], slice(0, C)),
            ("rkv", att["key"][l], slice(C, 2 * C)),
            ("rkv", att["value"][l], slice(2 * C, 3 * C)),
            ("out", att["output"][l], slice(0, C)),
            ("fk", ffn["key"][l], slice(0, 4 * C)),
            ("fv", ffn["value"][l], slice(0, C)),
        ]
        for gi, n in enumerate("vwag"):
            d = att[f"{n}1"].shape[-1]
            checks.append(("li", att[f"{n}1"][l], slice(gi * 128, gi * 128 + d)))
        for name, mat, cols in checks:
            q, s = _q8_np(mat)
            np.testing.assert_array_equal(as_np(mega[f"{name}_q"][l][:, cols]), q)
            np.testing.assert_array_equal(as_np(mega[f"{name}_s"][l][cols]),
                                          bf16(s).reshape(-1))
        for gi, n in enumerate("vwag"):
            q, s = _q8_np(att[f"{n}2"][l])
            rows = slice(gi * 128, gi * 128 + q.shape[0])
            np.testing.assert_array_equal(as_np(mega["lo_q"][l][rows]), q)
            np.testing.assert_array_equal(as_np(mega["lo_s"][l, gi]), s.reshape(-1))
    # lora padding is zero
    assert not mega["li_q"][:, :, 64 + 32:128].any()


def test_quantize_int8_matches_jax():
    """rwkv7._quantize_int8: q bit-identical, bf16 scales equal."""
    w = np.random.default_rng(4).standard_normal((2, 96, 160)).astype(np.float32)
    w[0, :, 3] = 0.0  # an all-zero column takes the 1e-8 floor
    want = rwkv7._quantize_int8(jnp.asarray(w))
    got = trwkv7._quantize_int8(torch.from_numpy(w))
    np.testing.assert_array_equal(got["q"].numpy(), np.asarray(want["q"]))
    assert got["s"].dtype == torch.bfloat16
    np.testing.assert_array_equal(got["s"].float().numpy(),
                                  np.asarray(want["s"].astype(jnp.float32)))


def test_state_layout_roundtrip():
    rng = np.random.default_rng(0)
    L, H = 2, 4
    wkv = rng.standard_normal((L, 64, H, 64, 64)).astype(np.float32)
    mega = bridge.wkv_to_mega(wkv)
    np.testing.assert_array_equal(bridge.wkv_from_mega(mega, H), wkv)
    # agrees with the JAX package's own packer, whole state in both directions
    jcfg, _ = _cfgs(C=H * 64, L=L)
    st = {"att_x": rng.standard_normal((L, 64, H * 64)).astype(np.float32), "wkv": wkv,
          "ffn_x": rng.standard_normal((L, 64, H * 64)).astype(np.float32)}
    jm = dmb.pack_mega_state_b64(jax.tree.map(jnp.asarray, st), jcfg)
    jm = {k: np.asarray(v.astype(jnp.float32)) for k, v in jm.items()}
    np.testing.assert_array_equal(jm["wkv"], np.asarray(
        jnp.asarray(mega, jnp.bfloat16).astype(jnp.float32)))
    port = bridge.state_from_mega(jm, H)
    assert all(t.dtype == torch.bfloat16 and t.is_contiguous() for t in port.values())
    assert port["wkv"].shape == (L, 64, H, 64, 64)
    back = bridge.state_to_mega(port)
    for k in st:
        np.testing.assert_array_equal(back[k], jm[k], err_msg=k)


def test_decode_step_plain_matches_jax_megakernel():
    """3 chained steps, C=256, L=2, B=64: hidden and state within 1e-2 of
    the JAX kernel (interpret mode). Both keep the same bf16 rounding
    points; what remains is f32 summation order and 1-ulp bf16 flips."""
    jcfg, tcfg = _cfgs()
    params = _randomized_params(jcfg)
    jmega = dmb.pack_mega_b64(jax.tree.map(jnp.asarray, params), jcfg, tile_n=256)
    spec = jmega.pop("spec")
    tmega = tdmb.pack_mega_b64(bridge.params_from_numpy(params), tcfg)

    rng = np.random.default_rng(7)
    L, C, H = jcfg.num_layers, jcfg.hidden_size, jcfg.num_heads
    st0 = {
        "att_x": 0.5 * rng.standard_normal((L, 64, C)),
        "wkv": 0.1 * rng.standard_normal((L, 64, H, 64, 64)),
        "ffn_x": 0.5 * rng.standard_normal((L, 64, C)),
    }
    st0 = {k: np.asarray(jnp.asarray(v, jnp.bfloat16).astype(jnp.float32))
           for k, v in st0.items()}
    jst = dmb.pack_mega_state_b64(jax.tree.map(jnp.asarray, st0), jcfg)
    tst = bridge.state_from_mega(jax.tree.map(np.asarray, jst), H)
    step = jax.jit(lambda m, x, s: dmb.decode_step_mega_b64(
        m, jcfg, x, s, interpret=True, spec=spec))
    for i in range(3):
        x = rng.standard_normal((64, C)).astype(np.float32)
        hj, jst = step(jmega, jnp.asarray(x), jst)
        ht, tst = tdmb.decode_step_mega_b64(tmega, tcfg, torch.from_numpy(x), tst)
        assert _rel(ht.numpy(), hj) < 1e-2, (i, _rel(ht.numpy(), hj))
    back = dmb.unpack_mega_state_b64(jst, jcfg, dtype=jnp.float32)
    for leaf in ("att_x", "ffn_x", "wkv"):
        got = bridge.to_numpy(tst[leaf])
        assert _rel(got, np.asarray(back[leaf])) < 1e-2, leaf


def test_decode_step_state_is_updated_in_place():
    _, tcfg = _cfgs(C=128, L=2)
    g = torch.Generator().manual_seed(0)
    params = trwkv7.init_params(g, tcfg)
    mega = tdmb.pack_mega_b64(params, tcfg)
    st = tdmb.pack_state(trwkv7.init_model_state(tcfg, 64))
    ptrs = {k: v.data_ptr() for k, v in st.items()}
    x = torch.randn(64, 128, generator=g)
    h, st2 = tdmb.decode_step_mega_b64(mega, tcfg, x, st)
    assert h.shape == (64, 128) and h.dtype == torch.float32
    assert torch.isfinite(h).all()
    assert {k: v.data_ptr() for k, v in st2.items()} == ptrs
    assert st["att_x"].abs().sum() > 0 and st["ffn_x"].abs().sum() > 0


@pytest.mark.parametrize("bad", ["x_shape", "device"])
def test_decode_wrapper_refuses_what_it_cannot_run(bad):
    _, tcfg = _cfgs(C=128, L=1)
    params = trwkv7.init_params(torch.Generator().manual_seed(0), tcfg)
    mega = tdmb.pack_mega_b64(params, tcfg)
    st = tdmb.pack_state(trwkv7.init_model_state(tcfg, 64))
    if bad == "device":
        # not a CPU tensor and not a CUDA one: no silent plain fallback
        x = torch.empty(64, 128, device="meta")
        with pytest.raises(ValueError, match="no implementation"):
            tdmb.decode_step_mega_b64(mega, tcfg, x, st)
    else:
        with pytest.raises(ValueError, match="x is"):
            tdmb._launch(mega, tcfg, torch.zeros(32, 128), st)


@pytest.mark.parametrize("C", [1024, 2048])
def test_launch_plan_fits_the_card(C):
    """The launch plan the wrapper hands the kernel: every product cut into
    128-column tiles and K pieces of a multiple of 64 rows, at most 1024 (the
    lhs slice that stays in shared memory), at most 8 pieces (one cluster);
    each CTA within the 227 KB of shared memory a block may use; the
    workspace as the kernel carves it."""
    plan = tdmb.launch_plan(C)
    shapes = {"rkv_li": (C, 3 * C + 512), "lo": (128, 4 * C), "out": (C, C),
              "fk": (C, 4 * C), "fv": (4 * C, C)}
    assert list(plan["products"]) == list(tdmb.PRODUCTS) == list(shapes)
    for name, pr in plan["products"].items():
        K, N = shapes[name]
        assert (pr["K"], pr["N"]) == (K, N), name
        assert pr["tiles"] == N // 128 and N % 128 == 0, name
        assert pr["pieces"] in (1, 2, 4, 8) and pr["k_piece"] * pr["pieces"] == K, name
        assert pr["k_piece"] % 64 == 0 and pr["k_piece"] <= 1024, name
        assert pr["ctas"] == pr["tiles"] * pr["pieces"], name
        lhs = 64 * pr["k_piece"] * 2
        assert lhs <= 128 * 1024 and lhs < pr["smem_bytes"] <= 232448, name
    # the products fill the card without a second wave where K allows it
    assert plan["products"]["rkv_li"]["ctas"] >= 100
    assert all(p["ctas"] >= 64 for p in plan["products"].values())
    rows = 64
    want = sum((n + 255) // 256 * 256 for n in (
        rows * C * 4, 6 * rows * C * 2, rows * 3 * C * 2, rows * 512 * 2,
        4 * rows * C * 4, rows * C * 2, rows * C * 2, rows * 4 * C * 2))
    assert plan["workspace_bytes"] == want


def test_launch_plan_refuses_what_the_kernel_cannot_cut():
    with pytest.raises(ValueError, match="multiple of 128"):
        tdmb.launch_plan(1000)
    with pytest.raises(ValueError, match="does not cut"):
        tdmb.launch_plan(4096)  # FFN value K = 16384: pieces of 2048 rows


def test_pack_check_runs_once_and_refuses_a_malformed_pack(monkeypatch):
    """The wrapper checks a pack's tensors on its first step: a second step
    does not check again, a new pack or a replaced entry is checked, a
    malformed pack is refused (and not remembered), and a dict that is not
    a MegaPack is refused."""
    _, tcfg = _cfgs(C=128, L=1)
    params = trwkv7.init_params(torch.Generator().manual_seed(0), tcfg)
    mega = tdmb.pack_mega_b64(params, tcfg)
    calls = []
    real = tdmb._check_tensors
    monkeypatch.setattr(tdmb, "_check_tensors", lambda *a: (calls.append(1), real(*a)))
    dev = torch.device("cpu")
    for _ in range(3):
        tdmb._check_pack(mega, 1, 128, dev)
    assert len(calls) == 1
    bad = tdmb.pack_mega_b64(params, tcfg)
    bad["fk_q"] = bad["fk_q"][..., :-128].contiguous()
    with pytest.raises(ValueError, match=r"mega\['fk_q'\]"):
        tdmb._check_pack(bad, 1, 128, dev)
    with pytest.raises(ValueError, match=r"mega\['fk_q'\]"):
        tdmb._check_pack(bad, 1, 128, dev)  # a refused pack is not remembered
    assert len(calls) == 3
    # replacing an entry of a checked pack makes the next step check it
    mega["fv_q"] = mega["fv_q"][:, :-128].contiguous()
    with pytest.raises(ValueError, match=r"mega\['fv_q'\]"):
        tdmb._check_pack(mega, 1, 128, dev)
    assert len(calls) == 4
    # a plain dict is refused before any check
    with pytest.raises(ValueError, match="MegaPack"):
        tdmb._check_pack(dict(bad), 1, 128, dev)
    assert len(calls) == 4
