"""Parity of the port's B=1 decode step (rwkvtts_torch/ops/decode_mega.py)
with the JAX package's (rwkvtts_tpu/ops/decode_mega.py).

The JAX side runs its TPU kernel in interpret mode on the CPU; the port
runs its plain version (the CPU path of the wrapper). Same weights through
the bridge, same inputs from a numpy seed."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rwkvtts_tpu.models import cosy as jcosy
from rwkvtts_tpu.models import rwkv7
from rwkvtts_tpu.ops import decode_mega as jdm
from rwkvtts_torch import _build, bridge
from rwkvtts_torch.models import cosy as tcosy
from rwkvtts_torch.models import rwkv7 as trwkv7
from rwkvtts_torch.ops import decode_mega as tdm

torch.set_num_threads(2)

C, L = 128, 2


def _cfgs():
    jcfg = rwkv7.RWKV7Config(vocab_size=32, hidden_size=C, num_layers=L, head_size=64,
                             gate_lora=64, dtype=jnp.float32, wkv_chunk=4, remat=False)
    tcfg = trwkv7.RWKV7Config(vocab_size=32, hidden_size=C, num_layers=L, head_size=64,
                              gate_lora=64, dtype=torch.float32)
    return jcfg, tcfg


def _randomized_params(tcfg, seed=0):
    """Numpy parameters of the JAX tree (drawn by the port's init, which
    has the JAX package's tree and distributions), with the loras,
    output and FFN value made nonzero as tests/test_decode_mega.py does, so
    every term of the step is exercised."""
    params = bridge.params_to_numpy(trwkv7.init_params(torch.Generator().manual_seed(seed), tcfg))
    rng = np.random.default_rng(seed + 1)
    att, ffn = params["blocks"]["att"], params["blocks"]["ffn"]
    for tree, name in [(att, n) for n in ("w1", "a1", "v1", "g1", "output")] + [(ffn, "value")]:
        tree[name] = (0.1 * rng.standard_normal(tree[name].shape)).astype(np.float32)
    return params


def _rel(a, b):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return float(np.abs(a - b).max() / (np.abs(b).max() + 1e-12))


def _state(rng):
    """A random model state at B=1: shift states and WKV state."""
    H = C // 64
    return {"att_x": rng.standard_normal((L, 1, C)).astype(np.float32),
            "wkv": (0.3 * rng.standard_normal((L, 1, H, 64, 64))).astype(np.float32),
            "ffn_x": rng.standard_normal((L, 1, C)).astype(np.float32)}


@pytest.fixture(scope="module")
def weights():
    jcfg, tcfg = _cfgs()
    params = _randomized_params(tcfg, seed=3)
    jmega = jdm.pack_mega(jax.tree.map(jnp.asarray, params), jcfg, tile_n=128)
    return jcfg, tcfg, params, jmega, tdm.pack_mega(bridge.params_from_numpy(params), tcfg)


def test_pack_matches_q8_np_and_lora_out(weights):
    jcfg, tcfg, params, jmega, mega = weights
    att, ffn = params["blocks"]["att"], params["blocks"]["ffn"]
    bf16 = lambda s: np.asarray(jnp.asarray(s, jnp.bfloat16).astype(jnp.float32))
    for l in range(L):
        checks = [("rkv", att["receptance"][l], slice(0, C)),
                  ("rkv", att["key"][l], slice(C, 2 * C)),
                  ("rkv", att["value"][l], slice(2 * C, 3 * C)),
                  ("out", att["output"][l], slice(0, C)),
                  ("fk", ffn["key"][l], slice(0, 4 * C)),
                  ("fv", ffn["value"][l], slice(0, C))]
        checks += [("li", att[f"{n}1"][l], slice(gi * 128, gi * 128 + att[f"{n}1"].shape[-1]))
                   for gi, n in enumerate("vwag")]
        for name, mat, cols in checks:
            q, s = jdm._q8_np(mat)
            np.testing.assert_array_equal(mega[f"{name}_q"][l][:, cols].numpy(), q)
            np.testing.assert_array_equal(mega[f"{name}_s"][l][cols].numpy(), bf16(s).reshape(-1))
    # lora-in padding columns are zero, the lora-out rows are the JAX
    # package's bf16 lora_out bit for bit (zero rows on the padding)
    for gi, n in enumerate("vwag"):
        d = att[f"{n}1"].shape[-1]
        assert not mega["li_q"][:, :, gi * 128 + d:(gi + 1) * 128].any()
    assert mega["lo"].dtype == torch.bfloat16
    np.testing.assert_array_equal(mega["lo"].float().numpy(),
                                  np.asarray(jmega["lora_out"].astype(jnp.float32)))


def test_state_pack_round_trip():
    jcfg, tcfg = _cfgs()
    rng = np.random.default_rng(1)
    st = _state(rng)
    H = C // 64
    # the port's pack / unpack: dtypes explicit, f32 a round trip
    tst = bridge.params_from_numpy(st)
    packed = tdm.pack_state(tst, torch.float32)
    assert packed["att_x"].dtype == packed["ffn_x"].dtype == torch.float32
    back = tdm.unpack_state(packed, torch.float32)
    for k in st:
        np.testing.assert_array_equal(back[k].numpy(), st[k], err_msg=k)
    assert tdm.pack_state(tst, torch.bfloat16)["wkv"].dtype == torch.bfloat16
    # head-pair layout: both ways, and against the JAX package's own packer
    pairs = bridge.wkv_to_head_pairs(st["wkv"])
    np.testing.assert_array_equal(bridge.wkv_from_head_pairs(pairs, H), st["wkv"])
    jm = jdm.pack_mega_state(jax.tree.map(jnp.asarray, st), jcfg, state_bf16=False)
    np.testing.assert_array_equal(np.asarray(jm["wkv"]), pairs)
    port = bridge.state_from_mega_b1(jax.tree.map(np.asarray, jm), H)
    for k in st:
        np.testing.assert_array_equal(port[k].numpy(), st[k], err_msg=k)
    back = bridge.state_to_mega_b1(port)
    for k in st:
        np.testing.assert_array_equal(back[k], np.asarray(jm[k]), err_msg=k)


def _lora_out_as_the_kernel_reads(jmega):
    """The TPU kernel's wkv_glue reads its lora-out block as groups (w, a,
    v, g) of 128 rows (decode_mega.py:430-446), while pack_mega writes them
    in the _LH order (v, w, a, g) (decode_mega.py:236-239): with nonzero
    loras the kernel's step is not its model's (rwkv7.decode_step). The
    port follows the model (test_step_is_the_models_step); to hold it to
    the kernel's arithmetic, the kernel gets its groups where it reads them."""
    lo = jmega["lora_out"]
    v, w, a, g = (lo[:, i * 128:(i + 1) * 128] for i in range(4))
    return {**{k: x for k, x in jmega.items() if k != "spec"},
            "lora_out": jnp.concatenate([w, a, v, g], 1)}


@pytest.mark.parametrize("carry,tol", [("f32", 1e-4), ("bf16", 1e-2)])
def test_step_matches_jax_interpret(weights, carry, tol):
    """Two chained steps from a random state: hidden and every state leaf
    within `tol` of the TPU kernel in interpret mode (f32 config, so the
    products' lhs is f32 on both sides)."""
    jcfg, tcfg, params, jmega, mega = weights
    spec = jmega["spec"]
    jarrays = _lora_out_as_the_kernel_reads(jmega)
    rng = np.random.default_rng(7)
    st = _state(rng)
    jst = jdm.pack_mega_state(jax.tree.map(jnp.asarray, st), jcfg, state_bf16=carry == "bf16")
    tst = bridge.state_from_mega_b1(jax.tree.map(np.asarray, jst), C // 64)
    assert tst["wkv"].dtype == (torch.bfloat16 if carry == "bf16" else torch.float32)
    for i in range(2):
        x = rng.standard_normal((1, C)).astype(np.float32)
        h_j, jst = jdm.decode_step_mega(jarrays, jcfg, jnp.asarray(x), jst, interpret=True,
                                        spec=spec)
        h_t, tst = tdm.decode_step_mega(mega, tcfg, torch.from_numpy(x), tst)
        assert _rel(h_t.numpy(), h_j) <= tol, (i, _rel(h_t.numpy(), h_j))
    got = bridge.state_to_mega_b1(tst)
    for leaf in ("att_x", "ffn_x", "wkv"):
        want = np.asarray(jst[leaf].astype(jnp.float32))
        assert _rel(got[leaf], want) <= tol, (leaf, _rel(got[leaf], want))


def test_step_is_the_models_step(weights):
    """The port's step is the model's: JAX's rwkv7.decode_step (the XLA
    step) on the weights the port quantized (int8 x scale, bf16 lora-out),
    f32 config, two steps from a random state, within 1e-4."""
    jcfg, tcfg, params, jmega, mega = weights
    deq = lambda name, l: (mega[f"{name}_q"][l].float() * mega[f"{name}_s"][l]).numpy()
    att = dict(params["blocks"]["att"])
    ffn = dict(params["blocks"]["ffn"])
    stack = lambda f: np.stack([f(l) for l in range(L)])
    for i, name in enumerate(("receptance", "key", "value")):
        att[name] = stack(lambda l: deq("rkv", l)[:, i * C:(i + 1) * C])
    att["output"], ffn["key"], ffn["value"] = (stack(lambda l, n=n: deq(n, l))
                                               for n in ("out", "fk", "fv"))
    for gi, n in enumerate("vwag"):
        d = att[f"{n}1"].shape[-1]
        att[f"{n}1"] = stack(lambda l: deq("li", l)[:, gi * 128:gi * 128 + d])
        att[f"{n}2"] = mega["lo"][:, gi * 128:gi * 128 + att[f"{n}2"].shape[-2]].float().numpy()
    jparams = jax.tree.map(jnp.asarray, dict(params, blocks=dict(params["blocks"], att=att,
                                                                  ffn=ffn)))
    rng = np.random.default_rng(9)
    st = _state(rng)
    jst = jax.tree.map(jnp.asarray, st)
    tst = tdm.pack_state(bridge.params_from_numpy(st), torch.float32)
    for i in range(2):
        x = rng.standard_normal((1, C)).astype(np.float32)
        h_j, jst = rwkv7.decode_step(jparams, jcfg, jnp.asarray(x), jst)
        h_t, tst = tdm.decode_step_mega(mega, tcfg, torch.from_numpy(x), tst)
        assert _rel(h_t.numpy(), h_j) <= 1e-4, (i, _rel(h_t.numpy(), h_j))
    for leaf in ("att_x", "ffn_x", "wkv"):
        assert _rel(tst[leaf].numpy(), jst[leaf]) <= 1e-4, leaf


def test_wrapper_refuses_what_the_kernel_does_not_take(weights, monkeypatch, tmp_path):
    """No fallback: a tensor neither on the CPU nor on a CUDA device is
    refused; the kernel path refuses an f32 lhs (an f32 config) and, with no
    CUDA compiler, raises at the build; nothing is counted."""
    jcfg, tcfg, params, jmega, mega = weights
    tst = tdm.pack_state(bridge.params_from_numpy(_state(np.random.default_rng(2))),
                         torch.bfloat16)
    with pytest.raises(ValueError, match="no implementation"):
        tdm.decode_step_mega(mega, tcfg, torch.empty(1, C, device="meta"), tst)
    with pytest.raises(ValueError, match="bf16 lhs only"):
        tdm._launch(mega, tcfg, torch.zeros(1, C), tst)
    bf_cfg = trwkv7.RWKV7Config(vocab_size=32, hidden_size=C, num_layers=L, head_size=64,
                                gate_lora=64, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="x is"):
        tdm._launch(mega, bf_cfg, torch.zeros(2, C), tst)
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(_build, "library_path", lambda: tmp_path / "absent.so")
    _build.library.cache_clear()
    tdm.reset_launches()
    try:
        with pytest.raises(RuntimeError, match="nvcc not found"):
            tdm._launch(mega, bf_cfg, torch.zeros(1, C), tst)
    finally:
        _build.library.cache_clear()
    assert tdm.launches == 0 and not any(tdm.kernel_launches.values())


def test_cosy_prefill_matches_jax():
    """The Cosy LM's prompt prefill (embedding layout, backbone, state) at
    hidden 128 x 2, f32, a left-padded [SOS][text][TASK][speech] prompt:
    h_last and the state within 1e-4; the decode embedding and the EOS
    state reset as the JAX package's."""
    jcfg = jcosy.default_config(hidden_size=C, num_layers=L, dtype=jnp.float32, wkv_chunk=16,
                                remat=False)
    tcfg = tcosy.default_config(hidden_size=C, num_layers=L, dtype=torch.float32)
    params = bridge.params_to_numpy(tcosy.init_params(torch.Generator().manual_seed(4), tcfg))
    tp = bridge.params_from_numpy(params)
    rng = np.random.default_rng(5)
    T = 16
    modality = np.array([[0] * 3 + [2] + [1] * 6 + [2] + [3] * 5])
    tokens = np.where(modality == 1, rng.integers(0, 65536, (1, T)),
                      np.where(modality == 3, rng.integers(0, 6562, (1, T)), 0))
    tokens[0, 3], tokens[0, 10] = 0, 1  # SOS, TASK
    mask = (modality > 0).astype(np.int32)
    h_j, st_j = jax.jit(jcosy.prefill, static_argnums=1)(
        params, jcfg, jnp.asarray(tokens), jnp.asarray(modality), jnp.asarray(mask))
    h_t, st_t = tcosy.prefill(tp, tcfg, torch.from_numpy(tokens), torch.from_numpy(modality),
                              torch.from_numpy(mask))
    assert _rel(h_t.numpy(), h_j) <= 1e-4
    for leaf in ("att_x", "wkv", "ffn_x"):
        assert _rel(st_t[leaf].numpy(), st_j[leaf]) <= 1e-4, leaf
    ids = np.array([0, 6561, 17])
    np.testing.assert_array_equal(tcosy.decode_embed(tp, tcfg, torch.from_numpy(ids)).numpy(),
                                  np.asarray(jcosy.decode_embed(params, jcfg, jnp.asarray(ids))))
    reset = tcosy.reset_shift_states(st_t)
    assert not reset["att_x"].any() and not reset["ffn_x"].any() and reset["wkv"] is st_t["wkv"]


def _b1_source():
    """csrc/decode_b1.cu: its integer constants (those that evaluate, in
    order) and each product's tile bytes."""
    import re
    from pathlib import Path

    src = (Path(tdm.__file__).resolve().parents[1] / "csrc" / "decode_b1.cu").read_text()
    env = {}
    for name, expr in re.findall(r"constexpr int (\w+) = ([^;,]+);", src):
        try:
            env[name] = eval(expr, {}, dict(env))
        except (NameError, SyntaxError):
            pass
    default = int(re.search(r"struct Prod \{\s*static constexpr int lhs = LHS_BF16, TB = (\d+);",
                            src).group(1))
    special = {p: int(tb) for p, tb in re.findall(
        r"struct Prod<P_(\w+)> \{ static constexpr int lhs = \w+, TB = (\d+); \}", src)}
    tb = {name: special.get(name.upper(), default) for name in tdm.PRODUCTS}
    return env, tb


@pytest.mark.parametrize("C", [1024, 2048])
def test_b1_launch_plan_fits_the_card(C):
    """The B=1 step's launch plan mirrors csrc/decode_b1.cu: each product cut
    into tiles of its tile bytes and K pieces of whole 8 KB boxes, at most
    64 KB a CTA and 8 pieces (one cluster); the shared memory of a product
    CTA and of a glue CTA as the source computes it, within the 227 KB a
    block may use; the workspace as the kernel carves it; at C = 2048 every
    product has 256 CTAs or more."""
    c, tile_bytes = _b1_source()
    assert (tdm.BOX, tdm.PIECE_BYTES, tdm.MAX_PIECES, tdm.THREADS) == (
        c["BOX"], c["PIECE_BYTES"], c["MAX_PIECES"], c["RT"])
    plan = tdm.launch_plan(C)
    shapes = {"rkv_li": (C, 3 * C + 512), "out": (C, C), "fk": (C, 4 * C), "fv": (4 * C, C)}
    assert list(plan["products"]) == list(tdm.PRODUCTS) == list(shapes)
    for name, pr in plan["products"].items():
        K, N = shapes[name]
        tb, kp = pr["tile_bytes"], pr["k_piece"]
        assert tb == tile_bytes[name] and pr["tiles"] * tb == N, name
        assert pr["pieces"] in (1, 2, 4, 8) and kp * pr["pieces"] == K, name
        assert kp * tb % c["BOX"] == 0 and kp * tb <= c["PIECE_BYTES"], name
        assert pr["ctas"] == pr["tiles"] * pr["pieces"], name
        smem = (128 + kp * tb + 4 * kp + c["RW"] * tb * 4 + tb * 4
                + 8 * (c["MAX_BOXES"] + 1))
        assert pr["smem_bytes"] == smem <= 232448, name
        if C == 2048:
            assert pr["ctas"] >= 256, name
    glue = 128 + 4 * c["LO_BOX"] + 4 * (c["NLI"] + 2 * 4 * c["NH"] + 7 * c["NH"] + c["RW"]) + 8
    assert plan["glue_smem_bytes"] == glue <= 232448
    sizes = (4 * C, 12 * C, 4 * 512, 8 * C, 4 * C, 2 * C, 4 * C, 4 * C)
    assert plan["workspace_bytes"] == sum(-(-n // 256) * 256 for n in sizes)


def test_b1_launch_plan_refuses_what_the_kernel_cannot_cut():
    with pytest.raises(ValueError, match="multiple of 128"):
        tdm.launch_plan(1000)
    with pytest.raises(ValueError, match="does not cut"):
        tdm.launch_plan(4096)  # FFN value K = 16384: 16 pieces of 64 KB


@pytest.mark.parametrize("L", [1, 2, 24])
def test_b1_launches_a_step(L):
    """A step launches 5 L + 1 kernels: per layer r/k/v with lora-in, the
    glue, output, FFN key and FFN value; then ln_out. The counts are by
    kernel, in the order of decode_b1_step's counts."""
    n = tdm.launches_per_step(L)
    assert list(n) == list(tdm.KERNELS)
    assert n == {"ln_out": 1, "gemv": 4 * L, "glue": L} and sum(n.values()) == 5 * L + 1


def test_b1_pack_check_runs_once_and_refuses_a_malformed_pack(monkeypatch):
    """The wrapper checks a pack's tensors on its first step: a second step
    does not check again, a new pack or a replaced entry is checked, a
    malformed pack is refused (and not remembered), and a dict that is not
    a MegaPack is refused."""
    tcfg = trwkv7.RWKV7Config(vocab_size=32, hidden_size=C, num_layers=1, head_size=64,
                              gate_lora=64, dtype=torch.float32)
    params = trwkv7.init_params(torch.Generator().manual_seed(0), tcfg)
    mega = tdm.pack_mega(params, tcfg)
    calls = []
    real = tdm._check_tensors
    monkeypatch.setattr(tdm, "_check_tensors", lambda *a: (calls.append(1), real(*a)))
    dev = torch.device("cpu")
    for _ in range(3):
        tdm._check_pack(mega, 1, C, dev)
    assert len(calls) == 1
    bad = tdm.pack_mega(params, tcfg)
    bad["lo"] = bad["lo"].float()
    with pytest.raises(ValueError, match=r"mega\['lo'\]"):
        tdm._check_pack(bad, 1, C, dev)
    with pytest.raises(ValueError, match=r"mega\['lo'\]"):
        tdm._check_pack(bad, 1, C, dev)  # a refused pack is not remembered
    assert len(calls) == 3
    # replacing an entry of a checked pack makes the next step check it
    mega["fv_q"] = mega["fv_q"][:, :-64].contiguous()
    with pytest.raises(ValueError, match=r"mega\['fv_q'\]"):
        tdm._check_pack(mega, 1, C, dev)
    assert len(calls) == 4
    # a plain dict is refused before any check
    with pytest.raises(ValueError, match="MegaPack"):
        tdm._check_pack(dict(bad), 1, C, dev)
    assert len(calls) == 4
