"""The Cosy zero-shot frontend and importers, port vs JAX package, on the
CPU: the ONNX reader, the four golden fixtures (tests/goldens/{s3_onnx,
campplus_onnx,flow,hift}.npz) replayed through the port's importers at the
JAX golden tests' tolerances, the S3 tokenizer's log-mel and encoder
(tokens equal), the kaldi fbank, CAM++'s segment pooling and embedding,
the flow prompt's log-mel, and the torch-layout importers against the JAX
importers followed by the bridge. Same weights through the bridge; inputs
from a numpy seed."""
import dataclasses
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import golden_configs as gc
from rwkvtts_tpu.codecs import campplus as jcp
from rwkvtts_tpu.codecs import cosy_import as jcosy_import
from rwkvtts_tpu.codecs import dsp as jdsp
from rwkvtts_tpu.codecs import s3_tokenizer as js3
from rwkvtts_tpu.utils import onnx_import as jonnx
from rwkvtts_torch import bridge
from rwkvtts_torch.codecs import campplus as cp
from rwkvtts_torch.codecs import cosy_import, dsp, flow, hift
from rwkvtts_torch.codecs import s3_tokenizer as s3
from rwkvtts_torch.utils import fixtures, onnx_import

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

S3_SMALL = dict(n_mels=16, d_model=32, layers=2, heads=2, ffn_dim=64, fsq_dim=8)
CAM_SMALL = dict(embedding_size=24, m_channels=4, init_channels=16, growth_rate=4, bn_size=2,
                 block_layers=(2, 2), block_dilations=(1, 2), seg_len=8)


def _port_cfg(cls, jcfg):
    """The port's config of class `cls` with the JAX config's values, field
    for field (nested configs too); a field the port lacks is left out
    (the JAX package's SFM and training extras)."""
    kw = {}
    for f in dataclasses.fields(cls):
        if hasattr(jcfg, f.name):
            v = getattr(jcfg, f.name)
            kw[f.name] = _port_cfg(type(f.default), v) if dataclasses.is_dataclass(v) else v
    return cls(**kw)


def _numpy_params(shapes, seed):
    """A JAX parameter tree of the given shapes from a numpy seed: gains and
    batch-norm variances near 1, vectors small, weights at 1/sqrt(fan-in)."""
    rng = np.random.default_rng(seed)

    def leaf(path, sd):
        name = path[-1].key if hasattr(path[-1], "key") else ""
        x = rng.standard_normal(sd.shape)
        if name in ("g", "var"):
            x = 1.0 + 0.1 * np.abs(x)
        elif sd.ndim == 1:
            x = 0.1 * x
        else:
            x = x / np.sqrt(max(1, int(np.prod(sd.shape[:-1]))))
        return x.astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


def _leaves(tree, path=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{path}/{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{path}/{i}")
    else:
        yield path, tree


def _onnx_file(tmp_path, name):
    g = np.load(os.path.join(gc.GOLDEN_DIR, name))
    path = tmp_path / name.replace(".npz", ".onnx")
    path.write_bytes(g["onnx"].tobytes())
    return str(path), g


# ---------------------------------------------------------------------------
# The ONNX reader and the import rule
# ---------------------------------------------------------------------------


def test_onnx_round_trip_and_jax_bytes(tmp_path):
    """write -> load gives the arrays back (dtype, shape, values), and the
    bytes are the JAX package's writer's."""
    rng = np.random.default_rng(0)
    arrays = {"a.weight": rng.standard_normal((3, 4, 2)).astype(np.float32),
              "b.idx": rng.integers(-9, 9, (5,)).astype(np.int64),
              "c.half": rng.standard_normal((2, 3)).astype(np.float16),
              "d.scalar": np.asarray(1.5, np.float32)}
    blob = onnx_import.write_onnx_initializers(arrays)
    assert blob == jonnx.write_onnx_initializers(arrays)
    path = tmp_path / "m.onnx"
    path.write_bytes(blob)
    back = onnx_import.load_onnx_initializers(str(path))
    assert sorted(back) == sorted(arrays)
    for k, v in arrays.items():
        assert back[k].dtype == v.dtype
        np.testing.assert_array_equal(back[k].reshape(v.shape), v)


def test_port_and_chip_smoke_import_no_jax():
    """No module of the port, and not chip_smoke.py, imports jax or the JAX
    package (an import statement, at any indentation)."""
    pat = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|rwkvtts_tpu)\b", re.M)
    files = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, names in os.walk(os.path.join(REPO, "rwkvtts_torch")):
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    bad = [f for f in files if pat.search(open(f).read())]
    assert len(files) > 40 and not bad, bad


# ---------------------------------------------------------------------------
# The four goldens through the port's importers
# ---------------------------------------------------------------------------


def test_golden_s3_onnx(tmp_path):
    path, g = _onnx_file(tmp_path, "s3_onnx.npz")
    cfg = s3.S3TokenizerConfig(**S3_SMALL)
    tokens, _ = s3.encode_mel(s3.s3_from_onnx(path, cfg), cfg, torch.from_numpy(g["mel"]))
    np.testing.assert_array_equal(tokens.numpy(), g["tokens"])


def test_golden_campplus_onnx(tmp_path):
    path, g = _onnx_file(tmp_path, "campplus_onnx.npz")
    cfg = cp.CampplusConfig(feat_dim=16, **CAM_SMALL)
    emb = cp.apply(cp.load_campplus_onnx(path, cfg), cfg, torch.from_numpy(g["feat"]))
    np.testing.assert_allclose(emb.numpy(), g["emb"], rtol=0, atol=1e-5)


def test_golden_flow():
    sd, io = fixtures.load_golden(os.path.join(gc.GOLDEN_DIR, "flow.npz"))
    cfg = _port_cfg(flow.FlowConfig, gc.flow_config())
    params = cosy_import.flow_from_state_dict(sd, cfg)
    tokens = torch.from_numpy(np.concatenate([io["prompt_token"], io["token"]], 1))
    mel = flow.inference(params, cfg, tokens, torch.ones(tokens.shape),
                         torch.from_numpy(io["prompt_feat"]), io["prompt_feat"].shape[1],
                         torch.from_numpy(io["embedding"]),
                         torch.from_numpy(io["noise"]).transpose(1, 2))
    np.testing.assert_allclose(mel.numpy(), io["mel"].transpose(0, 2, 1), rtol=0, atol=5e-3)


def test_chip_smoke_golden_configs_are_the_goldens():
    """chip_smoke.py replays the goldens on the card with its own copy of
    the reduced configs (it imports nothing of the JAX package): they are
    tests/golden_configs.py's and tests/test_goldens.py's."""
    import chip_smoke

    fcfg, hcfg, s3cfg, ccfg = chip_smoke.golden_cosy_configs()
    assert fcfg == _port_cfg(flow.FlowConfig, gc.flow_config())
    assert hcfg == _port_cfg(hift.HiFTConfig, gc.hift_config())
    assert s3cfg == s3.S3TokenizerConfig(**S3_SMALL)
    assert ccfg == cp.CampplusConfig(feat_dim=16, **CAM_SMALL)


def test_golden_hift():
    sd, io = fixtures.load_golden(os.path.join(gc.GOLDEN_DIR, "hift.npz"))
    cfg = _port_cfg(hift.HiFTConfig, gc.hift_config())
    params = cosy_import.hift_from_state_dict(sd, cfg)
    mel = torch.from_numpy(io["mel"]).transpose(1, 2)
    f0 = hift.f0_predict(params["f0_predictor"], mel)
    np.testing.assert_allclose(f0.numpy(), io["f0"], rtol=0, atol=1e-4)
    wav = hift.decode(params, cfg, mel, torch.from_numpy(io["source"]))
    np.testing.assert_allclose(wav.numpy(), io["wav"], rtol=0, atol=2e-3)


# ---------------------------------------------------------------------------
# The torch-layout importers = the JAX importers + the bridge
# ---------------------------------------------------------------------------


def _same_tree(got, want):
    g, w = dict(_leaves(got)), dict(_leaves(want))
    assert sorted(g) == sorted(w)
    for k in g:
        np.testing.assert_array_equal(g[k].numpy(), w[k].numpy(), err_msg=k)


@pytest.mark.parametrize("which", ["s3", "campplus", "flow", "hift"])
def test_importer_is_the_jax_importer_through_the_bridge(tmp_path, which):
    """Each port importer gives, leaf for leaf and bit for bit, what the JAX
    importer gives after bridge.codec_params_from_numpy (the golden state
    dicts as input)."""
    if which in ("s3", "campplus"):
        path, _ = _onnx_file(tmp_path, f"{which}_onnx.npz")
        sd = onnx_import.load_onnx_initializers(path)
        if which == "s3":
            jcfg = js3.S3TokenizerConfig(**S3_SMALL)
            got = s3.s3_from_torch_state_dict(sd, s3.S3TokenizerConfig(**S3_SMALL))
            want = js3.s3_from_torch_state_dict(sd, jcfg)
        else:
            got = cp.campplus_from_torch(sd, cp.CampplusConfig(feat_dim=16, **CAM_SMALL))
            want = jcp.campplus_from_torch(sd, jcp.CampplusConfig(feat_dim=16, **CAM_SMALL))
    else:
        sd, _ = fixtures.load_golden(os.path.join(gc.GOLDEN_DIR, f"{which}.npz"))
        jcfg = gc.flow_config() if which == "flow" else gc.hift_config()
        if which == "flow":
            got = cosy_import.flow_from_state_dict(sd, _port_cfg(flow.FlowConfig, jcfg))
            want = jcosy_import.flow_from_state_dict(sd, jcfg)
        else:
            got = cosy_import.hift_from_state_dict(sd, _port_cfg(hift.HiFTConfig, jcfg))
            want = jcosy_import.hift_from_state_dict(sd, jcfg)
    _same_tree(got, bridge.codec_params_from_numpy(jax.tree.map(np.asarray, want)))


def test_importers_refuse_what_the_port_does_not_run():
    """A multi-level estimator is refused; an sfm_head.* in the checkpoint
    is left out unless the config asks for the SFM flow, as the JAX
    importer does (tests/test_torch_cosy_sfm.py reads it)."""
    sd, _ = fixtures.load_golden(os.path.join(gc.GOLDEN_DIR, "flow.npz"))
    cfg = _port_cfg(flow.FlowConfig, gc.flow_config())
    assert not cfg.sfm
    assert "sfm_head" not in cosy_import.flow_from_state_dict(
        {**sd, "sfm_head.conv1.weight": np.zeros(1)}, cfg)
    sd = dict(sd)
    sd["decoder.estimator.down_blocks.0.2.conv.weight"] = sd.pop(
        "decoder.estimator.down_blocks.0.2.weight")
    with pytest.raises(NotImplementedError, match="more than one level"):
        cosy_import.flow_from_state_dict(sd, cfg)


def test_s3_from_onnx_lists_names(tmp_path):
    """An export with other names raises with the initializers listed, and
    probe_onnx lists them with their shapes."""
    path, _ = _onnx_file(tmp_path, "campplus_onnx.npz")
    with pytest.raises(KeyError, match="head.conv1.weight"):
        s3.s3_from_onnx(path, s3.S3TokenizerConfig(**S3_SMALL))
    probe = dict(s3.probe_onnx(path))
    assert probe["head.conv1.weight"] == (4, 1, 3, 3)


# ---------------------------------------------------------------------------
# The S3 tokenizer, the kaldi fbank, CAM++ and the flow prompt's mel
# ---------------------------------------------------------------------------


def _wav(seed, n, sr=16000):
    rng = np.random.default_rng(seed)
    t = np.arange(n) / sr
    return (0.3 * np.sin(2 * np.pi * 220.0 * t) + 0.05 * rng.standard_normal(n)).astype(np.float32)


def test_s3_log_mel_and_tokens_match_jax():
    """log_mel within 1e-5 absolute; encode_mel's tokens equal, with and
    without a mask (masked tokens 0)."""
    jcfg = js3.S3TokenizerConfig(**S3_SMALL)
    cfg = s3.S3TokenizerConfig(**S3_SMALL)
    jp = _numpy_params(jax.eval_shape(lambda k: js3.init_params(k, jcfg), jax.random.PRNGKey(0)), 0)
    tp = bridge.codec_params_from_numpy(jp)
    wav = _wav(1, 16000)[None]
    want_mel = np.asarray(jax.jit(js3.log_mel, static_argnums=0)(jcfg, jnp.asarray(wav)))
    mel = s3.log_mel(cfg, torch.from_numpy(wav))
    assert mel.shape == want_mel.shape == (1, 100, 16)
    np.testing.assert_allclose(mel.numpy(), want_mel, rtol=0, atol=1e-5)
    mask = np.ones((1, 100), np.float32)
    mask[:, 70:] = 0
    for m in (None, mask):
        want, want_m = jax.jit(js3.encode_mel, static_argnums=1)(
            jp, jcfg, jnp.asarray(want_mel), None if m is None else jnp.asarray(m))
        got, got_m = s3.encode_mel(tp, cfg, torch.tensor(want_mel),
                                   None if m is None else torch.from_numpy(m))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        np.testing.assert_array_equal(got_m.numpy(), np.asarray(want_m))
    assert got.shape == (1, 25) and (got.numpy()[0, 18:] == 0).all()
    assert 0 <= int(got.min()) and int(got.max()) < cfg.vocab_size


def test_kaldi_fbank_matches_jax():
    """ln of a power spectrum scaled by 32768^2, compared at 1e-3 absolute
    (the logs run to ~30; f32 FFTs of two libraries)."""
    wav = _wav(2, 8000)[None]
    want = np.asarray(jax.jit(jcp.kaldi_fbank)(jnp.asarray(wav)))
    got = cp.kaldi_fbank(torch.from_numpy(wav)).numpy()
    assert got.shape == want.shape == (1, 48, 80)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-3)


@pytest.mark.parametrize("T", [16, 21, 5])
def test_seg_pool_matches_jax(T):
    """Ceil mode: the last partial segment is divided by its own count."""
    x = np.random.default_rng(T).standard_normal((2, T, 3)).astype(np.float32)
    want = np.asarray(jcp._seg_pool(jnp.asarray(x), 8))
    np.testing.assert_allclose(cp._seg_pool(torch.from_numpy(x), 8).numpy(), want,
                               rtol=0, atol=1e-6)


def test_campplus_embed_wav_matches_jax():
    """embed_wav (kaldi fbank, mean-normalised, through CAM++) within 1e-4
    relative to the embedding's largest value."""
    jcfg = jcp.CampplusConfig(feat_dim=80, **CAM_SMALL)
    cfg = cp.CampplusConfig(feat_dim=80, **CAM_SMALL)
    jp = _numpy_params(jax.eval_shape(lambda k: jcp.init_params(k, jcfg), jax.random.PRNGKey(1)), 1)
    wav = _wav(3, 8000)[None]
    want = np.asarray(jax.jit(jcp.embed_wav, static_argnums=1)(jp, jcfg, jnp.asarray(wav)))
    got = cp.embed_wav(bridge.codec_params_from_numpy(jp), cfg, torch.from_numpy(wav)).numpy()
    assert got.shape == (1, 24)
    assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max()


def test_log_mel_hifigan_matches_jax():
    wav = _wav(4, 24000, sr=24000)[None]
    want = np.asarray(jax.jit(jdsp.log_mel_hifigan)(jnp.asarray(wav)))
    got = dsp.log_mel_hifigan(torch.from_numpy(wav)).numpy()
    assert got.shape == want.shape == (1, 50, 80)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
