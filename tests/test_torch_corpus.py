"""The corpus side of training from raw audio, port vs JAX package on the
CPU: the webdataset shard writer and re-packer (byte-identical tars), the
readers (``iter_tar_samples``, ``MultipleWebDataset``, ``stream_tars``
sharded and shuffled, all through the C++ streamer, and its plain tarfile
version ``read_tars_plain``), a shard cut inside a member (each complete
sample once through the streamer and its plain version; the JAX package's
tarfile path repeats samples on its retries), the world tokenizer's C++
trie against its plain Python matcher and the JAX tokenizer, the text-keyed cache, the parquet builder's resume, the
parquet row functions, corpus_stats, jsonl_tools and the phase timer.

Every comparison is exact: bytes, ids, strings and the decoded audio
arrays. The native libraries build with g++ at first use (seconds)."""
import gzip
import io
import json
import os
import pickle
import random
import shutil
import tarfile
import wave

import numpy as np
import pytest

from rwkvtts_tpu.data import corpus_stats as jcs
from rwkvtts_tpu.data import corpus_tools as jct
from rwkvtts_tpu.data import jsonl_tools as jjt
from rwkvtts_tpu.data import webdataset as jwds
from rwkvtts_tpu.utils import profiling as jprof
from rwkvtts_tpu.utils import tokenizer as jtok
from rwkvtts_torch.data import corpus_stats, corpus_tools, jsonl_tools
from rwkvtts_torch.data import webdataset as wds
from rwkvtts_torch.utils import native, profiling
from rwkvtts_torch.utils import tokenizer as ttok

TEXTS = ("今天的天气非常好。", "The quick brown fox jumps over the lazy dog.",
         "人工智能正在改变世界。", "Please call me at ten.", "请在下午三点之前把报告发给我。",
         "We expect 125 people to attend.")


def corpus(n: int, seed: int = 0, sr: int = 16000):
    """n seeded samples: 0.1-0.4 s of noise, a text, a speaker, properties."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        wav = (0.3 * rng.standard_normal(int(rng.integers(sr // 10, 2 * sr // 5)))).astype(
            np.float32)
        out.append({"__key__": f"utt{i:04d}", "audio": wav, "text": TEXTS[i % len(TEXTS)],
                    "speaker": f"spk{i % 3}", "language": ("zh", "en")[i % 2],
                    "gender": ("female", "male")[i % 2], "pitch": float(rng.uniform(100, 260))})
    return out


@pytest.fixture(scope="module")
def shards(tmp_path_factory):
    """4 shards of 5 samples, written by the port."""
    d = tmp_path_factory.mktemp("shards")
    return corpus_tools.write_shards(corpus(20), str(d), samples_per_shard=5)


def _same_samples(got, want):
    assert [s["__key__"] for s in got] == [s["__key__"] for s in want]
    for a, b in zip(got, want):
        assert a.keys() == b.keys()
        for k in a:
            if isinstance(a[k], np.ndarray):
                assert a[k].dtype == b[k].dtype
                np.testing.assert_array_equal(a[k], b[k])
            else:
                assert a[k] == b[k], k


def _bytes(paths):
    return [open(p, "rb").read() for p in paths]


def test_write_shards_and_repack_match_jax_bytes(tmp_path):
    """write_shards and repack_tars (a .tar.gz and a .tar in, metadata
    joined by key) give the JAX package's bytes."""
    samples = corpus(7, seed=1)
    port = corpus_tools.write_shards(samples, str(tmp_path / "p"), samples_per_shard=3)
    jax_ = jct.write_shards(samples, str(tmp_path / "j"), samples_per_shard=3)
    assert [os.path.basename(p) for p in port] == [os.path.basename(p) for p in jax_]
    assert len(port) == 3 and _bytes(port) == _bytes(jax_)

    gz = str(tmp_path / "in.tar.gz")
    with open(port[0], "rb") as f, gzip.open(gz, "wb") as g:
        g.write(f.read())
    meta = {"utt0000": {"emotion": "HAPPY"}, "utt0004": {"age": "child"}}
    inputs = [gz, port[1]]
    a = corpus_tools.repack_tars(inputs, str(tmp_path / "rp"), metadata=meta)
    b = jct.repack_tars(inputs, str(tmp_path / "rj"), metadata=meta)
    assert _bytes(a) == _bytes(b)
    assert next(wds.iter_tar_samples(a[0]))["emotion"] == "HAPPY"


# each reader: (the port's, the JAX package's)
READERS = {
    "iter_tar_samples": (lambda paths: [s for p in paths for s in wds.iter_tar_samples(p)],
                         lambda paths: [s for p in paths for s in jwds.iter_tar_samples(p)]),
    "multiple_webdataset": (lambda paths: wds.MultipleWebDataset(paths, seed=3).samples,
                            lambda paths: jwds.MultipleWebDataset(paths, seed=3).samples),
    "stream_native": (lambda paths: list(wds.stream_tars(paths)),
                      lambda paths: list(jwds.stream_tars(paths, native=True))),
    "stream_tarfile": (lambda paths: list(wds.read_tars_plain(paths)),
                       lambda paths: list(jwds.stream_tars(paths, native=False))),
    "stream_shard_1_of_2": (
        lambda paths: list(wds.stream_tars(paths, shard_index=1, num_shards=2)),
        lambda paths: list(jwds.stream_tars(paths, shard_index=1, num_shards=2, native=True))),
    "stream_shuffled": (
        lambda paths: list(wds.stream_tars(paths, shuffle_buffer=6, seed=5)),
        lambda paths: list(jwds.stream_tars(paths, native=False, shuffle_buffer=6, seed=5))),
    "stream_shuffled_native": (
        lambda paths: list(wds.stream_tars(paths, shuffle_buffer=4, seed=2)),
        lambda paths: list(jwds.stream_tars(paths, native=True, shuffle_buffer=4, seed=2))),
}


@pytest.mark.parametrize("reader", sorted(READERS))
def test_readers_match_jax(shards, reader):
    """Each reader gives the JAX package's samples in its order: keys,
    texts, json fields and bit-identical audio (the port's readers all
    through its C++ streamer, "stream_tarfile" its plain tarfile version;
    the JAX package's through its streamer or tarfile as named)."""
    port, jax_ = READERS[reader]
    got, want = port(shards), jax_(shards)
    assert len(got) == {"stream_shard_1_of_2": 10}.get(reader, 20)
    _same_samples(got, want)


def test_native_and_tarfile_streams_agree(shards, tmp_path):
    """The C++ streamer and its plain tarfile version give the same
    samples, the streamer delivers every regular member in archive order,
    and a compressed shard raises where the streamer would read it."""
    _same_samples(list(wds.stream_tars(shards)), list(wds.read_tars_plain(shards)))
    with tarfile.open(shards[0]) as tf:
        members = [(m.name, tf.extractfile(m).read()) for m in tf if m.isfile()]
    with native.NativeTarStream(shards[:1]) as ts:
        got = [(n, d) for _, n, d in ts]
    assert got == members
    gz = str(tmp_path / "s.tar.gz")
    with open(shards[0], "rb") as f, gzip.open(gz, "wb") as g:
        g.write(f.read())
    assert wds.check_tar(gz)
    for read in (lambda: list(wds.iter_tar_samples(gz)), lambda: list(wds.stream_tars([gz])),
                 lambda: wds.MultipleWebDataset([shards[1], gz])):
        with pytest.raises(ValueError, match="compressed tar"):
            read()


def _cut(src: str, dst: str, member: int, frac: float = 0.5) -> None:
    """A copy of `src` cut `frac` of the way into the data of its member
    number `member` (0-based, regular members)."""
    with tarfile.open(src) as tf:
        m = [m for m in tf if m.isfile()][member]
    with open(src, "rb") as f:
        data = f.read()
    with open(dst, "wb") as f:
        f.write(data[: m.offset_data + max(1, int(m.size * frac))])


@pytest.mark.parametrize("member", [1, 2, 5])
def test_cut_shard_gives_each_complete_sample_once(shards, tmp_path, member):
    """A shard cut inside a member (the second member: sample 0's json; the
    third: sample 1's wav; the sixth: sample 2's json), followed by a whole
    shard: both of the port's paths yield each complete sample once and
    drop the sample the cut went through, then go on with the next shard
    (the plain one after its two retries, which skip what was delivered).
    The JAX package's tarfile path repeats the samples before the cut on
    each of its two retries; its native path keeps the cut sample without
    its later members where one of them came before the cut."""
    cut = str(tmp_path / "cut.tar")
    _cut(shards[0], cut, member)
    paths = [cut, shards[1]]
    complete = member // 2  # samples 0 .. complete - 1 are whole
    want_keys = [f"utt{i:04d}" for i in range(complete)] + [f"utt{i:04d}" for i in range(5, 10)]
    port_native = list(wds.stream_tars(paths))
    port_tarfile = list(wds.read_tars_plain(paths))
    assert [s["__key__"] for s in port_native] == want_keys
    _same_samples(port_tarfile, port_native)
    assert [s["__key__"] for s in wds.iter_tar_samples(cut)] == want_keys[:complete]

    jax_tarfile = [s["__key__"] for s in jwds.iter_tar_samples(cut)]
    first = [f"utt{i:04d}" for i in range(complete)]
    assert jax_tarfile == first * 3  # fault of the reference: three reads
    jax_native = [s["__key__"] for s in jwds.stream_tars(paths, native=True)]
    partial = [f"utt{complete:04d}"] if member % 2 else []  # its wav, without its json
    assert jax_native == [*first, *partial, *want_keys[complete:]]


def test_cut_after_a_whole_member_and_unreadable_shard(shards, tmp_path):
    """A shard that ends after a whole member without its end-of-archive
    blocks, cut inside the next header, drops the sample in progress on
    both paths; a shard that is not a tar at all is cut before its first
    sample. check_tar refuses both."""
    with tarfile.open(shards[0]) as tf:
        m = [m for m in tf if m.isfile()][3]  # sample 1's json
    data = open(shards[0], "rb").read()
    cut = str(tmp_path / "hdr.tar")
    open(cut, "wb").write(data[: m.offset_data + ((m.size + 511) // 512) * 512 + 100])
    bad = str(tmp_path / "bad.tar")
    open(bad, "wb").write(b"not a tar" * 100)
    paths = [cut, bad, shards[2]]
    got = list(wds.stream_tars(paths))
    assert [s["__key__"] for s in got][:1] == ["utt0000"] and len(got) == 6
    _same_samples(list(wds.read_tars_plain(paths)), got)
    assert not wds.check_tar(bad) and wds.check_tar(shards[0])
    assert len(wds.MultipleWebDataset([bad, shards[2]], seed=1)) == 5


@pytest.fixture(scope="module")
def toks():
    return ttok.WorldTokenizer(added_tokens=[f"SPCT_{i}" for i in range(64)]), \
        jtok.get_world_tokenizer(n_spct=64)


def test_trie_matches_python_and_jax_on_the_vocabulary(toks):
    """Each vocabulary token's bytes, all of them joined, and the SPCT
    tokens: the trie's ids = the Python matcher's = the JAX tokenizer's; a
    pickled tokenizer rebuilds its trie."""
    tok, jt = toks
    for tid, bs in sorted(tok.id_to_bytes.items())[1:]:
        assert tok._encode_bytes(bs) == tok._encode_bytes_plain(bs) == jt._encode_bytes(bs) \
            == [tid]
    blob = b"".join(bs for _, bs in sorted(tok.id_to_bytes.items())[1:])
    assert tok._encode_bytes(blob) == tok._encode_bytes_plain(blob) == jt._encode_bytes(blob)
    text = "SPCT_3说SPCT_63 SPCT_1hello SPCT_0"
    assert tok.encode(text) == tok.encode_plain(text) == jt.encode(text)
    assert tok.encode(text)[0] == 65536 + 3
    assert pickle.loads(pickle.dumps(tok)).encode(text) == tok.encode(text)  # trie rebuilt


def test_trie_matches_on_random_utf8(toks):
    """300 seeded random strings over ASCII, CJK, Latin-1, emoji and
    SPCT tokens."""
    tok, jt = toks
    rng = random.Random(0)
    pools = [(32, 127), (0x4E00, 0x9FFF), (0xA0, 0x17F), (0x1F300, 0x1F64F), (0x400, 0x4FF)]
    for _ in range(300):
        parts = []
        for _ in range(rng.randint(1, 12)):
            if rng.random() < 0.1:
                parts.append(f"SPCT_{rng.randrange(64)}")
            else:
                lo, hi = rng.choice(pools)
                parts.append("".join(chr(rng.randint(lo, hi)) for _ in range(rng.randint(1, 8))))
        s = "".join(parts)
        assert tok.encode(s) == tok.encode_plain(s) == jt.encode(s)
        assert tok.decode(tok.encode(s)) == s


def test_trie_errors_raise(toks):
    """An unencodable byte raises ValueError at its position and a buffer
    too small raises RuntimeError, as in the JAX tokenizer's wrapper; a
    vocabulary without the byte 0xff shows the first."""
    tok, _ = toks
    small = native.NativeTrieEncoder([(1, b"a"), (2, b"ab"), (3, b"b")])
    assert small.encode_bytes(b"abab") == [2, 2] and small.encode_bytes(b"aab") == [1, 2]
    with pytest.raises(ValueError, match="unencodable byte 0xff at position 2"):
        small.encode_bytes(b"ab\xffa")
    with pytest.raises(RuntimeError, match="overflow"):
        small.encode_bytes(b"aaaa", cap=3)
    assert small.encode_bytes(b"aaa", cap=3) == [1, 1, 1]
    big = "说" * 40
    assert tok._trie.encode_bytes(big.encode(), cap=40) == tok.encode_plain(big)
    with pytest.raises(RuntimeError, match="overflow"):
        tok._trie.encode_bytes(big.encode(), cap=39)


def test_native_build_failure_raises(tmp_path, monkeypatch):
    """A library that does not build raises (no Python fallback), and the
    build lands under the hash of its source."""
    src = tmp_path / "world_tokenizer.cpp"
    src.write_text("this is not C++")
    monkeypatch.setattr(native, "CSRC", tmp_path)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        native.build("world_tokenizer")
    assert not list((tmp_path / "build").glob("*.so"))
    monkeypatch.setattr(native.shutil, "which", lambda _: None)
    with pytest.raises(RuntimeError, match="g\\+\\+ not found"):
        native.build("world_tokenizer")
    lib = native.library_path("world_tokenizer")
    assert lib.name.startswith("libworld_tokenizer_") and lib.parent == tmp_path / "build"


def test_text_keyed_cache_matches_jax(shards, tmp_path):
    """build_from_tars, get and len give the JAX package's rows."""
    with corpus_tools.TextKeyedCache(str(tmp_path / "p.db")) as a, \
            jct.TextKeyedCache(str(tmp_path / "j.db")) as b:
        assert a.build_from_tars(shards) == b.build_from_tars(shards) == 20
        assert len(a) == len(b) == len(TEXTS)
        for t in TEXTS + ("missing",):
            assert a.get(t) == b.get(t)
        assert corpus_tools.TextKeyedCache.key("x") == jct.TextKeyedCache.key("x")


def _wav_bytes(n, f, sr=16000):
    t = np.arange(n, dtype=np.float32) / sr
    pcm = (0.5 * np.sin(2 * np.pi * f * t) * 32767).astype(np.int16)
    buf = io.BytesIO()
    with wave.open(buf, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(sr)
        w.writeframes(pcm.tobytes())
    return buf.getvalue()


@pytest.fixture
def parquet_file(tmp_path):
    import pyarrow as pa
    import pyarrow.parquet as pq

    n = 7
    rows = {"audio": [{"bytes": _wav_bytes(800 + 100 * i, 200.0 + 50 * i), "path": None}
                      for i in range(n)],
            "transcription": [f"utterance {i}" if i != 3 else "" for i in range(n)],
            "language": ["zh", "en"] * 3 + ["zh"],
            "speaker": ["a", "a", "b", "b", "b", "a", "a"]}
    path = tmp_path / "corpus.parquet"
    pq.write_table(pa.table(rows), path, row_group_size=3)
    return str(path)


def _fake_s3(wav):
    return (np.abs(wav[::160]) * 1000).astype(np.int64) % 4096


def _fake_embed(wav):
    return np.array([wav.mean(), wav.std(), np.abs(wav).max()], np.float32)


def test_parquet_rows_builder_resume_and_row_fns_match_jax(parquet_file, tmp_path):
    """iter_parquet_rows (skip included), build_jsonl_from_parquet with
    cosy_token_row_fn resumed after a cut output, and xvector_row_fn with
    its per-speaker cap give the JAX package's rows and files."""
    for skip in (0, 4):
        got = list(corpus_tools.iter_parquet_rows(parquet_file, skip=skip, batch_size=2))
        want = list(jct.iter_parquet_rows(parquet_file, skip=skip, batch_size=2))
        _same_samples([{"__key__": i, **r} for i, r in enumerate(got)],
                      [{"__key__": i, **r} for i, r in enumerate(want)])
    outs = {}
    for name, mod in (("port", corpus_tools), ("jax", jct)):
        d = str(tmp_path / name)
        assert mod.build_jsonl_from_parquet([parquet_file], d, mod.cosy_token_row_fn(_fake_s3)) == 6
        path = os.path.join(d, "corpus_tokens.jsonl")
        lines = open(path).read().splitlines()
        open(path, "w").write("\n".join(lines[:2]) + "\n")  # a run cut after 2 rows
        # resumes at row 2: input rows 2-6, of which row 3 has no text
        assert mod.build_jsonl_from_parquet([parquet_file], d, mod.cosy_token_row_fn(_fake_s3)) == 4
        outs[name] = open(path).read()
        xd = str(tmp_path / f"x{name}")
        mod.build_jsonl_from_parquet([parquet_file], xd, mod.xvector_row_fn(_fake_embed,
                                                                            per_speaker_cap=1))
        outs["x" + name] = open(os.path.join(xd, "corpus_tokens.jsonl")).read()
    assert outs["port"] == outs["jax"] and len(outs["port"].splitlines()) == 6
    assert outs["xport"] == outs["xjax"] and len(outs["xport"].splitlines()) == 4


def test_corpus_stats_and_jsonl_tools_match_jax(tmp_path):
    """row_lengths / summarize, filter_fields / join_on and both mains give
    the JAX package's numbers and files."""
    rng = np.random.default_rng(4)
    rows = [{"text": "x" * int(rng.integers(0, 40)), "utt": f"u{i}",
             "semantic_tokens": rng.integers(0, 8192, int(rng.integers(1, 3000))).tolist(),
             "audio_tokens": [[1] * int(rng.integers(1, 50))] * 2} for i in range(40)]
    side = [{"utt": f"u{i}", "gender": "male", "age": "adult", "text": "no"} for i in range(0, 40, 3)]
    for field in ("semantic_tokens", "audio_tokens"):
        a, b = corpus_stats.row_lengths(rows, field), jcs.row_lengths(rows, field)
        np.testing.assert_array_equal(a, b)
        assert corpus_stats.summarize(a) == jcs.summarize(b)
    assert corpus_stats.summarize(np.zeros(0)) == jcs.summarize(np.zeros(0))
    assert jsonl_tools.filter_fields(rows, ["text", "utt"], ["utt"]) == jjt.filter_fields(
        rows, ["text", "utt"], ["utt"])
    assert jsonl_tools.join_on(rows, side, "utt", ["gender"]) == jjt.join_on(rows, side, "utt",
                                                                            ["gender"])
    src, sp = tmp_path / "rows.jsonl", tmp_path / "side.jsonl"
    src.write_text("".join(json.dumps(r) + "\n" for r in rows))
    sp.write_text("".join(json.dumps(r) + "\n" for r in side))
    for mod, tag in ((jsonl_tools, "p"), (jjt, "j")):
        mod.main(["filter", str(src), str(tmp_path / f"f{tag}"), "--keep", "text", "utt"])
        mod.main(["join", str(src), str(sp), str(tmp_path / f"o{tag}"), "--on", "utt"])
    for n in ("f", "o"):
        assert (tmp_path / f"{n}p").read_bytes() == (tmp_path / f"{n}j").read_bytes()


def test_corpus_stats_and_tools_mains(shards, tmp_path, capsys):
    """corpus_stats.main and the corpus_tools CLI (repack with a metadata
    jsonl, cache-build, cache-get) print what the JAX package's print."""
    rows = tmp_path / "r.jsonl"
    rows.write_text("".join(json.dumps({"text": "ab", "semantic_tokens": [1] * n}) + "\n"
                            for n in (5, 300, 70)))
    meta = tmp_path / "meta.jsonl"
    meta.write_text(json.dumps({"__key__": "utt0001", "emotion": "SAD"}) + "\n")
    printed = {}
    for name, cs, ct in (("port", corpus_stats, corpus_tools), ("jax", jcs, jct)):
        cs.main([str(rows), "--max-rows", "2"])
        ct.main(["repack", shards[0], "--out-dir", str(tmp_path / f"rp{name}"),
                 "--metadata-jsonl", str(meta)])
        ct.main(["cache-build", *shards, "--db", str(tmp_path / f"{name}.db")])
        ct.main(["cache-get", "--db", str(tmp_path / f"{name}.db"), "--text", TEXTS[1]])
        printed[name] = capsys.readouterr().out.replace(name, "X")
    assert printed["port"] == printed["jax"]
    assert (tmp_path / "rpport" / "shard-000000.tar").read_bytes() == (
        tmp_path / "rpjax" / "shard-000000.tar").read_bytes()


def test_phase_timer_and_measure(monkeypatch):
    """PhaseTimer's sums, rates and summary on one recorded clock equal the
    JAX package's; measure times a first call and the steady state."""
    ticks = iter(np.arange(0.0, 100.0, 0.25))
    clock = lambda: float(next(ticks))
    timers = []
    for mod in (profiling, jprof):
        monkeypatch.setattr(mod.time, "perf_counter", clock)
        t = mod.PhaseTimer()
        with t.phase("decode", tokens=256):
            pass
        with t.phase("decode", tokens=256, audio_seconds=2.0):
            pass
        with t.phase("flow", audio_seconds=4.0):
            pass
        timers.append(t)
    monkeypatch.undo()
    assert timers[0].summary() == timers[1].summary()
    assert timers[0].report() == timers[1].report()
    assert timers[0].stats["decode"].tokens_per_s == 1024.0
    calls = []
    m = profiling.measure(lambda x: calls.append(x) or x, 1, iters=4)
    assert calls == [1] * 5 and set(m) == {"first_s", "steady_s"}
    profiling.sync({"a": [np.zeros(1)], "b": __import__("torch").zeros(2)})
